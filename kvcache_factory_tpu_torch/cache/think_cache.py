"""ThinK's channel-packed cache (port of ``kvcache_factory_tpu/cache/think_cache.py``).

Keys older than the last ``recent_size`` prefill rows keep only their
``Dk = D - int(D * pruning_ratio)`` most salient channels
(``policies/think.py::think_channel_keep_idx``), the reference's real key
memory saving (llama_model_think.py:175-181):

* ``kp [L, B, H, C, Dk]`` — the kept channels of every prefill row; rows
  at or past ``boundary`` are shadowed by ``kd`` and never read;
* ``channels [L, B, H, Dk]`` — kept channel ids per (layer, head), ascending;
* ``kd [L, B, H, Cr, D]`` — whole keys of rows ``>= boundary``: slot ``j``
  holds row ``boundary + j`` (the recent prefill rows and every decode
  append); ``Cr = min(C, recent_size + decode headroom)``;
* ``v [L, B, H, C, D]`` — values are never pruned;
* ``boundary [L, B, H]`` — ``max(lengths - recent_size, 0)`` at prefill,
  fixed thereafter.

Decode takes the pruned logits ``q[channels] . kp`` on every row and the
exact ``q . kd`` on rows in ``[boundary, boundary + Cr)`` (gathered, where
the JAX package contracts with a one-hot, a TPU workaround).  Key bytes a
layer: ``C * Dk + Cr * D`` against ``C * D`` dense.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ThinKCache(NamedTuple):
    kp: torch.Tensor         # [L, B, H, C, Dk] kept-channel keys
    channels: torch.Tensor   # [L, B, H, Dk] int32 kept channel ids (ascending)
    kd: torch.Tensor         # [L, B, H, Cr, D] whole keys, slot j = row boundary + j
    v: torch.Tensor          # [L, B, H, C, D]
    boundary: torch.Tensor   # [L, B, H] int32 pruned / whole split (fixed)
    lengths: torch.Tensor    # [L, B, H] int32 valid rows
    positions: torch.Tensor  # [B] int32 uncompressed token count

    @property
    def capacity(self) -> int:
        return self.v.shape[3]

    @property
    def dense_capacity(self) -> int:
        return self.kd.shape[3]

    @property
    def kept_dim(self) -> int:
        return self.kp.shape[4]


def init_think_cache(num_layers: int, batch: int, num_heads: int, capacity: int,
                     head_dim: int, kept_dim: int, dense_capacity: int,
                     dtype=torch.bfloat16, device="cuda") -> ThinKCache:
    lead = (num_layers, batch, num_heads)
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    return ThinKCache(kp=z(*lead, capacity, kept_dim),
                      channels=z(*lead, kept_dim, dt=torch.int32),
                      kd=z(*lead, dense_capacity, head_dim),
                      v=z(*lead, capacity, head_dim),
                      boundary=z(*lead, dt=torch.int32), lengths=z(*lead, dt=torch.int32),
                      positions=z(batch, dt=torch.int32))


def store_think_layer(cache: ThinKCache, layer: int, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, channels: torch.Tensor, recent_size: int) -> None:
    """Write one layer's unpruned packed K/V ``[B, H, n, D]``, its lengths
    ``[B, H]`` and kept channels ``[B, H, Dk]``, in place: the values of
    JAX's ``build_think_cache`` on the zero-padded stack."""
    B, H, n, D = k.shape
    C, Cr, Dk = cache.capacity, cache.dense_capacity, cache.kept_dim
    padded = k.new_zeros((B, H, C, D))
    padded[:, :, :n] = k
    boundary = (lengths - recent_size).clamp(min=0).to(torch.int32)
    cache.kp[layer] = padded.gather(3, channels.long()[:, :, None, :].expand(B, H, C, Dk))
    rows = (boundary.long()[..., None] + torch.arange(Cr, device=k.device)).clamp(0, C - 1)
    cache.kd[layer] = padded.gather(2, rows[..., None].expand(B, H, Cr, D))
    cache.v[layer, :, :, :n] = v
    cache.channels[layer] = channels
    cache.boundary[layer] = boundary
    cache.lengths[layer] = lengths


def build_think_cache(k_all: torch.Tensor, v_all: torch.Tensor, channels: torch.Tensor,
                      lengths: torch.Tensor, positions: torch.Tensor, recent_size: int,
                      dense_capacity: int) -> ThinKCache:
    """The whole stack at once (JAX ``build_think_cache``): unpruned packed
    keys and values ``[L, B, H, C, D]``, channels ``[L, B, H, Dk]``."""
    L, B, H, C, D = k_all.shape
    cache = init_think_cache(L, B, H, C, D, channels.shape[-1], dense_capacity, k_all.dtype,
                             k_all.device)
    for li in range(L):
        store_think_layer(cache, li, k_all[li], v_all[li], lengths[li], channels[li],
                          recent_size)
    cache.positions.copy_(positions)
    return cache


def think_cache_from_jax(kp, channels, kd, v, boundary, lengths, positions, device="cpu",
                         dtype=torch.float32) -> ThinKCache:
    """The port's cache holding a JAX ``ThinKCache``'s arrays (as numpy)."""
    f = lambda a: torch.from_numpy(np.asarray(a).astype(np.float32)).to(device, dtype)  # noqa: E731
    i = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)  # noqa: E731
    return ThinKCache(f(kp), i(channels), f(kd), f(v), i(boundary), i(lengths), i(positions))
