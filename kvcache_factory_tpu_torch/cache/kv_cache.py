"""Fixed-capacity padded KV cache (port of ``kvcache_factory_tpu/cache/kv_cache.py``).

One stacked buffer ``[L, B, H, C, D]`` plus per-head valid lengths
``[L, B, H]``.  Ragged per-head budgets are unequal lengths over the same
padded buffer.  ``positions`` tracks the *uncompressed* token count, so RoPE
keeps advancing past the compressed length (the reference's ``_seen_tokens``
sync, llama_model.py:172, 2208).

``EvictingKVCache`` adds decode-stage eviction: each step adds its
attention probabilities to a per-slot score, and a full head's new token
overwrites its lowest-scored slot outside the protected recent window.

Unlike the JAX caches, the port's decode step updates these tensors in
place (``models/llama.py::decode_step``), through :func:`write_rows`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class KVCache(NamedTuple):
    k: torch.Tensor          # [L, B, H, C, D]
    v: torch.Tensor          # [L, B, H, C, D]
    lengths: torch.Tensor    # [L, B, H] int32 — valid entries per head
    positions: torch.Tensor  # [B] int32 — uncompressed tokens seen (RoPE clock)

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]


def init_cache(num_layers: int, batch: int, num_heads: int, capacity: int,
               head_dim: int, dtype=torch.bfloat16, device="cuda") -> KVCache:
    shape = (num_layers, batch, num_heads, capacity, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((num_layers, batch, num_heads), dtype=torch.int32,
                            device=device),
        positions=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def append_layer(
    k_cache: torch.Tensor,  # [B, H, C, D] one layer's key buffer
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B, H]
    k_new: torch.Tensor,    # [B, H, 1, D] one decode token
    v_new: torch.Tensor,
):
    """Append one token per head at each head's current length; returns new
    tensors (a head already at capacity drops the token, as the JAX
    one-hot write does)."""
    C = k_cache.shape[2]
    slot = torch.arange(C, device=k_cache.device)
    onehot = (slot == lengths[:, :, None])[..., None]  # [B, H, C, 1]
    k_out = torch.where(onehot, k_new, k_cache)
    v_out = torch.where(onehot, v_new, v_cache)
    return k_out, v_out, torch.clamp(lengths + 1, max=C)


def valid_mask(lengths: torch.Tensor, capacity: int) -> torch.Tensor:
    """[..., H] lengths -> [..., H, C] boolean validity mask."""
    return torch.arange(capacity, device=lengths.device) < lengths[..., None]


def write_rows(buf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
               new: torch.Tensor) -> None:
    """In place: ``buf[b, h, slot[b, h]] = new[b, h]`` where ``keep[b, h]``,
    for one layer's ``buf [B, H, C, ...]``; a head whose ``keep`` is False
    keeps its row (the JAX scatter's ``mode="drop"``)."""
    B, H = slot.shape
    tail = buf.shape[3:]
    ones = (1,) * len(tail)
    idx = slot.long().clamp(0, buf.shape[2] - 1).view(B, H, 1, *ones).expand(B, H, 1, *tail)
    rows = torch.where(keep.view(B, H, 1, *ones), new.reshape(B, H, 1, *tail).to(buf.dtype),
                       buf.gather(2, idx))
    buf.scatter_(2, idx, rows)


class EvictingKVCache(NamedTuple):
    """``KVCache`` plus each slot's accumulated attention mass and the
    position its entry was written at (JAX ``kv_cache.py:85-114``)."""

    k: torch.Tensor          # [L, B, H, C, D]
    v: torch.Tensor          # [L, B, H, C, D]
    scores: torch.Tensor     # [L, B, H, C] fp32 accumulated attention
    stamps: torch.Tensor     # [L, B, H, C] int32 insertion position
    lengths: torch.Tensor    # [L, B, H] int32
    positions: torch.Tensor  # [B] int32

    @property
    def capacity(self) -> int:
        return self.k.shape[3]


def init_eviction_stamps(lengths: torch.Tensor, positions: torch.Tensor,
                         capacity: int) -> torch.Tensor:
    """Prefill stamps: slot ``i`` of a head with ``len`` entries gets
    ``position - (len - i)``, so the packed tail (the observation window)
    counts as recent.  ``lengths [..., B, H]``, ``positions [B]`` ->
    ``[..., B, H, C]`` int32."""
    slot = torch.arange(capacity, device=lengths.device)
    return (positions[:, None, None] - (lengths[..., None] - slot)).to(torch.int32)


def evicting_cache_from_jax(k, v, scores, stamps, lengths, positions, device="cpu",
                            dtype=torch.float32) -> EvictingKVCache:
    """The port's evicting cache holding a JAX ``EvictingKVCache``'s arrays
    (as numpy), K/V in ``dtype``."""
    f = lambda a, dt: torch.from_numpy(np.asarray(a).astype(np.float32)).to(device, dt)  # noqa: E731
    i = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)  # noqa: E731
    return EvictingKVCache(f(k, dtype), f(v, dtype), f(scores, torch.float32), i(stamps),
                           i(lengths), i(positions))
