"""SSM (Mamba-family) recurrent cache (port of ``kvcache_factory_tpu/cache/ssm_cache.py``).

The reference's vendored ``MambaCache`` (cache_utils_think.py:1596-1690):
``conv_states [L, B, intermediate, conv_kernel]`` and ``ssm_states [L, B,
intermediate, state]``.  It follows the repo's layout rule (``positions``
``[B]``, every other tensor ``[L, B, ...]``), so the batching engine's slot
copies serve it as they serve the attention caches.

* ``update_conv`` rolls the layer's window left one slot and writes the new
  input column at ``min(position, K - 1)`` (the reference's
  ``cache_position.clamp(0, K - 1)``, ``roll(shifts=-1)`` and indexed
  write, :1674-1683);
* ``update_ssm`` replaces the layer's state (:1685-1688).

As the port's other caches, the updates are in place; each returns the
cache.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SSMCache(NamedTuple):
    conv_states: torch.Tensor  # [L, B, intermediate, conv_kernel]
    ssm_states: torch.Tensor   # [L, B, intermediate, state]
    positions: torch.Tensor    # [B] int32 — tokens seen (the conv clamp clock)

    @property
    def conv_kernel_size(self) -> int:
        return self.conv_states.shape[3]

    @property
    def num_layers(self) -> int:
        return self.conv_states.shape[0]


def init_ssm_cache(num_layers: int, batch: int, intermediate: int, conv_kernel: int,
                   state: int, dtype=torch.bfloat16, device="cuda") -> SSMCache:
    """A zeroed cache (reference ``MambaCache.__init__``, :1656-1672)."""
    return SSMCache(
        conv_states=torch.zeros((num_layers, batch, intermediate, conv_kernel), dtype=dtype,
                                device=device),
        ssm_states=torch.zeros((num_layers, batch, intermediate, state), dtype=dtype,
                               device=device),
        positions=torch.zeros((batch,), dtype=torch.int32, device=device))


def update_conv(cache: SSMCache, layer_idx: int, x_t: torch.Tensor) -> SSMCache:
    """Push one timestep's input column ``x_t [B, intermediate]`` into the
    layer's conv window, each row at its own ``positions`` clock."""
    K = cache.conv_kernel_size
    conv = cache.conv_states[layer_idx]
    rolled = torch.roll(conv, -1, dims=-1)
    slot = cache.positions.long().clamp(max=K - 1)
    idx = slot.view(-1, 1, 1).expand(conv.shape[0], conv.shape[1], 1)
    conv.copy_(rolled.scatter(-1, idx, x_t.to(conv.dtype)[:, :, None]))
    return cache


def update_ssm(cache: SSMCache, layer_idx: int, new_state: torch.Tensor) -> SSMCache:
    """Replace the layer's state with ``new_state [B, intermediate, state]``."""
    cache.ssm_states[layer_idx] = new_state.to(cache.ssm_states.dtype)
    return cache


def advance(cache: SSMCache) -> SSMCache:
    """Advance every row's step clock after all layers updated."""
    cache.positions.add_(1)
    return cache


def conv_window(cache: SSMCache, layer_idx: int) -> torch.Tensor:
    """The layer's conv window ``[B, intermediate, K]``, newest last."""
    return cache.conv_states[layer_idx]
