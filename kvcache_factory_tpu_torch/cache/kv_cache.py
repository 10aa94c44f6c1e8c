"""Fixed-capacity padded KV cache (port of ``kvcache_factory_tpu/cache/kv_cache.py``).

One stacked buffer ``[L, B, H, C, D]`` plus per-head valid lengths
``[L, B, H]``.  Ragged per-head budgets are unequal lengths over the same
padded buffer.  ``positions`` tracks the *uncompressed* token count, so RoPE
keeps advancing past the compressed length (the reference's ``_seen_tokens``
sync, llama_model.py:172, 2208).

Unlike the JAX cache, the port's decode step updates these tensors in place
(``models/llama.py::decode_step``).
"""

from __future__ import annotations

from typing import NamedTuple

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
