"""Per-token int8 and int4 KV caches (port of the per-token half of
``kvcache_factory_tpu/cache/quant_cache.py``, lines 257-378).

One scale and one zero per (token, head) over the full head_dim:
``x ~ code * scale + zero`` with ``scale = max(max - min, 1e-8) / 255``
(``/ 15`` for int4) and ``zero = min``, computed in fp32 and stored in
bf16; codes are ``clip(round((x - min) / scale))`` with round-half-to-even,
as ``jnp.round``.  Dequantization reads the stored bf16 scale and zero.

The values are the JAX package's; the layouts are the card's, not Mosaic's:

- codes are unsigned, ``[L, B, H, C, D]`` uint8 for int8 and
  ``[L, B, H, C, D/2]`` uint8 for int4, two channels per byte (channel
  ``2i`` in the low nibble, ``2i + 1`` in the high one).  A token's row is
  whole, so an append writes whole bytes and no two tokens share a byte
  (the TPU cache packs token ``t`` with token ``C/2 + t`` and biases codes
  by -128);
- the four scalars of a token, ``(k_scale, k_zero, v_scale, v_zero)``, sit
  together as ``scales [L, B, H, C, 4]`` bf16: one 8-byte load per token
  (the TPU cache keeps ``[.., 4, C]`` planes with tokens on lanes).

Neither needs a capacity alignment.  :func:`quant_cache_from_jax` carries a
JAX-built cache across, from numpy arrays.  Like ``KVCache``, the port's
decode step updates these tensors in place.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch


class Int8KVCache(NamedTuple):
    """Stands for the JAX package's ``QuantKVCacheTPU``."""

    k_codes: torch.Tensor    # [L, B, H, C, D] uint8
    v_codes: torch.Tensor    # [L, B, H, C, D] uint8
    scales: torch.Tensor     # [L, B, H, C, 4] bf16: k_scale, k_zero, v_scale, v_zero
    lengths: torch.Tensor    # [L, B, H] int32
    positions: torch.Tensor  # [B] int32 — uncompressed tokens seen (RoPE clock)

    @property
    def capacity(self) -> int:
        return self.k_codes.shape[3]

    @property
    def nbits(self) -> int:
        return 8


class Int4KVCache(NamedTuple):
    """Stands for the JAX package's ``QuantKVCacheTPU4``."""

    k_codes: torch.Tensor    # [L, B, H, C, D/2] uint8, two channels per byte
    v_codes: torch.Tensor    # [L, B, H, C, D/2] uint8
    scales: torch.Tensor     # [L, B, H, C, 4] bf16: k_scale, k_zero, v_scale, v_zero
    lengths: torch.Tensor    # [L, B, H] int32
    positions: torch.Tensor  # [B] int32

    @property
    def capacity(self) -> int:
        return self.k_codes.shape[3]

    @property
    def nbits(self) -> int:
        return 4


QuantCache = Union[Int8KVCache, Int4KVCache]
_CLASSES = {8: Int8KVCache, 4: Int4KVCache}


def _quantize(x: torch.Tensor, qmax: float):
    xf = x.float()
    mn = xf.amin(dim=-1)
    mx = xf.amax(dim=-1)
    # Divide by a tensor, not a Python number: on CUDA PyTorch turns division
    # by a scalar into a product with its reciprocal, which is not the IEEE
    # quotient that JAX and the kernels compute.
    scale = (mx - mn).clamp_min(1e-8) / torch.full_like(mx, qmax)
    codes = torch.clamp(torch.round((xf - mn[..., None]) / scale[..., None]), 0, qmax)
    return codes.to(torch.uint8), scale, mn


def quantize_per_token(x: torch.Tensor):
    """[..., C, D] -> (codes uint8 in [0, 255], scale fp32 [..., C],
    zero fp32 [..., C])."""
    return _quantize(x, 255.0)


def quantize_per_token4(x: torch.Tensor):
    """[..., C, D] -> (codes uint8 in [0, 15], scale fp32 [..., C], zero fp32
    [..., C]); the codes are not packed yet (:func:`pack_int4`)."""
    return _quantize(x, 15.0)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[..., D] codes in [0, 15] -> [..., D/2] uint8, channel 2i in the low
    nibble and 2i + 1 in the high one."""
    c = codes.to(torch.uint8)
    return c[..., 0::2] | (c[..., 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., D/2] uint8 -> [..., D] uint8 codes in [0, 15]."""
    return torch.stack([packed & 0xF, packed >> 4], dim=-1).flatten(-2)


def encode(x: torch.Tensor, nbits: int):
    """[..., C, D] -> (stored codes, scale bf16 [..., C], zero bf16 [..., C])
    in the cache's layout for ``nbits`` 8 or 4."""
    if nbits == 8:
        codes, scale, zero = quantize_per_token(x)
    else:
        codes, scale, zero = quantize_per_token4(x)
        codes = pack_int4(codes)
    return codes, scale.to(torch.bfloat16), zero.to(torch.bfloat16)


def dequantize(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
               nbits: int) -> torch.Tensor:
    """Stored codes [..., C, D or D/2] with their bf16 scale and zero
    [..., C] -> fp32 values [..., C, D]."""
    c = unpack_int4(codes) if nbits == 4 else codes
    return c.float() * scale.float()[..., None] + zero.float()[..., None]


def dequantize_kv(cache: QuantCache):
    """The whole cache's keys and values in fp32, [L, B, H, C, D] each."""
    s = cache.scales
    return (dequantize(cache.k_codes, s[..., 0], s[..., 1], cache.nbits),
            dequantize(cache.v_codes, s[..., 2], s[..., 3], cache.nbits))


def init_quant_cache(nbits: int, num_layers: int, batch: int, num_heads: int,
                     capacity: int, head_dim: int, device="cuda") -> QuantCache:
    """An empty cache: zero codes and scalars, zero lengths."""
    lead = (num_layers, batch, num_heads, capacity)
    width = head_dim if nbits == 8 else head_dim // 2
    return _CLASSES[nbits](
        k_codes=torch.zeros(lead + (width,), dtype=torch.uint8, device=device),
        v_codes=torch.zeros(lead + (width,), dtype=torch.uint8, device=device),
        scales=torch.zeros(lead + (4,), dtype=torch.bfloat16, device=device),
        lengths=torch.zeros(lead[:3], dtype=torch.int32, device=device),
        positions=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def store_rows(cache: QuantCache, layer: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Quantize one layer's packed K/V ``[B, H, n, D]`` into slots
    ``[0, n)`` of layer ``layer``, in place."""
    n = k.shape[2]
    for codes, x, col in ((cache.k_codes, k, 0), (cache.v_codes, v, 2)):
        c, scale, zero = encode(x, cache.nbits)
        codes[layer, :, :, :n] = c
        cache.scales[layer, :, :, :n, col] = scale
        cache.scales[layer, :, :, :n, col + 1] = zero


def from_packed_prefill(k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                        positions: torch.Tensor, nbits: int = 8) -> QuantCache:
    """Quantize a prefill-packed dense cache ``[L, B, H, C, D]`` whole, as
    the JAX package's ``from_packed_prefill_tpu`` (nbits 8) and
    ``from_packed_prefill_tpu4`` (nbits 4) do."""
    L, B, H, C, D = k.shape
    cache = init_quant_cache(nbits, L, B, H, C, D, device=k.device)
    for li in range(L):
        store_rows(cache, li, k[li], v[li])
    cache.lengths.copy_(lengths)
    cache.positions.copy_(positions)
    return cache


def quant_cache_from_jax(k_codes, v_codes, scales, lengths, positions, nbits: int,
                         device="cpu") -> QuantCache:
    """The port's cache holding what a JAX ``QuantKVCacheTPU`` (nbits 8) or
    ``QuantKVCacheTPU4`` (nbits 4) holds, from its arrays as numpy:

    - int8 codes are biased by -128 there and unsigned here;
    - int4 byte row ``t`` holds tokens ``t`` (low nibble) and ``C/2 + t``
      (high) there; here the nibbles are unpacked and repacked along
      channels;
    - the ``[.., 4, C]`` scale planes become ``[.., C, 4]``.
    """
    kc, vc = np.asarray(k_codes), np.asarray(v_codes)
    sc = np.asarray(scales)

    def codes(c):
        u = (c.astype(np.int16) + 128).astype(np.uint8)
        if nbits == 8:
            return torch.from_numpy(u)
        tokens = np.concatenate([u & 0xF, u >> 4], axis=-2)  # [.., C, D]
        return pack_int4(torch.from_numpy(tokens))

    scales_t = torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(sc.astype(np.float32), -1, -2))).to(torch.bfloat16)
    return _CLASSES[nbits](
        k_codes=codes(kc).contiguous().to(device),
        v_codes=codes(vc).contiguous().to(device),
        scales=scales_t.to(device),
        lengths=torch.tensor(np.asarray(lengths), dtype=torch.int32, device=device),
        positions=torch.tensor(np.asarray(positions), dtype=torch.int32, device=device),
    )
