"""Quantized KV caches (port of ``kvcache_factory_tpu/cache/quant_cache.py``).

Two families, as in the JAX package:

- **Per-token** (its lines 257-378): ``Int8KVCache`` / ``Int4KVCache``,
  which K3 / K4 stream.  One scale and one zero per (token, head) over the
  full head_dim: ``x ~ code * scale + zero`` with ``scale = max(max - min,
  1e-8) / 255`` (``/ 15`` for int4) and ``zero = min``, computed in fp32
  and stored in bf16; codes are ``clip(round((x - min) / scale))`` with
  round-half-to-even, as ``jnp.round``.
- **Grouped** (its lines 41-226): ``QuantizedKVCache``, which decode
  dequantizes in plain torch, as JAX's XLA path does.  The same affine per
  group of ``q_group_size`` channels at nbits 1, 2, 3, 4 or 8, optionally
  with each group's largest-|x| entry kept exactly (``outlier_extract``: a
  bf16 value and its in-group index, zeroed before min/max) and an fp
  residual ring over the last ``residual_length`` rows, which wins the read
  for those rows.

The values are the JAX package's; the layouts are the card's, not Mosaic's:

- every code is unsigned (the JAX package biases its bytes by -128);
- per-token int8 codes are ``[L, B, H, C, D]`` uint8, int4 ``[L, B, H, C,
  D/2]`` two channels per byte (channel ``2i`` in the low nibble, ``2i + 1``
  in the high one).  A token's row is whole, so an append writes whole
  bytes and no two tokens share a byte (the TPU cache packs token ``t``
  with token ``C/2 + t``);
- the four per-token scalars ``(k_scale, k_zero, v_scale, v_zero)`` sit
  together as ``scales [L, B, H, C, 4]`` bf16: one 8-byte load per token
  (the TPU cache keeps ``[.., 4, C]`` planes with tokens on lanes);
- grouped codes are ``[L, B, H, C, D / vpb]`` uint8 with ``vpb`` values a
  byte (:data:`VALUES_PER_BYTE`; value ``i`` in bits ``[i * w, i * w +
  nbits)``, ``w = 8 / vpb``; 3-bit values take a nibble each), as in the
  JAX cache apart from the bias; scales, zeros and outlier values are
  ``[L, B, H, C, G]`` bf16 and outlier indices ``[L, B, H, C, G]`` uint8.

None needs a capacity alignment.  :func:`quant_cache_from_jax` and
:func:`grouped_cache_from_jax` carry a JAX-built cache across, from numpy
arrays.  Like ``KVCache``, the port's decode step updates these tensors in
place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

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


def encode_per_token(x: torch.Tensor, nbits: int):
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
        c, scale, zero = encode_per_token(x, cache.nbits)
        codes[layer, :, :, :n] = c
        cache.scales[layer, :, :, :n, col] = scale
        cache.scales[layer, :, :, :n, col + 1] = zero


def from_packed_prefill(k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                        positions: torch.Tensor, quant=8, extra_capacity: int = 0):
    """Quantize a prefill-packed dense cache ``[L, B, H, C, D]`` whole.
    ``quant`` an nbits, 8 or 4: the per-token cache, as the JAX package's
    ``from_packed_prefill_tpu`` and ``from_packed_prefill_tpu4``; a
    ``QuantConfig``: the grouped cache whatever its nbits, with
    ``extra_capacity`` empty slots of decode headroom, as its
    ``from_packed_prefill``."""
    L, B, H, C, D = k.shape
    if not isinstance(quant, int):
        cache = init_grouped_cache(quant, L, B, H, C + extra_capacity, D, k.dtype, k.device)
        for li in range(L):
            store_grouped_rows(cache, li, k[li], v[li], lengths[li], quant)
    else:
        cache = init_quant_cache(quant, L, B, H, C + extra_capacity, D, device=k.device)
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


# ---------------------------------------------------------------------------
# The grouped cache
# ---------------------------------------------------------------------------


class QuantizedKVCache(NamedTuple):
    """Stands for the JAX package's ``QuantizedKVCache``, with its fields in
    its order.  ``rk`` / ``rv`` are the optional fp residual ring over the
    most recent ``R`` rows (ring slot of cache row ``c``: ``c % R``); the
    ``*_oval`` / ``*_oidx`` planes exist with ``outlier_extract``."""

    qk: torch.Tensor         # [L, B, H, C, D / vpb] uint8
    qv: torch.Tensor         # [L, B, H, C, D / vpb] uint8
    k_scale: torch.Tensor    # [L, B, H, C, G] bf16
    k_zero: torch.Tensor     # [L, B, H, C, G] bf16
    v_scale: torch.Tensor    # [L, B, H, C, G] bf16
    v_zero: torch.Tensor     # [L, B, H, C, G] bf16
    lengths: torch.Tensor    # [L, B, H] int32
    positions: torch.Tensor  # [B] int32
    rk: Optional[torch.Tensor] = None      # [L, B, H, R, D] model dtype
    rv: Optional[torch.Tensor] = None      # [L, B, H, R, D]
    k_oval: Optional[torch.Tensor] = None  # [L, B, H, C, G] bf16 exact value
    k_oidx: Optional[torch.Tensor] = None  # [L, B, H, C, G] uint8 in-group index
    v_oval: Optional[torch.Tensor] = None
    v_oidx: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.qk.shape[3]

    @property
    def residual_length(self) -> int:
        return 0 if self.rk is None else self.rk.shape[3]


# How many quantized values share one stored byte, per bit-width; 3-bit
# values take a nibble each (JAX ``quant_cache.py:110``).
VALUES_PER_BYTE = {1: 8, 2: 4, 3: 2, 4: 2, 8: 1}


def quantize_groups(x: torch.Tensor, group_size: int, nbits: int):
    """``[..., D]`` -> (codes uint8 ``[..., D]`` in ``[0, 2^nbits - 1]``,
    scale fp32 ``[..., G]``, zero fp32 ``[..., G]``): the affine per group,
    ``code = round((x - min) / scale)``, ``x' = code * scale + min``."""
    *lead, D = x.shape
    xg = x.float().reshape(*lead, D // group_size, group_size)
    mn = xg.amin(dim=-1)
    mx = xg.amax(dim=-1)
    qmax = float(2 ** nbits - 1)
    # Divisions by tensors: the IEEE quotients JAX computes (see _quantize).
    scale = (mx - mn).clamp_min(1e-8) / torch.full_like(mx, qmax)
    codes = torch.clamp(torch.round((xg - mn[..., None]) / scale[..., None]), 0, qmax)
    return codes.to(torch.uint8).reshape(*lead, D), scale, mn


def dequantize_groups(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                      group_size: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Codes ``[..., D]`` with their scale and zero ``[..., G]`` -> values
    ``[..., D]``, computed in fp32 and cast to ``dtype``."""
    *lead, D = codes.shape
    cg = codes.reshape(*lead, D // group_size, group_size).float()
    x = cg * scale.float()[..., None] + zero.float()[..., None]
    return x.reshape(*lead, D).to(dtype)


def pack_codes(codes: torch.Tensor, nbits: int) -> torch.Tensor:
    """``[..., D]`` codes -> ``[..., D / vpb]`` uint8, value ``i`` of a byte
    in bits ``[i * w, i * w + nbits)``, ``w = 8 / vpb``."""
    c = codes.to(torch.uint8)
    vpb = VALUES_PER_BYTE[nbits]
    if vpb == 1:
        return c
    w = 8 // vpb
    cg = c.reshape(*c.shape[:-1], c.shape[-1] // vpb, vpb)
    out = cg[..., 0].clone()
    for i in range(1, vpb):
        out |= cg[..., i] << (i * w)
    return out


def unpack_codes(packed: torch.Tensor, nbits: int) -> torch.Tensor:
    """``[..., D / vpb]`` uint8 -> ``[..., D]`` uint8 codes."""
    vpb = VALUES_PER_BYTE[nbits]
    if vpb == 1:
        return packed
    w = 8 // vpb
    shifts = torch.arange(0, 8, w, dtype=torch.uint8, device=packed.device)
    vals = (packed[..., None] >> shifts) & ((1 << nbits) - 1)
    return vals.reshape(*packed.shape[:-1], packed.shape[-1] * vpb)


def extract_group_outliers(x: torch.Tensor, group_size: int):
    """``[..., D]`` -> (stripped fp32 ``[..., D]`` with each group's outlier
    zeroed, its value fp32 ``[..., G]``, its in-group index uint8 ``[...,
    G]``).  The outlier is the group's largest-|x| entry, the first of
    equals, as ``jnp.argmax`` takes it."""
    *lead, D = x.shape
    xg = x.float().reshape(*lead, D // group_size, group_size)
    idx = xg.abs().argmax(dim=-1, keepdim=True)
    oval = xg.gather(-1, idx)[..., 0]
    stripped = xg.scatter(-1, idx, 0.0).reshape(*lead, D)
    return stripped, oval, idx[..., 0].to(torch.uint8)


def scatter_group_outliers(x: torch.Tensor, oval: torch.Tensor, oidx: torch.Tensor,
                           group_size: int) -> torch.Tensor:
    """Inverse of :func:`extract_group_outliers`: write each group's exact
    value back at its index (a scatter; JAX selects with a one-hot)."""
    *lead, D = x.shape
    xg = x.reshape(*lead, D // group_size, group_size)
    return xg.scatter(-1, oidx.long()[..., None],
                      oval[..., None].to(x.dtype)).reshape(*lead, D)


def encode(x: torch.Tensor, cfg):
    """``[..., D]`` -> (stored uint8 ``[..., D / vpb]``, scale, zero, oval,
    oidx) for a ``QuantConfig``: the scalars and outlier values in bf16,
    the outlier planes None without ``outlier_extract`` (JAX ``encode``)."""
    oval = oidx = None
    if cfg.outlier_extract:
        x, oval, oidx = extract_group_outliers(x, cfg.q_group_size)
        oval = oval.to(torch.bfloat16)
    codes, scale, zero = quantize_groups(x, cfg.q_group_size, cfg.nbits)
    return (pack_codes(codes, cfg.nbits), scale.to(torch.bfloat16),
            zero.to(torch.bfloat16), oval, oidx)


def decode_values(stored: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor, cfg,
                  dtype=torch.bfloat16, oval: Optional[torch.Tensor] = None,
                  oidx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stored codes ``[..., D / vpb]`` and their bf16 scalars -> values
    ``[..., D]`` in ``dtype``, outliers written back when given."""
    x = dequantize_groups(unpack_codes(stored, cfg.nbits), scale, zero, cfg.q_group_size,
                          dtype)
    if oval is not None:
        x = scatter_group_outliers(x, oval, oidx, cfg.q_group_size)
    return x


def packed_dim(head_dim: int, cfg) -> int:
    return head_dim // VALUES_PER_BYTE[cfg.nbits]


def residual_ring_rows(lengths: torch.Tensor, R: int, capacity: int) -> torch.Tensor:
    """The cache row feeding each ring slot at prefill: slot ``j`` holds the
    row ``r`` in ``[max(0, len - R), len)`` with ``r % R == j``, ``[..., R]``
    (rows that do not exist are clamped; the recent window never reads
    them)."""
    j = torch.arange(R, device=lengths.device)
    r0 = lengths.long()[..., None] - R
    return (r0 + torch.remainder(j - r0, R)).clamp(0, capacity - 1)


def init_grouped_cache(cfg, num_layers: int, batch: int, num_heads: int, capacity: int,
                       head_dim: int, dtype=torch.bfloat16, device="cuda") -> QuantizedKVCache:
    """An empty grouped cache for the ``QuantConfig`` ``cfg``; the ring (if
    any) holds ``dtype`` values."""
    lead = (num_layers, batch, num_heads, capacity)
    G = head_dim // cfg.q_group_size
    z = lambda *shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    codes = lambda: z(*lead, packed_dim(head_dim, cfg), dt=torch.uint8)  # noqa: E731
    plane = lambda dt=torch.bfloat16: z(*lead, G, dt=dt)  # noqa: E731
    ring = outliers = ()
    R = cfg.residual_length
    if R > 0:
        ring = (z(*lead[:3], R, head_dim, dt=dtype), z(*lead[:3], R, head_dim, dt=dtype))
    if cfg.outlier_extract:
        outliers = (plane(), plane(torch.uint8), plane(), plane(torch.uint8))
    return QuantizedKVCache(codes(), codes(), plane(), plane(), plane(), plane(),
                            z(*lead[:3], dt=torch.int32), z(batch, dt=torch.int32),
                            *(ring or (None, None)), *(outliers or (None,) * 4))


def store_grouped_rows(cache: QuantizedKVCache, layer: int, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, cfg) -> None:
    """Quantize one layer's packed K/V ``[B, H, n, D]`` into slots ``[0, n)``
    of layer ``layer`` and fill its ring from the rows below ``lengths``
    ``[B, H]``, in place (the values of JAX's whole-stack
    ``from_packed_prefill`` over the same rows).  Each layer is written
    once, so no second copy of the packed stack is held."""
    n = k.shape[2]
    outs = (cache.k_oval, cache.k_oidx, cache.v_oval, cache.v_oidx)
    for x, planes, o in ((k, (cache.qk, cache.k_scale, cache.k_zero), outs[:2]),
                         (v, (cache.qv, cache.v_scale, cache.v_zero), outs[2:])):
        stored, scale, zero, oval, oidx = encode(x, cfg)
        for buf, val in zip(planes + o, (stored, scale, zero, oval, oidx)):
            if buf is not None:
                buf[layer, :, :, :n] = val
    if cache.rk is not None:
        # Rows stay below each head's length, which is at most n.
        rows = residual_ring_rows(lengths, cache.residual_length, n)
        idx = rows[..., None].expand(*rows.shape, k.shape[-1])
        cache.rk[layer] = k.gather(2, idx)
        cache.rv[layer] = v.gather(2, idx)
    cache.lengths[layer] = lengths


def grouped_cache_from_jax(qk, qv, k_scale, k_zero, v_scale, v_zero, lengths, positions,
                           rk=None, rv=None, k_oval=None, k_oidx=None, v_oval=None,
                           v_oidx=None, device="cpu", dtype=torch.float32) -> QuantizedKVCache:
    """The port's grouped cache holding what a JAX ``QuantizedKVCache``
    holds, from its arrays as numpy: the codes lose their -128 bias (the
    bits of each value stay where they are), the bf16 planes pass through
    fp32, the ring becomes ``dtype``."""
    def codes(c):
        return torch.from_numpy((np.asarray(c).astype(np.int16) + 128).astype(np.uint8))

    def floats(a, dt):
        return None if a is None else torch.from_numpy(
            np.asarray(a).astype(np.float32)).to(dt)

    def idx(a):
        return None if a is None else torch.from_numpy(np.asarray(a).astype(np.uint8))

    ints = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))  # noqa: E731
    bf = torch.bfloat16
    leaves = (codes(qk), codes(qv), floats(k_scale, bf), floats(k_zero, bf),
              floats(v_scale, bf), floats(v_zero, bf), ints(lengths), ints(positions),
              floats(rk, dtype), floats(rv, dtype), floats(k_oval, bf), idx(k_oidx),
              floats(v_oval, bf), idx(v_oidx))
    return QuantizedKVCache(*(None if t is None else t.to(device) for t in leaves))
