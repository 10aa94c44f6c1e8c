"""K3 and K4: one-token decode attention over a per-token int8 (K3) or
int4 (K4) cache, dequantization folded into the dots, with the new token
quantized and appended in place.

The CUDA kernels (``csrc/decode_attn_quant.cu``) replace the Pallas TPU
kernels ``kvcache_factory_tpu/ops/kernels/decode_attn_quant.py::
_quant_decode_kernel`` and ``::_quant4_decode_kernel``.  Their source
header says what bounds them on the card and how the design answers that.
The cache layout is ``cache/quant_cache.py``'s: codes ``[H, C, D]`` (int8)
or ``[H, C, D/2]`` (int4, two channels per byte) uint8, and ``scales
[H, C, 4]`` bf16 per layer.

Dispatch is K2's rule: a CPU tensor goes to the plain version
(``*_reference``); a CUDA tensor goes to the kernel, or raises.
``quant_decode_attention_append.launches`` and
``quant4_decode_attention_append.launches`` count kernel launches.

K3 and K4 are one launch per call each, as K2 is: ``decode_attn.split_count``
picks the CTAs per head, each finds its share of the head's valid keys on
the device, and the last CTA of a head to raise its arrival counter (K2's
per-device workspace, ``decode_attn._counters``) merges.  Launches of K2, K3
and K4 on one device share the counters, so they must run in stream order,
as the decode step issues them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...cache.quant_cache import dequantize, encode_per_token
from ..attention import NEG_INF
from . import _build
from .decode_attn import GROUPS, HEAD_DIM, _counters, _sm_count, split_count

SOURCE = "kvcache_factory_tpu_torch/csrc/decode_attn_quant.cu"
REPLACES = {8: "kvcache_factory_tpu/ops/kernels/decode_attn_quant.py:76",
            4: "kvcache_factory_tpu/ops/kernels/decode_attn_quant.py:479"}


def quant_decode_attention_append(
    q: torch.Tensor,        # [H, G, D]
    k_codes: torch.Tensor,  # [H, C, D] uint8, one layer's key codes, updated in place
    v_codes: torch.Tensor,  # [H, C, D] uint8
    scales: torch.Tensor,   # [H, C, 4] bf16 (k_scale, k_zero, v_scale, v_zero)
    lengths: torch.Tensor,  # [H] int32
    k_new: torch.Tensor,    # [H, D]
    v_new: torch.Tensor,    # [H, D]
    lower: Optional[torch.Tensor] = None,  # [H] int32 first readable slot
) -> torch.Tensor:
    """K3.  Attention of ``q`` over the dequantized cache rows ``lower[h] <=
    idx < L`` plus the new token (from ``k_new``/``v_new`` in full
    precision), with ``L = min(lengths[h], C - 1)``; fp32 softmax, logits
    scaled by ``1/sqrt(D)``.  Quantizes the new token per token and writes
    its codes and four scalars into slot ``L`` in place.  Returns ``out
    [H, G, D]``; the caller advances ``lengths`` to ``min(lengths + 1, C)``."""
    if q.device.type == "cpu":
        return quant_decode_attention_append_reference(
            q, k_codes, v_codes, scales, lengths, k_new, v_new, lower)
    out = _launch(8, q, k_codes, v_codes, scales, lengths, k_new, v_new, lower)
    quant_decode_attention_append.launches += 1
    return out


def quant4_decode_attention_append(
    q: torch.Tensor,        # [H, G, D]
    k_codes: torch.Tensor,  # [H, C, D/2] uint8, channel 2i low nibble, 2i+1 high
    v_codes: torch.Tensor,  # [H, C, D/2] uint8
    scales: torch.Tensor,   # [H, C, 4] bf16
    lengths: torch.Tensor,  # [H] int32
    k_new: torch.Tensor,    # [H, D]
    v_new: torch.Tensor,    # [H, D]
    lower: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K4: :func:`quant_decode_attention_append` over the int4 cache."""
    if q.device.type == "cpu":
        return quant4_decode_attention_append_reference(
            q, k_codes, v_codes, scales, lengths, k_new, v_new, lower)
    out = _launch(4, q, k_codes, v_codes, scales, lengths, k_new, v_new, lower)
    quant4_decode_attention_append.launches += 1
    return out


quant_decode_attention_append.launches = 0
quant4_decode_attention_append.launches = 0


def _launch(nbits, q, k_codes, v_codes, scales, lengths, k_new, v_new, lower):
    lib = _build.load("decode_attn_quant")
    # K3 and K4 read k_new and v_new with vector loads: a view that starts
    # off a 16-byte boundary is copied into a fresh (aligned) tensor first.
    k_new, v_new = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (k_new, v_new))
    _check(nbits, q, k_codes, v_codes, scales, lengths, k_new, v_new, lower)
    H, G, D = q.shape
    C = k_codes.shape[1]
    dev = q.device
    n_split = split_count(H, C, _sm_count(dev))
    counters = _counters(dev, H)
    out = torch.empty_like(q)
    part = torch.empty(H * n_split * G * (D + 4), dtype=torch.float32, device=dev)
    entry = lib.kvcf_quant8_decode_attn_append if nbits == 8 else lib.kvcf_quant4_decode_attn_append
    with torch.cuda.device(dev):
        code = entry(q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(), scales.data_ptr(),
                     lengths.data_ptr(), None if lower is None else lower.data_ptr(),
                     k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), part.data_ptr(),
                     counters.data_ptr(), H, G, C, n_split, D ** -0.5,
                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"decode_attn_quant (int{nbits})")
    return out


def _check(nbits, q, k_codes, v_codes, scales, lengths, k_new, v_new, lower):
    what = f"decode_attn_quant (int{nbits})"
    # q, the codes, k_new and v_new are read with 16-byte vector loads, a
    # token's four scalars with one 8-byte load, the int32 vectors one int
    # at a time.
    named = [("q", q, 16), ("k_codes", k_codes, 16), ("v_codes", v_codes, 16),
             ("scales", scales, 8), ("lengths", lengths, 4), ("k_new", k_new, 16),
             ("v_new", v_new, 16)]
    if lower is not None:
        named.append(("lower", lower, 4))
    for name, t, align in named:
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{what}: {name} must be {align}-byte aligned")
    if q.dim() != 3:
        raise ValueError(f"{what}: q must be [H, G, D], got {tuple(q.shape)}")
    H, G, D = q.shape
    if D != HEAD_DIM or G not in GROUPS:
        raise ValueError(f"{what}: needs head_dim {HEAD_DIM} and G in {tuple(GROUPS)}, got "
                         f"D={D}, G={G}; other head_dims and groups are ROADMAP.md queue 2, "
                         "\"Shapes the TPU kernels take and the port's kernels refuse on CUDA\"")
    for name, t in (("q", q), ("scales", scales), ("k_new", k_new), ("v_new", v_new)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: {name} must be bfloat16, got {t.dtype}")
    width = D if nbits == 8 else D // 2
    for name, t in (("k_codes", k_codes), ("v_codes", v_codes)):
        if t.dtype != torch.uint8:
            raise ValueError(f"{what}: {name} must be uint8, got {t.dtype}")
    if k_codes.dim() != 3 or k_codes.shape[0] != H or k_codes.shape[2] != width \
            or k_codes.shape[1] < 1 or v_codes.shape != k_codes.shape:
        raise ValueError(f"{what}: code shape {tuple(k_codes.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if scales.shape != (H, k_codes.shape[1], 4):
        raise ValueError(f"{what}: scales must be [H, C, 4], got {tuple(scales.shape)}")
    if k_new.shape != (H, D) or v_new.shape != (H, D):
        raise ValueError(f"{what}: k_new/v_new must be [H, D]")
    for name, t in (("lengths", lengths), ("lower", lower)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (H,)):
            raise ValueError(f"{what}: {name} must be int32 of shape [H]")
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")


def _reference(nbits, q, k_codes, v_codes, scales, lengths, k_new, v_new, lower):
    H, G, D = q.shape
    C = k_codes.shape[1]
    dev = q.device
    L = lengths.to(torch.int64).clamp(max=C - 1)
    lo = torch.zeros_like(L) if lower is None else lower.to(torch.int64)
    idx = torch.arange(C, device=dev)[None]
    mask = (idx >= lo[:, None]) & (idx < L[:, None])  # slot L comes from k_new
    k = dequantize(k_codes, scales[..., 0], scales[..., 1], nbits)
    v = dequantize(v_codes, scales[..., 2], scales[..., 3], nbits)
    qs = q.float() * D ** -0.5
    kn, vn = k_new.float(), v_new.float()
    logits = torch.einsum("hgd,hcd->hgc", qs, k)
    logits = torch.where(mask[:, None], logits, NEG_INF)
    s_new = torch.einsum("hgd,hd->hg", qs, kn)[..., None]
    probs = torch.softmax(torch.cat([logits, s_new], dim=-1), dim=-1)
    out = torch.einsum("hgc,hcd->hgd", probs[..., :C], v) + probs[..., C:] * vn[:, None]
    heads = torch.arange(H, device=dev)
    for codes, x, col in ((k_codes, k_new, 0), (v_codes, v_new, 2)):
        c, scale, zero = encode_per_token(x[:, None], nbits)
        codes[heads, L] = c[:, 0]
        scales[heads, L, col] = scale[:, 0]
        scales[heads, L, col + 1] = zero[:, 0]
    return out.to(q.dtype)


def quant_decode_attention_append_reference(
    q: torch.Tensor, k_codes: torch.Tensor, v_codes: torch.Tensor,
    scales: torch.Tensor, lengths: torch.Tensor, k_new: torch.Tensor,
    v_new: torch.Tensor, lower: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`quant_decode_attention_append`: dequantize
    the layer with its bf16 scalars, masked fp32 attention over ``lower <=
    idx < L`` and the new token, then the quantized append in place."""
    return _reference(8, q, k_codes, v_codes, scales, lengths, k_new, v_new, lower)


def quant4_decode_attention_append_reference(
    q: torch.Tensor, k_codes: torch.Tensor, v_codes: torch.Tensor,
    scales: torch.Tensor, lengths: torch.Tensor, k_new: torch.Tensor,
    v_new: torch.Tensor, lower: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`quant4_decode_attention_append`."""
    return _reference(4, q, k_codes, v_codes, scales, lengths, k_new, v_new, lower)
