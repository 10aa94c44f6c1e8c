"""K2: one-token decode attention with the new token appended in place.

The CUDA kernel (``csrc/decode_attn.cu``) replaces the Pallas TPU kernel
``kvcache_factory_tpu/ops/kernels/decode_attn.py::_decode_kernel``.  Its
source header says what bounds it on the card and how the design answers
that.

Dispatch is one rule: a CPU tensor goes to the plain version
(:func:`decode_attention_append_reference`); a CUDA tensor goes to the
kernel, or raises.  ``decode_attention_append.launches`` counts kernel
launches.

One launch per call: each head's keys are split over ``n_split`` CTAs
(:func:`split_count`, from the shapes and the SM count only), and the CTA
of a head that finishes last merges the head's partials.  It finds out
through a per-head arrival counter in a workspace kept per device
(:func:`_counters`), which every launch leaves at 0.  So launches on one
device must run in stream order, as the decode step issues them.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..attention import NEG_INF
from . import _build

SOURCE = "kvcache_factory_tpu_torch/csrc/decode_attn.cu"
REPLACES = "kvcache_factory_tpu/ops/kernels/decode_attn.py:71"
HEAD_DIM = 128
GROUPS = range(1, 9)
MIN_KEYS_PER_SPLIT = 64
CTAS_PER_SM = 2    # resident CTAs an SM holds (the source header's shared memory)
MIN_COUNTERS = 4096  # counters allocated at once, so a graph capture rarely needs more


def decode_attention_append(
    q: torch.Tensor,        # [H, G, D]
    k_layer: torch.Tensor,  # [H, C, D] one layer's keys, updated in place
    v_layer: torch.Tensor,  # [H, C, D] one layer's values, updated in place
    lengths: torch.Tensor,  # [H] int32
    k_new: torch.Tensor,    # [H, D]
    v_new: torch.Tensor,    # [H, D]
    lower: Optional[torch.Tensor] = None,  # [H] int32 first readable slot
) -> torch.Tensor:
    """Attention of ``q`` over the cache rows ``lower[h] <= idx < L`` plus
    the new token, with ``L = min(lengths[h], C - 1)``; fp32 softmax, logits
    scaled by ``1/sqrt(D)``.  Writes ``k_new``/``v_new`` into slot ``L`` of
    ``k_layer``/``v_layer`` in place (a full cache overwrites its last slot,
    as the TPU kernel does).  Returns ``out [H, G, D]``; the caller advances
    ``lengths`` to ``min(lengths + 1, C)``."""
    if q.device.type == "cpu":
        return decode_attention_append_reference(q, k_layer, v_layer, lengths,
                                                 k_new, v_new, lower)
    lib = _build.load("decode_attn")
    _check(q, k_layer, v_layer, lengths, k_new, v_new, lower)
    H, G, D = q.shape
    C = k_layer.shape[1]
    dev = q.device
    n_split = split_count(H, C, _sm_count(dev))
    counters = _counters(dev, H)
    out = torch.empty_like(q)
    part = torch.empty(H * n_split * G * (D + 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.kvcf_decode_attn_append(
            q.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(),
            lengths.data_ptr(), None if lower is None else lower.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), part.data_ptr(),
            counters.data_ptr(), H, G, C, n_split, D ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "decode_attn")
    decode_attention_append.launches += 1
    return out


decode_attention_append.launches = 0


def split_count(H: int, C: int, sm_count: int) -> int:
    """CTAs per head: about ``CTAS_PER_SM`` CTAs on every SM in one wave
    over the ``H`` heads, at most one per ``MIN_KEYS_PER_SPLIT`` slots of the
    capacity; at least 1.  It reads no lengths: each CTA finds its own share
    of its head's valid keys on the device (:func:`split_bounds`)."""
    return max(1, min(CTAS_PER_SM * sm_count // H, -(-C // MIN_KEYS_PER_SPLIT)))


def split_bounds(lo: int, L: int, sp: int, n_split: int) -> Tuple[int, int]:
    """The keys ``[start, end)`` that CTA ``sp`` of ``n_split`` reads of a
    head whose valid range is ``[lo, L)``: the sp-th of near-equal parts, as
    the kernel computes them."""
    n = L - lo
    return lo + n * sp // n_split, lo + n * (sp + 1) // n_split


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, H: int) -> torch.Tensor:
    """The per-head arrival counters of ``device``, at least ``H`` of them,
    zeroed when allocated.  Every launch leaves them at 0, so a CUDA graph
    that captured a launch may replay it: allocate them (by one eager call)
    before a capture needs more."""
    counters = _COUNTERS.get(device)
    if counters is None or counters.numel() < H:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"decode_attn: no arrival counters for {H} heads on {device} "
                               "yet; make one eager call at this H before capturing")
        counters = torch.zeros(max(H, MIN_COUNTERS), dtype=torch.int32, device=device)
        _COUNTERS[device] = counters
    return counters


def _check(q, k_layer, v_layer, lengths, k_new, v_new, lower):
    # q and the cache are read with 16-byte vector loads; the int32 vectors
    # one int at a time and k_new/v_new one element at a time.
    named = [("q", q, 16), ("k_layer", k_layer, 16), ("v_layer", v_layer, 16),
             ("lengths", lengths, 4), ("k_new", k_new, 2), ("v_new", v_new, 2)]
    if lower is not None:
        named.append(("lower", lower, 4))
    for name, t, align in named:
        if t.device != q.device:
            raise ValueError(f"decode_attn: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attn: {name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"decode_attn: {name} must be {align}-byte aligned")
    if q.dim() != 3:
        raise ValueError(f"decode_attn: q must be [H, G, D], got {tuple(q.shape)}")
    H, G, D = q.shape
    if D != HEAD_DIM or G not in GROUPS:
        raise ValueError(f"decode_attn: needs head_dim {HEAD_DIM} and G from {GROUPS[0]} "
                         f"to {GROUPS[-1]}, got D={D}, G={G}; other head_dims and groups "
                         "are ROADMAP.md queue 2, \"Shapes the TPU kernels take and the "
                         "port's kernels refuse on CUDA\"")
    for name, t in (("q", q), ("k_layer", k_layer), ("v_layer", v_layer),
                    ("k_new", k_new), ("v_new", v_new)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"decode_attn: {name} must be bfloat16, got {t.dtype}")
    if k_layer.dim() != 3 or k_layer.shape[0] != H or k_layer.shape[2] != D \
            or k_layer.shape[1] < 1 or v_layer.shape != k_layer.shape:
        raise ValueError(f"decode_attn: cache shape {tuple(k_layer.shape)} does "
                         f"not fit q {tuple(q.shape)}")
    if k_new.shape != (H, D) or v_new.shape != (H, D):
        raise ValueError("decode_attn: k_new/v_new must be [H, D]")
    for name, t in (("lengths", lengths), ("lower", lower)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (H,)):
            raise ValueError(f"decode_attn: {name} must be int32 of shape [H]")
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn: unsupported device {q.device}")


def decode_attention_append_reference(
    q: torch.Tensor, k_layer: torch.Tensor, v_layer: torch.Tensor,
    lengths: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
    lower: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`decode_attention_append`: append in place,
    then masked attention in fp32 over ``lower <= idx < L`` and slot ``L``."""
    H, G, D = q.shape
    C = k_layer.shape[1]
    dev = q.device
    L = lengths.to(torch.int64).clamp(max=C - 1)
    heads = torch.arange(H, device=dev)
    k_layer[heads, L] = k_new.to(k_layer.dtype)
    v_layer[heads, L] = v_new.to(v_layer.dtype)
    idx = torch.arange(C, device=dev)[None]
    lo = torch.zeros_like(L) if lower is None else lower.to(torch.int64)
    mask = ((idx >= lo[:, None]) & (idx < L[:, None])) | (idx == L[:, None])
    logits = torch.einsum("hgd,hcd->hgc", q.float(), k_layer.float()) * D ** -0.5
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("hgc,hcd->hgd", probs, v_layer.float()).to(q.dtype)
