"""K2: one-token decode attention with the new token appended in place.

The CUDA kernel (``csrc/decode_attn.cu``) replaces the Pallas TPU kernel
``kvcache_factory_tpu/ops/kernels/decode_attn.py::_decode_kernel``.  Its
source header says what bounds it on the card and how the design answers
that.

Dispatch is one rule: a CPU tensor goes to the plain version
(:func:`decode_attention_append_reference`); a CUDA tensor goes to the
kernel, or raises.  ``decode_attention_append.launches`` counts kernel
launches.

The kernel takes K1's head_dims (any even one,
``flash_prefill.takes_head_dim``): up to 512 each on the narrowest
instantiation at least as wide (``flash_prefill.instance``: 64, 128, 256,
384 or 512), above 512 on the kernel of ``csrc/decode_attn_wide.cu``, which
splits O's columns over ``flash_prefill.slices(D)`` CTAs of
``flash_prefill.SLICE`` and computes each logit over all of D, so that its
shared memory and registers do not grow with D; each with the true
head_dim's ``1/sqrt(D)``.  ``CTAS_PER_SM_AT`` says how many CTAs of each
instantiation fit an SM (``WIDE`` for the wide kernel).  A head_dim up to
512 that is no multiple of 8 runs the library built to copy rows in 8- or
4-byte pieces
(``flash_prefill.copy_bytes``, :func:`library`).  It takes any group size G: a CTA
computes ``QUERY_BLOCK`` query rows at most, so G above 8 runs
:func:`query_blocks` blocks of rows, each reading the head's keys.

One launch per call: each head's keys are split over ``n_split`` CTAs
(:func:`split_count`, from the shapes and the SM count only) for each query
block, and the CTA of a head that finishes last merges the head's
partials.  It finds out through a per-head arrival counter in a workspace
kept per device (:func:`_counters`), which every launch leaves at 0.  So
launches on one device must run in stream order, as the decode step issues
them.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..attention import NEG_INF
from . import _build
from .flash_prefill import INSTANCES, REFUSED, SLICE, copy_bytes, instance, slices, takes_head_dim

SOURCE = "kvcache_factory_tpu_torch/csrc/decode_attn.cu"
WIDE_SOURCE = "kvcache_factory_tpu_torch/csrc/decode_attn_wide.cu"
REPLACES = "kvcache_factory_tpu/ops/kernels/decode_attn.py:71"
QUERY_BLOCK = 8    # query rows a CTA computes: the mma's N
MIN_KEYS_PER_SPLIT = 64
CTAS_PER_SM = 2    # resident CTAs an SM holds at head_dim 128: the split rule's default
WIDE = "wide"  # the wide kernel's key (head_dims above 512)
# By instantiation (the source header's shared memory: 768 D bytes a CTA up
# to 256, one CTA of 2 warps above; two of the wide kernel's 70 KB).
CTAS_PER_SM_AT = {64: 4, 128: 2, 256: 1, 384: 1, 512: 1, WIDE: 2}
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
    lib = _build.load(library(q.shape[-1]))
    _check(q, k_layer, v_layer, lengths, k_new, v_new, lower)
    H, G, D = q.shape
    C = k_layer.shape[1]
    dev = q.device
    n_split = splits(H, G, C, D, _sm_count(dev))
    # The wide kernel counts arrivals and keeps partials per (head, query
    # block, column slice), and takes the slice count before the head_dim.
    wide = D > INSTANCES[-1]
    n_slice = slices(D)
    counters = _counters(dev, H * query_blocks(G) * n_slice if wide else H)
    out = torch.empty_like(q)
    part = torch.empty(partial_floats(H, G, (SLICE if wide else instance(D)) + 2, n_split)
                       * n_slice, dtype=torch.float32, device=dev)
    shape = ((n_slice,) if wide else ()) + (D,)
    with torch.cuda.device(dev):
        code = getattr(lib, entry(D))(
            q.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(),
            lengths.data_ptr(), None if lower is None else lower.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), part.data_ptr(),
            counters.data_ptr(), H, G, C, n_split, *shape, D ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "decode_attn")
    decode_attention_append.launches += 1
    return out


decode_attention_append.launches = 0


def library(D: int) -> str:
    """The kernel library K2 runs at head_dim ``D``: up to 512
    ``decode_attn`` for rows of 16-byte pieces, else ``decode_attn_p8`` or
    ``_p4``, the same source built to copy pieces of
    ``flash_prefill.copy_bytes(D)``; above 512 ``decode_attn_wide``, which
    picks its piece width from ``D`` itself."""
    if D > INSTANCES[-1]:
        return "decode_attn_wide"
    width = copy_bytes(D)
    return "decode_attn" if width == 16 else f"decode_attn_p{width}"


def entry(D: int) -> str:
    """K2's entry point at head_dim ``D``: its instantiation's up to 512,
    the wide kernel's above."""
    return ("kvcf_decode_attn_append_wide" if D > INSTANCES[-1]
            else f"kvcf_decode_attn_append_d{instance(D)}")


def splits(H: int, G: int, C: int, D: int, sm_count: int) -> int:
    """K2's ``n_split`` at H heads of G query rows, capacity C and head_dim
    D on ``sm_count`` SMs: :func:`split_count` over every CTA of a split
    (the query blocks, and above 512 the column slices)."""
    wide = D > INSTANCES[-1]
    return split_count(H * query_blocks(G) * slices(D), C, sm_count,
                       CTAS_PER_SM_AT[WIDE if wide else instance(D)])


def split_count(H: int, C: int, sm_count: int, ctas_per_sm: int = CTAS_PER_SM) -> int:
    """CTAs per head: about ``ctas_per_sm`` CTAs on every SM in one wave
    over the ``H`` heads, at most one per ``MIN_KEYS_PER_SPLIT`` slots of the
    capacity; at least 1.  It reads no lengths: each CTA finds its own share
    of its head's valid keys on the device (:func:`split_bounds`)."""
    return max(1, min(ctas_per_sm * sm_count // H, -(-C // MIN_KEYS_PER_SPLIT)))


def query_blocks(G: int) -> int:
    """Blocks of ``QUERY_BLOCK`` query rows a head's G rows take: the CTAs
    of one split."""
    return -(-G // QUERY_BLOCK)


def partial_floats(H: int, G: int, row_floats: int, n_split: int) -> int:
    """fp32 scratch of the partials: ``row_floats`` a query row of each
    block (a short last block is padded to the block's rows) and split."""
    return H * query_blocks(G) * n_split * min(G, QUERY_BLOCK) * row_floats


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
    # q and the cache are read in pieces of copy_bytes(D) (16, 8 or 4
    # bytes); the int32 vectors one int at a time and k_new/v_new one
    # element at a time.
    piece = copy_bytes(q.shape[-1])
    named = [("q", q, piece), ("k_layer", k_layer, piece), ("v_layer", v_layer, piece),
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
    if not takes_head_dim(D):
        raise ValueError(f"decode_attn: needs an even head_dim, got D={D}; {REFUSED}")
    if G < 1:
        raise ValueError(f"decode_attn: needs G >= 1, got G={G}")
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
