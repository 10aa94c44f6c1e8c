"""K1: causal flash prefill attention that also emits the SnapKV window
scores, with its sliding-window and chunk (``row_offset``) variants.

The CUDA kernel (``csrc/flash_prefill.cu``) replaces the Pallas TPU kernel
``kvcache_factory_tpu/ops/kernels/flash_prefill.py::_flash_kernel`` (dense
causal path with score emission, ``sliding_window`` and chunk mode).  Its
source header says what bounds it on the card and how the design answers
that.

Dispatch is one rule: a CPU tensor goes to the plain version
(:func:`flash_prefill_attention_reference`); a CUDA tensor goes to the
kernel, or raises.  ``flash_prefill_attention.launches`` counts kernel
launches, and ``flash_prefill_attention.variant_launches`` splits them by
variant: ``"dense"``, ``"sliding_window"`` (whole-sequence queries under a
window) and ``"chunk"`` (``row_offset`` given, with or without a window).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..attention import NEG_INF
from . import _build

SOURCE = "kvcache_factory_tpu_torch/csrc/flash_prefill.cu"
REPLACES = "kvcache_factory_tpu/ops/kernels/flash_prefill.py:66"
# The TPU kernel's lines for each variant (its mask, tile bounds and entry).
REPLACES_VARIANT = {
    "sliding_window": "kvcache_factory_tpu/ops/kernels/flash_prefill.py:113-129",
    "chunk": "kvcache_factory_tpu/ops/kernels/flash_prefill.py:103-112",
}
HEAD_DIM = 128
MAX_WINDOW = 64

RowOffset = Union[None, int, torch.Tensor]


def flash_prefill_attention(
    q: torch.Tensor,         # [B, Hq, S_q, D]
    k: torch.Tensor,         # [B, Hkv, S_k, D]
    v: torch.Tensor,         # [B, Hkv, S_k, D]
    true_len: torch.Tensor,  # [B] int32
    window: int,
    sliding_window: Optional[int] = None,
    row_offset: RowOffset = None,  # int or [B] int32: global id of q row 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out [B, Hq, S_q, D], scores [B, Hq, S_k] fp32)``.

    Row ``r`` of example ``b`` has the global id ``R = row_offset[b] + r``
    (``R = r`` without ``row_offset``) and attends the columns
    ``c <= min(R, true_len[b]-1)``, and ``c > R - sliding_window`` under a
    window, with logits scaled by ``1/sqrt(D)``.  ``scores[b, h, c]`` is the
    sum over the observation-window rows ``[true_len - window, true_len)``
    of the final normalized causal probabilities; the caller masks the
    columns at or past ``true_len - window``.  ``window=0`` emits zeros.

    The JAX wrapper's contract (``flash_prefill.py:489-507``): window scores
    need the dense causal softmax of whole-sequence queries, so ``window``
    is 0 under ``sliding_window`` and in chunk mode; q and k lengths differ
    only in chunk mode; ``row_offset >= 0``.  Output rows at or past
    ``true_len`` are unspecified (never read by the model); a row whose
    ``true_len`` is 0 comes out finite (zeros from the kernel)."""
    _check_contract(q, k, window, sliding_window, row_offset)
    if q.device.type == "cpu":
        return flash_prefill_attention_reference(
            q, k, v, true_len, window, sliding_window=sliding_window,
            row_offset=row_offset)
    lib = _build.load("flash_prefill")
    B, Hq, S_q, D = q.shape
    S_k = k.shape[2]
    dev = q.device
    if row_offset is not None and not (torch.is_tensor(row_offset)
                                       and row_offset.shape == (B,)):
        row_offset = torch.as_tensor(row_offset, dtype=torch.int32, device=dev) \
            .reshape(-1).expand(B).contiguous()
    _check(q, k, v, true_len, window, sliding_window, row_offset)
    out = torch.empty_like(q)
    scores = (torch.empty if window else torch.zeros)(
        (B, Hq, S_k), dtype=torch.float32, device=dev)
    win_ml = torch.empty((B, Hq, max(window, 1), 2), dtype=torch.float32,
                         device=dev)
    with torch.cuda.device(dev):
        code = lib.kvcf_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), true_len.data_ptr(),
            None if row_offset is None else row_offset.data_ptr(),
            out.data_ptr(), win_ml.data_ptr(), scores.data_ptr(),
            B, Hq, k.shape[1], S_q, S_k, window, sliding_window or 0, D ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "flash_prefill")
    flash_prefill_attention.launches += 1
    flash_prefill_attention.variant_launches[variant(sliding_window, row_offset)] += 1
    return out, scores


flash_prefill_attention.launches = 0
flash_prefill_attention.variant_launches = {"dense": 0, "sliding_window": 0, "chunk": 0}


def variant(sliding_window: Optional[int], row_offset: RowOffset) -> str:
    """Which of K1's variants a call runs."""
    if row_offset is not None:
        return "chunk"
    return "dense" if sliding_window is None else "sliding_window"


def reset_launches() -> None:
    flash_prefill_attention.launches = 0
    for key in flash_prefill_attention.variant_launches:
        flash_prefill_attention.variant_launches[key] = 0


def _check_contract(q, k, window, sliding_window, row_offset):
    """The JAX wrapper's asserts (``flash_prefill.py:495-507``), on every
    device."""
    if sliding_window is not None and sliding_window < 1:
        raise ValueError("flash_prefill: sliding_window must be >= 1")
    if window and (sliding_window is not None or row_offset is not None):
        raise ValueError("flash_prefill: window scores need the dense causal softmax "
                         "of whole-sequence queries; pass window=0 with a "
                         "sliding_window or a row_offset")
    if row_offset is None and q.shape[2] != k.shape[2]:
        raise ValueError("flash_prefill: q and k lengths differ only in chunk mode "
                         f"(row_offset), got {q.shape[2]} and {k.shape[2]}")
    if row_offset is not None and not torch.is_tensor(row_offset) and row_offset < 0:
        raise ValueError("flash_prefill: row_offset must be >= 0")


def _check(q, k, v, true_len, window, sliding_window=None, row_offset=None):
    # q, k and v are read with 16-byte vector loads; the int32 vectors one
    # int at a time.
    named = [("q", q, 16), ("k", k, 16), ("v", v, 16), ("true_len", true_len, 4)]
    if row_offset is not None:
        named.append(("row_offset", row_offset, 4))
    for name, t, align in named:
        if t.device != q.device:
            raise ValueError(f"flash_prefill: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_prefill: {name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"flash_prefill: {name} must be {align}-byte aligned")
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.dim() != 4:
            raise ValueError(f"flash_prefill: {name} must be a 4-d bfloat16 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    B, Hq, S_q, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash_prefill: head_dim must be {HEAD_DIM}, got {D}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or k.shape[2] < 1 \
            or Hq % k.shape[1]:
        raise ValueError(f"flash_prefill: k/v shape {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    for name, t in (("true_len", true_len), ("row_offset", row_offset)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (B,)):
            raise ValueError(f"flash_prefill: {name} must be int32 of shape [B]")
    if not 0 <= window <= MAX_WINDOW:
        raise ValueError(f"flash_prefill: window must be in [0, {MAX_WINDOW}]")


def flash_prefill_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    true_len: torch.Tensor, window: int, q_block: int = 256,
    sliding_window: Optional[int] = None, row_offset: RowOffset = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_prefill_attention`: fp32 logits and
    softmax blocked over q rows, the same masks and window scores.  As in
    both kernels, the unnormalized probabilities ``exp(s - m)`` are rounded
    to the value dtype before the PV product and the result is divided by
    the fp32 row sum afterwards.  A row that sees no column (an inert row,
    ``true_len`` 0) averages every value row: finite, and never read."""
    B, Hq, S_q, D = q.shape
    Hkv, S_k = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    tl = true_len.to(device=dev, dtype=torch.int64)
    off = torch.zeros((B,), dtype=torch.int64, device=dev) if row_offset is None \
        else torch.as_tensor(row_offset, device=dev).to(torch.int64).reshape(-1).expand(B)
    qg = q.reshape(B, Hkv, G, S_q, D)
    kf, vf = k.float(), v.float()
    cols = torch.arange(S_k, device=dev)
    scores = torch.zeros((B, Hkv, G, S_k), dtype=torch.float32, device=dev)
    outs = []
    for r0 in range(0, S_q, q_block):
        qblk = qg[:, :, :, r0:r0 + q_block].float()
        rows = off[:, None] + r0 + torch.arange(qblk.shape[3], device=dev)  # [B, n] global
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kf) * D ** -0.5
        lim = torch.minimum(rows, tl[:, None] - 1)
        bad = cols[None, None] > lim[:, :, None]                 # [B, n, S_k]
        if sliding_window is not None:
            bad = bad | (cols[None, None] <= rows[:, :, None] - sliding_window)
        logits = torch.where(bad[:, None, None], NEG_INF, logits)
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vf) / denom
        outs.append(out.to(q.dtype))
        if window:
            in_win = (rows >= tl[:, None] - window) & (rows < tl[:, None])
            if bool(in_win.any()):
                scores += (p / denom * in_win[:, None, None, :, None]).sum(dim=3)
    out = torch.cat(outs, dim=3).reshape(B, Hq, S_q, D)
    return out, scores.reshape(B, Hq, S_k)
