"""K1: causal flash prefill attention that also emits the SnapKV window scores.

The CUDA kernel (``csrc/flash_prefill.cu``) replaces the Pallas TPU kernel
``kvcache_factory_tpu/ops/kernels/flash_prefill.py::_flash_kernel`` (dense
causal path with score emission).  Its source header says what bounds it on
the card and how the design answers that.

Dispatch is one rule: a CPU tensor goes to the plain version
(:func:`flash_prefill_attention_reference`); a CUDA tensor goes to the
kernel, or raises.  ``flash_prefill_attention.launches`` counts kernel
launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..attention import NEG_INF
from . import _build

SOURCE = "kvcache_factory_tpu_torch/csrc/flash_prefill.cu"
REPLACES = "kvcache_factory_tpu/ops/kernels/flash_prefill.py:66"
HEAD_DIM = 128
MAX_WINDOW = 64


def flash_prefill_attention(
    q: torch.Tensor,         # [B, Hq, S, D]
    k: torch.Tensor,         # [B, Hkv, S, D]
    v: torch.Tensor,         # [B, Hkv, S, D]
    true_len: torch.Tensor,  # [B] int32
    window: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out [B, Hq, S, D], scores [B, Hq, S] fp32)``.

    Row ``r`` of example ``b`` attends columns ``c <= min(r, true_len[b]-1)``
    with logits scaled by ``1/sqrt(D)``.  ``scores[b, h, c]`` is the sum over
    the observation-window rows ``[true_len - window, true_len)`` of the
    final normalized causal probabilities; the caller masks the columns at or
    past ``true_len - window``.  ``window=0`` emits zeros.  Output rows at or
    past ``true_len`` are unspecified (never read by the model)."""
    if q.device.type == "cpu":
        return flash_prefill_attention_reference(q, k, v, true_len, window)
    lib = _build.load("flash_prefill")
    _check(q, k, v, true_len, window)
    B, Hq, S, D = q.shape
    dev = q.device
    out = torch.empty_like(q)
    scores = (torch.empty if window else torch.zeros)(
        (B, Hq, S), dtype=torch.float32, device=dev)
    win_ml = torch.empty((B, Hq, max(window, 1), 2), dtype=torch.float32,
                         device=dev)
    with torch.cuda.device(dev):
        code = lib.kvcf_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), true_len.data_ptr(),
            out.data_ptr(), win_ml.data_ptr(), scores.data_ptr(),
            B, Hq, k.shape[1], S, window, D ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "flash_prefill")
    flash_prefill_attention.launches += 1
    return out, scores


flash_prefill_attention.launches = 0


def _check(q, k, v, true_len, window):
    # q, k and v are read with 16-byte vector loads; true_len one int at a time.
    for name, t, align in (("q", q, 16), ("k", k, 16), ("v", v, 16),
                           ("true_len", true_len, 4)):
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
    B, Hq, S, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash_prefill: head_dim must be {HEAD_DIM}, got {D}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D) \
            or Hq % k.shape[1]:
        raise ValueError(f"flash_prefill: k/v shape {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    if true_len.dtype != torch.int32 or true_len.shape != (B,):
        raise ValueError("flash_prefill: true_len must be int32 of shape [B]")
    if not 0 <= window <= MAX_WINDOW:
        raise ValueError(f"flash_prefill: window must be in [0, {MAX_WINDOW}]")


def flash_prefill_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    true_len: torch.Tensor, window: int, q_block: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_prefill_attention`: fp32 logits and
    softmax blocked over q rows, the same window scores.  As in both
    kernels, the unnormalized probabilities ``exp(s - m)`` are rounded to
    the value dtype before the PV product and the result is divided by the
    fp32 row sum afterwards."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    dev = q.device
    tl = true_len.to(device=dev, dtype=torch.int64)
    qg = q.reshape(B, Hkv, G, S, D)
    kf, vf = k.float(), v.float()
    cols = torch.arange(S, device=dev)
    scores = torch.zeros((B, Hkv, G, S), dtype=torch.float32, device=dev)
    outs = []
    for r0 in range(0, S, q_block):
        qblk = qg[:, :, :, r0:r0 + q_block].float()
        rows = r0 + torch.arange(qblk.shape[3], device=dev)
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kf) * D ** -0.5
        lim = torch.minimum(rows[None], tl[:, None] - 1)        # [B, n]
        bad = cols[None, None] > lim[:, :, None]                 # [B, n, S]
        logits = torch.where(bad[:, None, None], NEG_INF, logits)
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vf) / denom
        outs.append(out.to(q.dtype))
        if window:
            in_win = (rows[None] >= tl[:, None] - window) & (rows[None] < tl[:, None])
            if bool(in_win.any()):
                scores += (p / denom * in_win[:, None, None, :, None]).sum(dim=3)
    out = torch.cat(outs, dim=3).reshape(B, Hq, S, D)
    return out, scores.reshape(B, Hq, S)
