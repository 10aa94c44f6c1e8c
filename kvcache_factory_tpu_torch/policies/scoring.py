"""Observation-window scoring primitives for prefill-time KV compression.

Port of ``kvcache_factory_tpu/policies/scoring.py``: softmax(QK^T/sqrt(d))
in fp32 with a causal mask on the trailing window block, column-reduced over
the observation window, then 1-D pooled.  Shapes are static: the prompt may
be right-padded to a bucket length ``S``; ``true_len`` carries the real
length and every mask derives from it.

Pooling calls ``torch.nn.functional.{avg,max}_pool1d`` themselves, which are
the semantics the reference uses (pyramidkv_utils.py:328-333): avg-pool pads
with zeros that are counted (``count_include_pad=True``), max-pool pads with
-inf.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF


def pool1d(scores: torch.Tensor, kernel_size: int, pooling: str) -> torch.Tensor:
    """1-D pooling over the last axis, stride 1, padding ``kernel_size // 2``
    (the reference uses odd kernels, 5 and 7, which keep the length)."""
    if kernel_size == 1:
        return scores
    pad = kernel_size // 2
    flat = scores.reshape(-1, 1, scores.shape[-1])
    if pooling == "avgpool":
        out = F.avg_pool1d(flat, kernel_size, stride=1, padding=pad)
    elif pooling == "maxpool":
        out = F.max_pool1d(flat, kernel_size, stride=1, padding=pad)
    else:
        raise ValueError(f"Pooling method not supported: {pooling}")
    return out.reshape(scores.shape[:-1] + (out.shape[-1],))


def window_query_rows(true_len: torch.Tensor, window_size: int, S: int) -> torch.Tensor:
    """The ``window_size`` query rows the window scores read: from
    ``true_len - window_size`` clamped into ``[0, S - window_size]``, as a
    dynamic slice does (the masks use the unclamped start)."""
    start = (true_len.to(torch.int64) - window_size).clamp(0, S - window_size)
    return start + torch.arange(window_size, device=true_len.device)


def window_attention_probs(
    k: torch.Tensor,         # [H, S, D] post-RoPE keys
    q: Optional[torch.Tensor],  # [H, S, D]
    true_len: torch.Tensor,  # 0-d int tensor, actual prompt length (<= S)
    window_size: int,
    *,
    q_win: Optional[torch.Tensor] = None,  # [H, w, D]
) -> torch.Tensor:
    """fp32 softmax attention of the last ``window_size`` queries over all
    keys, causal only inside the trailing window block, padded columns
    masked (pyramidkv_utils.py:317-326).  Returns ``[H, w, S]``.
    ``q_win``, the rows :func:`window_query_rows` names, stands in for
    ``q`` where only those rows are at hand (sequence-parallel prefill)."""
    S, D = k.shape[1], k.shape[2]
    w = window_size
    win_start = true_len.to(torch.int64) - w
    if q_win is None:
        q_win = q.index_select(1, window_query_rows(true_len, w, S))
    scale = 1.0 / float(D) ** 0.5
    logits = torch.einsum("hwd,hsd->hws", q_win.float(), k.float()) * scale
    cols = torch.arange(S, device=k.device)[None]
    rows = torch.arange(w, device=k.device)[:, None]
    in_window_col = cols >= win_start
    causal_bad = in_window_col & (cols - win_start > rows)
    padding_col = cols >= true_len
    logits = torch.where((causal_bad | padding_col)[None], NEG_INF, logits)
    return torch.softmax(logits, dim=-1)


def window_attention_scores(
    k: torch.Tensor,
    q: Optional[torch.Tensor],
    true_len: torch.Tensor,
    window_size: int,
    *,
    reduce: str = "sum",  # "sum" (SnapKV/PyramidKV) | "mean" (AdaKV/HeadKV)
    q_win: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Observation-window column scores ``[H, S]`` fp32; positions
    ``>= true_len - window_size`` are NEG_INF.  ``q_win`` as in
    :func:`window_attention_probs`."""
    S = k.shape[1]
    probs = window_attention_probs(k, q, true_len, window_size, q_win=q_win)
    if reduce == "sum":
        scores = probs.sum(dim=1)
    elif reduce == "mean":
        scores = probs.mean(dim=1)
    else:
        raise ValueError(reduce)
    col_ids = torch.arange(S, device=k.device)[None]
    return torch.where(col_ids >= true_len - window_size, NEG_INF, scores)


def full_attention_scores(
    k: torch.Tensor,         # [H, S, D]
    q: torch.Tensor,         # [H, S_q, D], rows [row0, row0 + S_q) of the prompt
    true_len: torch.Tensor,  # 0-d int tensor
    window_size: int,
    *,
    row_block: int = 256,
    row0: int = 0,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """H2O heavy-hitter scores: column sums of the fp32 softmax over all
    valid query rows (JAX ``full_attention_scores``), with the reference's
    quirk kept: the only causal mask is the trailing window x window block,
    so earlier rows attend to later keys.  Query rows go in blocks of
    ``row_block``, so memory is O(H * row_block * S).  Returns ``[H, S]``
    fp32 with the window and padding columns at NEG_INF.  ``q`` may hold
    only rows ``[row0, row0 + S_q)`` (a sequence-parallel rank's): their
    sums then pass through ``reduce`` (the sum over the ranks that hold
    the other rows) before the masking."""
    H, S_q, D = q.shape
    S = k.shape[1]
    tl = true_len.to(torch.int64)
    win_start = tl - window_size
    scale = 1.0 / float(D) ** 0.5
    kt = k.float().transpose(1, 2)
    cols = torch.arange(S, device=k.device)[None]
    acc = torch.zeros((H, S), dtype=torch.float32, device=k.device)
    for r0 in range(0, S_q, row_block):
        qb = q[:, r0:r0 + row_block].float()
        rows = torch.arange(row0 + r0, row0 + r0 + qb.shape[1], device=k.device)[:, None]
        logits = torch.matmul(qb, kt).mul_(scale)  # [H, rb, S]
        bad = ((rows >= win_start) & (cols >= win_start) & (cols > rows)) | (cols >= tl)
        probs = torch.softmax(logits.masked_fill_(bad, NEG_INF), dim=-1)
        # The column sums over the valid rows, as one product.
        valid = (rows < tl).to(torch.float32).T.expand(H, 1, -1)
        acc += torch.matmul(valid, probs)[:, 0]
    if reduce is not None:
        acc = reduce(acc)
    return torch.where(cols >= win_start, NEG_INF, acc)


def masked_pool(scores: torch.Tensor, valid_upto: torch.Tensor,
                kernel_size: int, pooling: str) -> torch.Tensor:
    """Pool scores whose valid region is ``[0, valid_upto)``: invalid
    positions are pre-filled with the pool's edge padding value (0 for avg,
    -inf for max) so boundary windows match the reference, then re-masked to
    NEG_INF so top-k never selects them."""
    invalid = torch.arange(scores.shape[-1], device=scores.device) >= valid_upto
    fill = 0.0 if pooling == "avgpool" else float("-inf")
    pooled = pool1d(torch.where(invalid, fill, scores), kernel_size, pooling)
    return torch.where(invalid, NEG_INF, pooled)
