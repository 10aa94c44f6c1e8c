"""Static-shape KV selection core (port of ``kvcache_factory_tpu/policies/base.py``).

    select_and_pack(k, v, scores, budget, window, true_len, capacity)
        -> (k_out [H, C, D], v_out [H, C, D], lengths [H])

The packed layout is ``[top-`budget` tokens in score order | window | pad]``
with ``lengths = budget + window``, or the first ``true_len`` tokens on the
reference's no-compress branch (pyramidkv_utils.py:314-315).  Rows past
``lengths[h]`` are unspecified.

Ranking uses ``torch.sort(descending=True, stable=True)``: ``lax.top_k``
puts lower indices first on ties, maxpool makes plateaus of equal scores,
and ``torch.topk`` orders such ties differently.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PackedKV(NamedTuple):
    k: torch.Tensor        # [H, C, D]
    v: torch.Tensor        # [H, C, D]
    lengths: torch.Tensor  # [H] int32 — valid entries per head


def select_and_pack(
    k: torch.Tensor,            # [H, S, D]
    v: torch.Tensor,            # [H, S, D]
    scores: torch.Tensor,       # [H, S] fp32, NEG_INF at unselectable positions
    budget: torch.Tensor,       # [H] int — top-scored past tokens to keep
    window_size: int,
    true_len: torch.Tensor,     # 0-d int tensor
    capacity: int,
    no_compress: torch.Tensor,  # 0-d bool — reference q_len < cap branch
    return_indices: bool = False,
):
    """When ``return_indices``, returns ``(PackedKV, sel_idx [H, C])`` with
    the compressed-branch gather layout (top-budget then window)."""
    H, S, D = k.shape
    C = capacity
    assert C <= S, f"capacity {C} must not exceed source length {S}"
    w = window_size
    dev = k.device
    top_idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :C]
    pos = torch.arange(C, device=dev).expand(H, C)
    budget = budget.to(torch.int64)[:, None]
    true_len = true_len.to(torch.int64)
    win_idx = (true_len - w) + (pos - budget)
    sel_idx = torch.where(pos < budget, top_idx, win_idx.clamp(0, S - 1))
    idx = torch.where(no_compress, pos.clamp(max=S - 1), sel_idx)
    gidx = idx[:, :, None].expand(H, C, D)
    k_out = torch.gather(k, 1, gidx)
    v_out = torch.gather(v, 1, gidx)
    lengths = torch.where(no_compress, true_len.expand(H), budget[:, 0] + w)
    lengths = lengths.clamp(max=C).to(torch.int32)
    packed = PackedKV(k_out, v_out, lengths)
    if return_indices:
        return packed, sel_idx
    return packed
