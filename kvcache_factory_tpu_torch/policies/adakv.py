"""AdaKV cross-head budget allocation (port of
``kvcache_factory_tpu/policies/adakv.py``).

Every head's scores are sorted, optionally weighted by the mass share of
its top ``base`` entries, and a global top-(H * base) over the flattened
``[H * S]`` scores counts the hits per head; a head's budget is
``round(count * (1 - floor_ratio) + floor_capacity)``.  The global ranking
is a stable descending sort, so ties go to the lower flat index first, as
``lax.top_k`` orders them (``torch.topk`` does not).
"""

from __future__ import annotations

import torch

from ..ops.attention import NEG_INF


def adakv_budgets(
    scores: torch.Tensor,      # [H, S] fp32, NEG_INF at invalid positions
    base_capacity: int,        # max_capacity_prompt - window
    floor_ratio: float,
    normalize: bool,
    n_valid: torch.Tensor,     # 0-d int: true_len - window
    max_budget: int,           # capacity - window
) -> torch.Tensor:
    """Per-head budgets [H] int64 that sum, before flooring and clamping, to
    H * base."""
    H, S = scores.shape
    sorted_scores = torch.sort(scores, dim=-1, descending=True).values
    pos = torch.arange(S, device=scores.device)[None]
    valid = pos < n_valid
    sorted_valid = torch.where(valid, sorted_scores, 0.0)
    adaptive = sorted_valid
    if normalize:
        top_mass = torch.where(pos < base_capacity, sorted_valid, 0.0).sum(-1, keepdim=True)
        total_mass = sorted_valid.sum(-1, keepdim=True)
        adaptive = adaptive * (top_mass / total_mass.clamp(min=1e-30))
    flat = torch.where(valid, adaptive, NEG_INF).reshape(H * S)
    top = torch.sort(flat, descending=True, stable=True).indices[:H * base_capacity]
    # Hits per head; a scatter, as bincount would read its size on the host.
    counts = torch.zeros(H, dtype=torch.float32, device=scores.device).index_add_(
        0, top // S, torch.ones_like(top, dtype=torch.float32))
    floor_capacity = int(base_capacity * floor_ratio)
    budgets = torch.round(counts * (1.0 - floor_ratio) + floor_capacity).to(torch.int64)
    upper = torch.clamp(n_valid.to(torch.int64), max=max_budget)
    return torch.minimum(budgets.clamp(min=0), upper)
