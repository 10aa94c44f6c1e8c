"""ThinK query-driven key-channel pruning, in place (port of the in-place
half of ``kvcache_factory_tpu/policies/think.py``).

After token selection, each head's channel saliency ``mean(q[-32:]**2) *
mean(k**2)`` is computed on the packed keys, and the ``int(D * ratio)``
least salient channels are zeroed in every row but the last
``recent_size``.  The decode product over zeroed channels equals the
reference's masked-query product, so decode needs no special case.  The
drop set is the first ``kdrop`` of a stable descending sort of
``-saliency``, the order ``lax.top_k`` gives ties.  With ``think_packed``
the keys stay whole here and :func:`think_channel_keep_idx` gives the kept
channels that ``cache/think_cache.py`` stores.
"""

from __future__ import annotations

import torch

from .base import PackedKV

_QUERY_WINDOW = 32  # the reference's q[..., -32:, :]


def think_saliency(
    k: torch.Tensor,         # [H, C, D] packed keys
    lengths: torch.Tensor,   # [H] valid rows
    q: torch.Tensor,         # [H, S, D] prefill queries
    true_len: torch.Tensor,  # 0-d int
) -> torch.Tensor:
    """Per-head channel saliency over the valid query and key rows, [H, D] fp32."""
    H, C, D = k.shape
    S = q.shape[1]
    w = min(_QUERY_WINDOW, S)
    start = (true_len.to(torch.int64) - w).clamp(0, S - w)
    q_rows = start + torch.arange(w, device=q.device)
    q_win = q.index_select(1, q_rows)
    q_valid = (q_rows < true_len).to(torch.float32)[None, :, None]
    queries_norm = (q_win.float().square() * q_valid).sum(1) / q_valid.sum(1).clamp(min=1.0)
    row_valid = (torch.arange(C, device=k.device)[None] < lengths[:, None]).to(torch.float32)
    keys_norm = (k.float().square() * row_valid[..., None]).sum(1) / \
        row_valid.sum(1, keepdim=True).clamp(min=1.0)
    return queries_norm * keys_norm


def aggregate_queries_per_kv_head(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """Mean of each KV head's query heads, ``[..., Hq, S, D] -> [..., Hkv, S, D]``,
    for the saliency of a grouped cache."""
    *lead, Hq, S, D = q.shape
    return q.reshape(*lead, n_kv_heads, Hq // n_kv_heads, S, D).mean(dim=-3)


def think_drop_channels(saliency: torch.Tensor, kdrop: int) -> torch.Tensor:
    """The ``kdrop`` least salient channels of each head, [H, kdrop], in
    ``lax.top_k(-saliency, kdrop)``'s order."""
    return torch.sort(-saliency, dim=-1, descending=True, stable=True).indices[:, :kdrop]


def think_channel_keep_idx(
    k: torch.Tensor,         # [H, C, D]
    lengths: torch.Tensor,   # [H]
    q: torch.Tensor,         # [H, S, D]
    true_len: torch.Tensor,
    pruning_ratio: float,
) -> torch.Tensor:
    """The ``D - int(D * ratio)`` most salient channels of each head,
    ``[H, Dk]`` int32 ascending: the first ``Dk`` of a stable descending
    sort of the saliency (``lax.top_k``'s order of ties), then sorted."""
    D = k.shape[2]
    dkeep = D - int(D * pruning_ratio)
    saliency = think_saliency(k, lengths, q, true_len)
    keep = torch.sort(saliency, dim=-1, descending=True, stable=True).indices[:, :dkeep]
    return keep.sort(dim=-1).values.to(torch.int32)


def think_prune_channels(
    packed: PackedKV,
    q: torch.Tensor,         # [H, S, D]
    true_len: torch.Tensor,
    pruning_ratio: float,
    recent_size: int,
) -> PackedKV:
    k, v, lengths = packed
    H, C, D = k.shape
    kdrop = int(D * pruning_ratio)
    if kdrop == 0:
        return packed
    drop = think_drop_channels(think_saliency(k, lengths, q, true_len), kdrop)
    keep = torch.ones((H, D), dtype=torch.bool, device=k.device)
    keep.scatter_(1, drop, False)
    prune_row = torch.arange(C, device=k.device)[None] < (lengths[:, None] - recent_size)
    mask = torch.where(prune_row[..., None], keep[:, None, :], True)
    return PackedKV(torch.where(mask, k, torch.zeros((), dtype=k.dtype, device=k.device)),
                    v, lengths)
