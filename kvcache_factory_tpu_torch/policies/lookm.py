"""LOOK-M pivot merging of evicted KV into the retained cache (port of
``kvcache_factory_tpu/policies/lookm.py``).

Each dropped position is cosine-matched to its nearest retained slot, and
the slot becomes the mean of its own entry and ``(dropped + slot) / 2`` of
every position routed to it (a scatter-mean through ``index_add_``).  As in
the JAX package, and unlike the reference, K and V are merged in the same
packed order ``[selected..., window...]``, so K/V pairs stay aligned.
Every source position computes its pivot; retained and padding positions
are left out of the mean.
"""

from __future__ import annotations

import torch

from .base import PackedKV


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + 1e-12)


def lookm_pivot_merge(
    packed: PackedKV,
    gather_idx: torch.Tensor,  # [H, C] source positions packed into the cache
    k_full: torch.Tensor,      # [H, S, D] uncompressed keys
    v_full: torch.Tensor,      # [H, S, D]
    true_len: torch.Tensor,    # 0-d int
) -> PackedKV:
    k_ret, v_ret, lengths = packed
    H, C, D = k_ret.shape
    S = k_full.shape[1]
    dev = k_ret.device
    slot_valid = torch.arange(C, device=dev)[None] < lengths[:, None]  # [H, C]
    kept = torch.zeros((H, S), dtype=torch.int32, device=dev)
    kept.scatter_add_(1, gather_idx.to(torch.int64), slot_valid.to(torch.int32))
    dropped = (kept == 0) & (torch.arange(S, device=dev)[None] < true_len)  # [H, S]

    kf, vf = k_full.float(), v_full.float()
    kr, vr = k_ret.float(), v_ret.float()
    sim = torch.matmul(_unit(kf), _unit(kr).transpose(1, 2))  # [H, S, C]
    sim = torch.where(slot_valid[:, None, :], sim, float("-inf"))
    pivot = sim.argmax(dim=-1)  # [H, S], first slot on ties
    del sim
    gather = pivot[..., None].expand(H, S, D)
    merged_k = (kf + torch.gather(kr, 1, gather)) / 2
    merged_v = (vf + torch.gather(vr, 1, gather)) / 2

    # Scatter-mean over the flattened (head, slot) index; non-dropped
    # positions go to an overflow slot C.
    seg = torch.where(dropped, pivot, C) + torch.arange(H, device=dev)[:, None] * (C + 1)
    seg = seg.reshape(H * S)
    dmask = dropped.to(torch.float32)[..., None]

    def seg_sum(x):
        out = torch.zeros((H * (C + 1), x.shape[-1]), dtype=torch.float32, device=dev)
        out.index_add_(0, seg, x.reshape(H * S, -1))
        return out.reshape(H, C + 1, -1)[:, :C]

    sums_k, sums_v = seg_sum(merged_k * dmask), seg_sum(merged_v * dmask)
    denom = seg_sum(dmask) + 1.0
    return PackedKV(((kr + sums_k) / denom).to(k_ret.dtype),
                    ((vr + sums_v) / denom).to(v_ret.dtype), lengths)
