"""Prefill-time KV compression dispatcher (port of
``kvcache_factory_tpu/policies/methods.py``).

The port carries the ``snapkv``, ``fullkv`` and ``minference`` branches of
the shared ``score -> budget -> select_and_pack`` pipeline (``minference``
is sparse prefill attention only and keeps the full cache, as fullkv
does).  Every other method raises
``NotImplementedError`` naming its ROADMAP.md item; none falls back to
snapkv.

Reference semantics kept: compression runs after repeat_kv, per *query*
head (llama_model.py:158-167), reproduced by ``group_reduce="none"``; the
no-compress branch is a strict ``q_len < max_capacity_prompt``
(pyramidkv_utils.py:314).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import CompressionConfig
from .base import PackedKV, select_and_pack
from .scoring import masked_pool, window_attention_scores

# Methods queued in ROADMAP.md queue 1 item 7 (remaining policies).
_NOT_PORTED = ("pyramidkv", "h2o", "streamingllm", "l2norm",
               "cam", "adakv", "headkv", "think", "random")


class LayerContext(NamedTuple):
    """Per-layer inputs of one compression call.  The JAX context's
    ``head_capacity`` and ``rng`` come with the methods that read them
    (HeadKV, CAM, random)."""

    layer_idx: int
    # Observation-window column sums emitted by the flash prefill kernel
    # ([H_q, S], NEG_INF-masked at >= true_len - window); when present the
    # policy skips its own scoring matmul.
    window_scores: Optional[torch.Tensor] = None


def _repeat_heads(x: torch.Tensor, groups: int) -> torch.Tensor:
    """GQA repeat_kv: [H_kv, S, D] -> [H_kv * G, S, D]."""
    if groups == 1:
        return x
    return x.repeat_interleave(groups, dim=0)


def _reduce_groups(scores: torch.Tensor, groups: int, mode: str) -> torch.Tensor:
    """[H_q, S] query-head scores -> selection scores ([H_q,S] or [H_kv,S])."""
    if mode == "none" or groups == 1:
        return scores
    Hq, S = scores.shape
    g = scores.reshape(Hq // groups, groups, S)
    if mode == "mean":
        return g.mean(dim=1)
    if mode == "max":
        return g.amax(dim=1)
    if mode == "sum":
        return g.sum(dim=1)
    raise ValueError(mode)


def compress_layer(
    cfg: CompressionConfig,
    num_layers: int,
    capacity: int,
    k: torch.Tensor,         # [H_kv, S, D] post-RoPE keys
    v: torch.Tensor,         # [H_kv, S, D]
    q: torch.Tensor,         # [H_q, S, D] (only its head count is read when
                             # ctx.window_scores is given)
    true_len: torch.Tensor,  # 0-d int tensor
    ctx: LayerContext,
) -> PackedKV:
    """Compress one example's layer KV.  Output heads: H_q for
    ``group_reduce='none'`` (reference parity), else H_kv."""
    Hkv, S, D = k.shape
    groups = q.shape[0] // Hkv
    w = cfg.window_size
    C = capacity
    method = cfg.method

    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"compression method {method!r} is not ported yet (ROADMAP.md "
            f"queue 1 item 7: remaining policies)")
    if cfg.merge is not None:
        raise NotImplementedError(
            "LOOK-M pivot merge is not ported yet (ROADMAP.md queue 1 item 7)")

    if method in ("fullkv", "minference"):
        # The uncompressed cache stays at the KV heads (minference changes
        # only the prefill attention; the reference retains the full cache,
        # pyramidkv/minference.py:49-59).
        lens = torch.clamp(true_len, max=C).to(torch.int32).expand(Hkv)
        return PackedKV(k[:, :C], v[:, :C], lens)

    # snapkv
    per_query_cache = cfg.group_reduce == "none"
    k_sel = _repeat_heads(k, groups) if per_query_cache else k
    v_sel = _repeat_heads(v, groups) if per_query_cache else v
    H_out = k_sel.shape[0]
    no_compress = true_len < cfg.max_capacity_prompt
    if ctx.window_scores is not None:
        raw = ctx.window_scores
    else:
        raw = window_attention_scores(_repeat_heads(k, groups), q, true_len, w,
                                      reduce="sum")
    raw = _reduce_groups(raw, groups, cfg.group_reduce)
    scores = masked_pool(raw, true_len - w, cfg.kernel_size, cfg.pooling)
    budget = torch.full((H_out,), cfg.base_capacity, dtype=torch.int64,
                        device=k.device)
    budget = torch.minimum(budget, torch.clamp(true_len - w, min=0))
    return select_and_pack(k_sel, v_sel, scores, budget, w, true_len, C,
                           no_compress)


def compress_prefill(
    cfg: CompressionConfig,
    num_layers: int,
    capacity: int,
    k: torch.Tensor,         # [B, H_kv, S, D]
    v: torch.Tensor,
    q: torch.Tensor,         # [B, H_q, S, D]
    true_len: torch.Tensor,  # [B]
    ctx: LayerContext,
) -> PackedKV:
    """Batched form: :func:`compress_layer` per example, stacked over B."""
    outs = []
    for b in range(k.shape[0]):
        ws = None if ctx.window_scores is None else ctx.window_scores[b]
        c = LayerContext(ctx.layer_idx, ws)
        outs.append(compress_layer(cfg, num_layers, capacity, k[b], v[b], q[b],
                                   true_len[b], c))
    return PackedKV(*(torch.stack(parts) for parts in zip(*outs)))
