"""Prefill-time KV compression dispatcher (port of
``kvcache_factory_tpu/policies/methods.py``).

Every method of the JAX package shares one ``score -> budget ->
select_and_pack`` pipeline: snapkv, pyramidkv, think (in-place channel
pruning), adakv and headkv (window-attention scores, the last two with
per-head budgets), h2o (full-attention scores), cam (window scores with
merged values), streamingllm (sinks), l2norm (smallest key norms, no
window) and random; the LOOK-M pivot merge (``merge="pivot"``) folds the
dropped entries of snapkv, pyramidkv, h2o and streamingllm into the kept
ones.  fullkv and minference keep the full cache (minference changes only
the prefill attention).

Reference semantics kept: compression runs after repeat_kv, per *query*
head (llama_model.py:158-167), reproduced by ``group_reduce="none"``; the
no-compress branch is a strict ``q_len < max_capacity_prompt``
(pyramidkv_utils.py:314).

Random draws (cam's Bernoulli uniforms, random's scores) come from a
``torch.Generator`` through :func:`uniform_draw`, one draw per layer and
example in that order, in the shapes JAX draws; they cannot equal
``jax.random``'s, so the tests substitute JAX's draws for that function.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import CompressionConfig
from .adakv import adakv_budgets
from .base import PackedKV, select_and_pack
from .cam import cam_merge_values
from .lookm import lookm_pivot_merge
from .scoring import (NEG_INF, full_attention_scores, masked_pool, window_attention_probs,
                      window_attention_scores)
from .think import aggregate_queries_per_kv_head, think_prune_channels

# Methods whose scores are sums of the window rows' softmax, which K1 emits
# (JAX ``scores_reusable``, models/llama.py:388-389).
SCORES_REUSABLE = ("snapkv", "pyramidkv", "think", "adakv", "headkv")
_PIVOT_MERGED = ("snapkv", "pyramidkv", "h2o", "streamingllm")


class HeadShard(NamedTuple):
    """Where one rank's ``[B, H]`` tile lies in a data- and
    tensor-parallel prefill (``parallel/mesh.py``), for the rules that are
    not local to a tile: cam's and random's draws, made at the whole
    batch's and model's shape on every rank and sliced, and AdaKV's budgets,
    ranked over every head of a layer."""

    b0: int     # this rank's first example
    batch: int  # examples in the whole batch
    q0: int     # this rank's first query head
    n_q: int    # query heads of the whole model
    n_kv: int   # KV heads of the whole model
    # [H_loc, ...] -> [tp, H_loc, ...]: every tp rank's tensor in head
    # order (None with one tp rank).
    gather: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def cache_head_offset(self, cfg: CompressionConfig) -> int:
        """The first of this rank's cache heads: its first query head on a
        per-query-head cache, else the KV head it reads first."""
        if cfg.cache_heads(self.n_q, self.n_kv) == self.n_q:
            return self.q0
        return self.q0 // (self.n_q // self.n_kv)


class LayerContext(NamedTuple):
    """Per-layer inputs of one compression call."""

    layer_idx: int
    # [H] int per-head budgets of this layer (headkv).
    head_capacity: Optional[torch.Tensor] = None
    # cam and random: a torch.Generator for compress_prefill, which hands
    # compress_layer the example's own draw in its place (cam [S, H_q],
    # random [H_out, S]).
    rng: Optional[object] = None
    # Observation-window column sums emitted by the flash prefill kernel
    # ([H_q, S], NEG_INF-masked at >= true_len - window); when present the
    # policy skips its own scoring matmul.
    window_scores: Optional[torch.Tensor] = None
    # This rank's tile under data or tensor parallelism (None: the whole
    # batch and every head).
    shard: Optional[HeadShard] = None
    # h2o's column sums over every query row ([H_q, S], NEG_INF-masked),
    # computed by the caller where no rank holds every row (sequence
    # parallelism); when present h2o skips its own scoring.
    full_scores: Optional[torch.Tensor] = None


def uniform_draw(rng: torch.Generator, layer_idx: int, example: int,
                 shape: Tuple[int, ...]) -> torch.Tensor:
    """One example's uniforms in [0, 1), fp32, on the generator's device.
    :func:`compress_prefill` calls it for every layer, then every example,
    looking it up as a module global at each call."""
    return torch.rand(shape, generator=rng, device=rng.device)


def draw_shape(cfg: CompressionConfig, n_q_heads: int, n_kv_heads: int,
               S: int) -> Optional[Tuple[int, int]]:
    """The shape of one example's draw, as JAX draws it: cam ``[S, H_q]``,
    random ``[H_out, S]``; None for a method that draws nothing."""
    if cfg.method == "cam":
        return (S, n_q_heads)
    if cfg.method == "random":
        return (cfg.cache_heads(n_q_heads, n_kv_heads), S)
    return None


def pyramid_budget(cfg: CompressionConfig, num_layers: int, layer_idx: int,
                   true_len: torch.Tensor) -> torch.Tensor:
    """PyramidKV's per-layer budget (pyramidkv_utils.py:205-215):
    ``min_num = base // beta``, ``max_num = 2 * base - min_num`` clamped to
    ``q_len - w``, layer budget ``max_num - layer_idx * steps``; below
    ``2 * base`` tokens, the uniform SnapKV budget ``base`` (:220, 238).
    Floor division, as ``jnp //``."""
    base, w = cfg.base_capacity, cfg.window_size
    tl = true_len.to(torch.int64)
    min_num, max_num = base // cfg.beta, base * 2 - base // cfg.beta
    clamp = tl - w <= max_num
    max_num_c = torch.where(clamp, tl - w, max_num)
    min_num_c = torch.where(clamp, base * 2 - max_num_c, min_num)
    steps = torch.div(max_num_c - min_num_c, max(num_layers - 1, 1), rounding_mode="floor")
    budget = torch.where(tl < 2 * base, base, max_num_c - layer_idx * steps)
    return torch.minimum(budget.clamp(min=0), (tl - w).clamp(min=0))


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
    q: torch.Tensor,         # [H_q, S, D] (with ctx.window_scores, only its
                             # head count is read, and think's last rows;
                             # with ctx.full_scores only its head count)
    true_len: torch.Tensor,  # 0-d int tensor
    ctx: LayerContext,
) -> PackedKV:
    """Compress one example's layer KV.  Output heads: H_q for
    ``group_reduce='none'`` (reference parity), else H_kv.  ``ctx.rng`` is
    the example's draw (see :class:`LayerContext`)."""
    Hkv, S, D = k.shape
    Hq = q.shape[0]
    groups = Hq // Hkv
    w = cfg.window_size
    C = capacity
    method = cfg.method
    dev = k.device

    if method in ("fullkv", "minference"):
        # The uncompressed cache stays at the KV heads (minference changes
        # only the prefill attention; the reference retains the full cache,
        # pyramidkv/minference.py:49-59).
        lens = torch.clamp(true_len, max=C).to(torch.int32).expand(Hkv)
        return PackedKV(k[:, :C], v[:, :C], lens)

    per_query_cache = cfg.group_reduce == "none"
    k_sel = _repeat_heads(k, groups) if per_query_cache else k
    v_sel = _repeat_heads(v, groups) if per_query_cache else v
    H_out = k_sel.shape[0]
    no_compress = true_len < cfg.max_capacity_prompt
    cols = torch.arange(S, device=dev).expand(H_out, S)

    def uniform_budget(n):
        return torch.full((H_out,), n, dtype=torch.int64, device=dev)

    def window_scores(reduce):
        if ctx.window_scores is not None:
            return ctx.window_scores if reduce == "sum" else ctx.window_scores / w
        return window_attention_scores(_repeat_heads(k, groups), q, true_len, w,
                                       reduce=reduce)

    if method in ("snapkv", "pyramidkv", "think"):
        raw = _reduce_groups(window_scores("sum"), groups, cfg.group_reduce)
        scores = masked_pool(raw, true_len - w, cfg.kernel_size, cfg.pooling)
        if method == "pyramidkv":
            budget = pyramid_budget(cfg, num_layers, ctx.layer_idx, true_len).expand(H_out)
        else:
            budget = uniform_budget(cfg.base_capacity)

    elif method in ("adakv", "headkv"):
        raw = _reduce_groups(window_scores("mean"), groups, cfg.group_reduce)
        scores = masked_pool(raw, true_len - w, cfg.kernel_size, cfg.pooling)
        if method == "adakv":
            # A global top over every head of the layer: under tp each rank
            # ranks every head's scores the same way and keeps its slice.
            every = scores
            if ctx.shard is not None and ctx.shard.gather is not None:
                every = ctx.shard.gather(scores).reshape(-1, S)
            budget = adakv_budgets(every, cfg.base_capacity, cfg.floor_ratio,
                                   cfg.normalize, true_len - w, C - w)
            if every is not scores:
                h0 = ctx.shard.cache_head_offset(cfg)
                budget = budget[h0:h0 + H_out]
        else:
            if ctx.head_capacity is None:
                raise ValueError("headkv requires per-head capacities (head_capacity)")
            upper = torch.clamp(true_len.to(torch.int64) - w, max=C - w)
            budget = torch.minimum(ctx.head_capacity.to(torch.int64).clamp(min=0), upper)

    elif method == "h2o":
        raw = ctx.full_scores
        if raw is None:
            raw = full_attention_scores(_repeat_heads(k, groups), q, true_len, w)
        scores = _reduce_groups(raw, groups, cfg.group_reduce)
        budget = uniform_budget(cfg.base_capacity)

    elif method == "cam":
        if ctx.rng is None:
            raise ValueError("cam requires its uniform draws (ctx.rng)")
        probs = window_attention_probs(_repeat_heads(k, groups), q, true_len, w)  # [H_q, w, S]
        vm = cam_merge_values(_repeat_heads(v, groups), probs.mean(dim=1), true_len,
                              cfg.start_budget_ratio, w, ctx.rng)
        if not per_query_cache:
            vm = vm.reshape(Hkv, groups, S, D).mean(dim=1)
        # The reference's no-compress branch returns the KV untouched
        # (pyramidkv_utils.py:450-455): merging must not reach short prompts.
        v_sel = torch.where(no_compress, v_sel, vm)
        reduced = _reduce_groups(probs.sum(dim=1), groups, cfg.group_reduce)
        scores = torch.where(cols >= true_len - w, NEG_INF, reduced)
        budget = uniform_budget(cfg.base_capacity)

    elif method == "streamingllm":
        # The first (cap - w) positions (attention sinks) and the window
        # (pyramidkv_utils.py:607-620): score = -position selects them in order.
        scores = torch.where(cols >= true_len - w, NEG_INF, -cols.to(torch.float32))
        budget = uniform_budget(cfg.base_capacity)

    elif method == "l2norm":
        # The max_capacity_prompt smallest-key-norm tokens, no window
        # carve-out (pyramidkv_utils.py:405-429); skip_layers keep everything.
        norms = k_sel.float().square().sum(-1).sqrt()
        scores = torch.where(cols >= true_len, NEG_INF, -norms)
        if ctx.layer_idx in cfg.skip_layers:
            no_compress = torch.ones_like(no_compress)
        return select_and_pack(k_sel, v_sel, scores, uniform_budget(cfg.max_capacity_prompt),
                               0, true_len, C, no_compress)

    elif method == "random":
        if ctx.rng is None:
            raise ValueError("random requires its uniform draws (ctx.rng)")
        scores = torch.where(cols >= true_len - w, NEG_INF, ctx.rng)
        budget = uniform_budget(cfg.base_capacity)

    else:
        raise ValueError(f"unknown method {method}")

    budget = torch.minimum(budget, torch.clamp(true_len.to(torch.int64) - w, min=0))
    packed, gidx = select_and_pack(k_sel, v_sel, scores, budget, w, true_len, C,
                                   no_compress, return_indices=True)

    # The merge and the pruning leave the no-compress branch as it is, chosen
    # on the device (JAX's lax.cond) so that no host read waits for it.
    if cfg.merge == "pivot" and method in _PIVOT_MERGED:
        # gidx is the compressed branch's gather layout select_and_pack used.
        packed = _unless(no_compress, packed,
                         lookm_pivot_merge(packed, gidx, k_sel, v_sel, true_len))

    if method == "think" and not cfg.think_packed:
        q_for_prune = q if per_query_cache else aggregate_queries_per_kv_head(q, Hkv)
        packed = _unless(no_compress, packed, think_prune_channels(
            packed, q_for_prune, true_len, cfg.pruning_ratio, cfg.recent_size))
    return packed


def _unless(no_compress: torch.Tensor, packed: PackedKV, changed: PackedKV) -> PackedKV:
    return PackedKV(torch.where(no_compress, packed.k, changed.k),
                    torch.where(no_compress, packed.v, changed.v), packed.lengths)


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
    """Batched form: :func:`compress_layer` per example, stacked over B.
    Each example gets the layer's ``head_capacity`` row and, for cam and
    random, its own draw from the generator ``ctx.rng``, as JAX's ``vmap``
    splits the layer's key over the batch.  With ``ctx.shard`` the ``B``
    examples and the heads of ``k``, ``v`` and ``q`` are one rank's tile:
    every example of the whole batch is drawn at the whole model's shape,
    in order, and the tile's part of its own examples' draws is kept, so
    that the ranks select what one device selects."""
    B, Hkv, S, _ = k.shape
    sh = ctx.shard
    shape = (draw_shape(cfg, q.shape[1], Hkv, S) if sh is None
             else draw_shape(cfg, sh.n_q, sh.n_kv, S))
    if shape is not None and ctx.rng is None:
        raise ValueError(f"{cfg.method} requires a torch.Generator (ctx.rng)")
    b0, batch = (0, B) if sh is None else (sh.b0, sh.batch)
    draws = [None] * B
    if shape is not None:
        for b in range(batch):
            d = uniform_draw(ctx.rng, ctx.layer_idx, b, shape)
            if b0 <= b < b0 + B:
                draws[b - b0] = d if sh is None else _draw_tile(cfg, d, q.shape[1], Hkv, sh)
    outs = []
    for b in range(B):
        ws = None if ctx.window_scores is None else ctx.window_scores[b]
        fs = None if ctx.full_scores is None else ctx.full_scores[b]
        c = LayerContext(ctx.layer_idx, ctx.head_capacity, draws[b], ws, sh, fs)
        outs.append(compress_layer(cfg, num_layers, capacity, k[b], v[b], q[b],
                                   true_len[b], c))
    return PackedKV(*(torch.stack(parts) for parts in zip(*outs)))


def _draw_tile(cfg: CompressionConfig, draw: torch.Tensor, n_q: int, n_kv: int,
               sh: HeadShard) -> torch.Tensor:
    """One rank's heads of a whole-model draw: cam's ``[S, H_q]`` columns,
    random's ``[H_out, S]`` rows."""
    if cfg.method == "cam":
        return draw[:, sh.q0:sh.q0 + n_q]
    h0 = sh.cache_head_offset(cfg)
    return draw[h0:h0 + cfg.cache_heads(n_q, n_kv)]
