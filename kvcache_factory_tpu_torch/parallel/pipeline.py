"""GPipe pipeline parallelism over the ranks of a ``torch.distributed``
group (port of ``kvcache_factory_tpu/parallel/pipeline.py``).

Rank ``s`` of ``P`` is stage ``s``: it holds ``L / P`` contiguous layers
(:func:`shard_params_pp`), the embedding on stage 0 and ``final_norm`` /
``lm_head`` on the last stage.  Microbatches flow stage to stage on the
GPipe schedule: at tick ``t`` stage ``s`` runs microbatch ``t - s``, then
sends its output to stage ``s + 1`` (:meth:`~.mesh.StagedGroup.exchange`,
the counterpart of JAX's ``ppermute``; only the pairs that move a
microbatch exchange).  JAX runs one program over a mesh axis; here every
rank runs its own stage, on the same schedule.

* :func:`pipeline_forward`: the full-attention forward to last-token
  logits, ``M + P - 1`` ticks.
* :func:`pp_generate`: the whole greedy generation under pp.  Prefill on
  the GPipe schedule runs each layer's compression hook into the stage's
  own cache slab (the cache never leaves its stage); decode tick ``tau``
  runs microbatch ``(tau - s) % M`` at token step ``(tau - s) // M + 1``,
  and the last stage's token returns to stage 0, which consumes it
  ``M - P + 1`` ticks later (``M >= P``).

On the card a stage runs K1 for its layers' prefill attention and K2 over
its slab in decode, where JAX computes the same values in XLA
(``blocked_causal_attention``, ``grouped_attention``).  JAX's scope holds:
the dense cache only, no sliding window in generation; prefill attention
is dense (JAX's pp prefill applies no MInference pattern).  Decoding is
greedy; the engine trims at EOS afterwards (``runtime/engine.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..cache.kv_cache import KVCache
from ..config import CompressionConfig, EngineConfig, ModelConfig, dtype_of
from ..models import llama
from ..policies import methods
from ..policies.methods import HeadShard, LayerContext, compress_prefill, draw_shape
from .mesh import StagedGroup, _cat, _take


def stage_layers(cfg: ModelConfig, pp: int, stage: int) -> Tuple[int, int]:
    """Stage ``stage``'s first global layer and its layer count ``L / pp``."""
    L = cfg.num_hidden_layers
    if L % pp:
        raise ValueError(f"layers {L} must divide over {pp} stages")
    return stage * (L // pp), L // pp


def shard_params_pp(params: Dict[str, Any], cfg: ModelConfig, pp: int,
                    stage: int) -> Dict[str, Any]:
    """Stage ``stage``'s part of a weight tree (torch tensors or numpy
    arrays): its ``L / pp`` contiguous layers of every layer leaf (a W8A16
    leaf's ``q`` and ``s`` alike), the embedding on stage 0, and
    ``final_norm`` and ``lm_head`` on the last stage.  The layer slices
    own their memory, so the whole tree can be freed."""
    l0, n = stage_layers(cfg, pp, stage)

    def layers(x):
        if isinstance(x, dict):
            return {k: layers(v) for k, v in x.items()}
        return _cat([_take(x, 0, l0, l0 + n)], 0)

    out = {"layers": {k: layers(v) for k, v in params["layers"].items()}}
    if stage == 0:
        out["embed"] = params["embed"]
    if stage == pp - 1:
        out["final_norm"], out["lm_head"] = params["final_norm"], params["lm_head"]
    return out


def check_pp(cfg: EngineConfig) -> None:
    """JAX's pp scope as ``ValueError`` (assertions there,
    ``runtime/engine.py:58-61``, ``parallel/pipeline.py:247-255``): the
    dense cache only (no quant, ``decode_evict`` or ``think_packed``), no
    sliding window, layers that divide over the stages."""
    if (cfg.quant is not None or cfg.compression.decode_evict
            or cfg.compression.think_packed):
        raise ValueError("pp composes with the dense cache only (no quant / decode_evict / "
                         "think_packed: those stay on (dp, tp))")
    if cfg.model.sliding_window is not None:
        raise ValueError("pp_generate: no sliding-window support")
    stage_layers(cfg.model, cfg.sharding.pp, 0)


class PipelineResult(NamedTuple):
    tokens: torch.Tensor            # [B, N] greedy ids, on every stage
    cache: KVCache                  # this stage's slab [L / P, B, H, C, D]
    logits: Optional[torch.Tensor]  # [B, N, V] fp32 the ids were chosen from, when asked


def _last_logits(h: torch.Tensor, params: dict, cfg: ModelConfig,
                 true_len: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``[mb, V]`` at each sequence's last valid row of ``h``."""
    last = (true_len.to(torch.int64) - 1).clamp(min=0)
    x = llama.rms_norm(h[torch.arange(h.shape[0], device=h.device), last],
                       params["final_norm"], cfg.rms_norm_eps)
    return llama.lm_logits(x, params)


def _from_last(group: StagedGroup, t: Optional[torch.Tensor], shape, dtype, device):
    """The last stage's ``t`` on every stage (one exchange)."""
    P, s = group.size, group.rank
    if s == P - 1:
        group.exchange([(t, r) for r in range(P - 1)], [])
        return t
    return group.exchange([], [(tuple(shape), dtype, P - 1)], device=device)[0]


@torch.no_grad()
def pipeline_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                     true_len: torch.Tensor, group: StagedGroup, *,
                     n_microbatches: int) -> torch.Tensor:
    """Last-token logits ``[B, V]`` fp32 of a full-attention forward on
    the GPipe schedule (JAX ``:64-193``), on every stage.  ``params`` is
    this stage's part (:func:`shard_params_pp`); ``tokens`` ``[B, S]``
    right-padded, the same on every stage; ``B`` divides into
    ``n_microbatches``.  Each layer's attention is K1 over the whole
    prompt (with the model's sliding window, as JAX passes it)."""
    s, P, M = group.rank, group.size, n_microbatches
    B, S = tokens.shape
    if M < 1 or B % M:
        raise ValueError(f"batch {B} must divide into {M} microbatches")
    mb, dev, dtype = B // M, tokens.device, dtype_of(cfg)
    true_len = true_len.to(device=dev, dtype=torch.int32)
    cos, sin = llama.rope_tables(cfg, S, dev)
    logits = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=dev)
    recv = None
    for t in range(M + P - 1):
        m = t - s
        h = None
        if 0 <= m < M:
            rows = slice(m * mb, (m + 1) * mb)
            x = params["embed"][tokens[rows]].to(dtype) if s == 0 else recv
            for li in range(llama.wshape(params["layers"]["qkv_proj"])[0]):
                lp = llama._layer(params, li)
                q, k, v = (a.contiguous() for a in llama._qkv(x, lp, cfg, cos, sin))
                attn, _ = llama.flash_prefill_attention(q, k, v, true_len[rows], 0,
                                                        sliding_window=cfg.sliding_window)
                x = llama._finish_layer(x, attn, lp, cfg)
            h = x
            if s == P - 1:
                logits[rows] = _last_logits(h, params, cfg, true_len[rows])
        sends = [(h, s + 1)] if h is not None and s < P - 1 else []
        recvs = ([((mb, S, cfg.hidden_size), dtype, s - 1)]
                 if s > 0 and 0 <= t - (s - 1) < M else [])
        got = group.exchange(sends, recvs, device=dev)
        recv = got[0] if got else None
    return _from_last(group, logits, logits.shape, logits.dtype, dev)


def _rows(cache: KVCache, rows: slice) -> KVCache:
    """A microbatch's rows of a stage slab, as views (writes reach the slab)."""
    return KVCache(cache.k[:, rows], cache.v[:, rows], cache.lengths[:, rows],
                   cache.positions[rows])


def _layer_draw_states(rng: torch.Generator, comp: CompressionConfig, cfg: ModelConfig,
                       B: int, S: int, l0: int, n: int) -> List[Any]:
    """The generator's state at the start of each of the stage's global
    layers ``[l0, l0 + n)`` as one device's prefill leaves it: every
    earlier layer's draws (layer, then example) replayed from its state at
    entry, as ``compress_prefill`` draws them."""
    shape = draw_shape(comp, cfg.num_attention_heads, cfg.num_key_value_heads, S)
    states = []
    for gl in range(l0 + n):
        if gl >= l0:
            states.append(rng.get_state())
        for b in range(B):
            methods.uniform_draw(rng, gl, b, shape)
    return states


@torch.no_grad()
def pp_generate(params: dict, cfg: ModelConfig, comp: CompressionConfig, tokens: torch.Tensor,
                true_len: torch.Tensor, group: StagedGroup, *, n_microbatches: int,
                max_new_tokens: int, cache_capacity: int = 0,
                head_capacity: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None,
                return_logits: bool = False) -> PipelineResult:
    """Greedy generation ``[B, max_new_tokens]`` under pipeline parallelism
    (JAX ``:195-474``): the compression-hooked prefill on the GPipe
    schedule into each stage's slab, then pipelined decode, the tokens
    returning from the last stage to stage 0.  ``params`` is this stage's
    part (:func:`shard_params_pp`); ``tokens`` and ``true_len`` the whole
    batch on every stage.  ``cache_capacity`` 0 means the policy's
    capacity plus ``max_new_tokens + 1``.  cam and random draw per global
    layer and example from ``rng`` (seeded 0 when None) exactly as one
    device's prefill does, each microbatch keeping its examples' draws;
    headkv reads ``head_capacity[layer]`` (``[L, H]``, zeros when None, as
    JAX).  Returns the ids on every stage, this stage's cache slab and,
    with ``return_logits``, the last stage's fp32 logits ``[B, N, V]``
    on every stage."""
    s, P, M = group.rank, group.size, n_microbatches
    B, S = tokens.shape
    L, N = cfg.num_hidden_layers, max_new_tokens
    if M < 1 or B % M:
        raise ValueError(f"batch {B} must divide into {M} microbatches")
    if M < P:
        raise ValueError(f"pipelined decode needs n_microbatches {M} >= stages {P}")
    if cfg.sliding_window is not None:
        raise ValueError("pp_generate: no sliding-window support")
    if N < 1:
        raise ValueError("max_new_tokens must be >= 1")
    l0, Lp = stage_layers(cfg, P, s)
    mb, dev, dtype = B // M, tokens.device, dtype_of(cfg)
    tokens = tokens.to(torch.int64)
    true_len = true_len.to(device=dev, dtype=torch.int32)
    policy_capacity = comp.layer_capacity(L, S)
    C = cache_capacity or (policy_capacity + N + 1)
    if C < policy_capacity + N - 1:
        raise ValueError(f"cache_capacity {C} < policy capacity {policy_capacity} + "
                         f"{N - 1} decode appends")
    H = comp.cache_heads(cfg.num_attention_heads, cfg.num_key_value_heads)
    if head_capacity is None and comp.method == "headkv":
        head_capacity = torch.zeros((L, H), dtype=torch.int32, device=dev)
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    draws = draw_shape(comp, cfg.num_attention_heads, cfg.num_key_value_heads, S) is not None
    states = _layer_draw_states(rng, comp, cfg, B, S, l0, Lp) if draws else None
    slab = llama.init_prefill_cache(dataclasses.replace(cfg, num_hidden_layers=Lp), comp, None,
                                    B, C, policy_capacity, dev)
    cos, sin = llama.rope_tables(cfg, S, dev)
    last = P - 1
    out = torch.zeros((B, N), dtype=torch.int64, device=dev)
    all_logits = (torch.zeros((B, N, cfg.vocab_size), dtype=torch.float32, device=dev)
                  if return_logits and s == last else None)
    hidden = (cfg.hidden_size,)

    # ---- prefill: tick t runs microbatch t - s --------------------------------
    recv = None
    for t in range(M + P - 1):
        m, h = t - s, None
        if 0 <= m < M:
            rows = slice(m * mb, (m + 1) * mb)
            tl, view = true_len[rows], _rows(slab, rows)
            x = params["embed"][tokens[rows]].to(dtype) if s == 0 else recv
            shard = HeadShard(m * mb, B, 0, cfg.num_attention_heads, cfg.num_key_value_heads)
            for li in range(Lp):
                gl = l0 + li
                lp = llama._layer(params, li)
                q, k, v = (a.contiguous() for a in llama._qkv(x, lp, cfg, cos, sin))
                attn, scores = llama.attend_prefill(q, k, v, tl, cfg, comp, sparse=False)
                x = llama._finish_layer(x, attn, lp, cfg)
                if draws:
                    rng.set_state(states[li])
                hc = None if head_capacity is None else head_capacity[gl]
                llama.store_packed_layer(view, li, compress_prefill(
                    comp, L, policy_capacity, k, v, q, tl,
                    LayerContext(gl, hc, rng, scores, shard)), comp, None, q, tl)
            view.positions.copy_(tl)
            h = x
            if s == last:
                lg = _last_logits(h, params, cfg, tl)
                out[rows, 0] = lg.argmax(-1)
                if all_logits is not None:
                    all_logits[rows, 0] = lg
        sends = [(h, s + 1)] if h is not None and s < last else []
        recvs = [((mb, S) + hidden, dtype, s - 1)] if s > 0 and 0 <= t - (s - 1) < M else []
        got = group.exchange(sends, recvs, device=dev)
        recv = got[0] if got else None

    # ---- the first tokens to stage 0 -------------------------------------------
    tok_buf = None
    if s == last:
        group.exchange([(out[:, 0].contiguous(), 0)], [])
    elif s == 0:
        tok_buf = group.exchange([], [((B,), torch.int64, last)], device=dev)[0]

    # ---- decode: tick tau runs microbatch (tau - s) % M at step (tau - s) // M + 1
    steps = (N - 1) * M
    recv = None
    for tau in range(steps + P - 1):
        u, h = tau - s, None
        if 0 <= u < steps:
            m, n = u % M, u // M + 1
            rows = slice(m * mb, (m + 1) * mb)
            x = (params["embed"][tok_buf[rows]].to(dtype)[:, None] if s == 0 else recv)
            h = llama.decode_hidden(params, cfg, x, _rows(slab, rows))
            if s == last:
                xf = llama.rms_norm(h[:, 0], params["final_norm"], cfg.rms_norm_eps)
                lg = llama.lm_logits(xf, params)
                tok = lg.argmax(-1)
                out[rows, n] = tok
                if all_logits is not None:
                    all_logits[rows, n] = lg
        sends, recvs = [], []
        if h is not None and s < last:
            sends.append((h, s + 1))
        if s > 0 and 0 <= tau - (s - 1) < steps:
            recvs.append(((mb, 1) + hidden, dtype, s - 1))
        # The last stage's token of step n returns for step n + 1 (< N).
        u_last = tau - last
        returns = 0 <= u_last < steps and u_last // M + 1 < N - 1
        if returns and s == last:
            sends.append((tok, 0))
        if returns and s == 0:
            recvs.append(((mb,), torch.int64, last))
        got = group.exchange(sends, recvs, device=dev)
        if returns and s == 0:
            m_r = u_last % M
            tok_buf[m_r * mb:(m_r + 1) * mb] = got[-1]
            got = got[:-1]
        recv = got[0] if got else None

    out = _from_last(group, out if s == last else None, (B, N), torch.int64, dev)
    logits = None
    if return_logits:
        logits = _from_last(group, all_logits, (B, N, cfg.vocab_size), torch.float32, dev)
    return PipelineResult(out, slab, logits)
