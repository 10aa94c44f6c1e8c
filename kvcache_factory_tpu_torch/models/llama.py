"""Llama / Mistral decoder in PyTorch (port of ``kvcache_factory_tpu/models/llama.py``).

One forward whose compression policy is a config argument.  Prefill runs
the K1 flash kernel (``ops/kernels/flash_prefill.py``), which also emits
the SnapKV observation-window scores, and builds the configured cache
layer by layer.  Decode dispatches on the cache's type, as the JAX package
does: over the dense ``KVCache`` K2 (``ops/kernels/decode_attn.py``) and
over the per-token int8 or int4 cache K3 or K4
(``ops/kernels/decode_attn_quant.py``) attend over a layer and append the
new token in place; over the grouped quantized, evicting, ThinK
channel-packed and host-offloaded caches (``cache/``) decode is plain
torch, as JAX computes them in XLA.  Everything else is plain torch, with
the fp32 islands where the JAX package has them: norm, RoPE and softmax.

A sliding window (Mistral-7B-v0.1, Qwen2) masks prefill attention inside
K1 and window-masks the decode rows whose cache index is the absolute
position.  A MInference ``sparse_prefill`` pattern restricts prefill
attention to K1's selected blocks (a-shape or vertical-slash, with optional
per-layer per-head budgets).  With a sequence-parallel group prefill splits
the prompt's rows over its ranks and runs ring attention (K1-ml per hop,
``parallel/ring_attention.py``).  Under tensor parallelism each rank
holds its shard of the weights (``parallel/mesh.py``) and runs the same
forward on its heads and FFN columns, with two reductions a layer and the
vocabulary gathered before a token is chosen.  A Mixtral configuration's FFN is the
sparse MoE block (:func:`moe_ffn`): decode gathers each row's top-k
experts by a device-side index, prefill dispatches each token to its
experts.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..cache.kv_cache import (EvictingKVCache, KVCache, init_cache, init_eviction_stamps,
                              valid_mask, write_rows)
from ..cache.offload_cache import LayerPrefetch, OffloadedKVCache
from ..cache.quant_cache import (Int4KVCache, Int8KVCache, QuantizedKVCache, decode_values,
                                 encode, init_grouped_cache, init_quant_cache,
                                 store_grouped_rows, store_rows)
from ..cache.think_cache import ThinKCache, init_think_cache, store_think_layer
from ..config import CompressionConfig, ModelConfig, QuantConfig, dtype_of
from ..ops.attention import NEG_INF
from ..ops.kernels.decode_attn import decode_attention_append
from ..ops.kernels.decode_attn_quant import (quant4_decode_attention_append,
                                              quant_decode_attention_append)
from ..ops.kernels.flash_prefill import flash_prefill_attention
from ..parallel.mesh import ExpertShard, SequenceParallelGroup, StagedGroup, gather_vocab
from ..parallel.ring_attention import ring_attention
from ..policies.base import PackedKV
from ..policies.methods import SCORES_REUSABLE, HeadShard, LayerContext, compress_prefill
from ..policies.scoring import full_attention_scores, window_query_rows
from ..policies.think import aggregate_queries_per_kv_head, think_channel_keep_idx

# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def wdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w``, where ``w`` may be a W8A16 leaf ``{"q": int8 [..., in,
    out], "s": fp32 [..., 1, out]}`` (``models/weights.py::quantize_weights``).
    The per-out-channel scale commutes with the contraction, so it is
    applied after the dot: ``(x @ q) * s`` (JAX ``llama.py:40-64``).  The
    stored scale is bf16-exact, so its cast to a bf16 activation dtype is
    lossless.  Plain torch materializes ``q`` in ``x``'s dtype on every
    call (XLA fuses that convert into the dot's read), so this path reads
    the int8 weights, writes and reads them again in bf16: more bytes than
    the bf16 weights alone."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["s"].squeeze(-2).to(x.dtype)
    return x @ w


def wshape(w) -> tuple:
    """Shape of a possibly weight-quantized matrix."""
    return tuple(w["q"].shape if isinstance(w, dict) else w.shape)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_inv_freq(cfg: ModelConfig, device="cpu") -> torch.Tensor:
    """Base inverse frequencies with optional HF rope_scaling ("linear" and
    "llama3" frequency-dependent scaling per HF modeling_rope_utils)."""
    d = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    rs = cfg.rope_scaling
    if rs is None:
        return inv_freq
    rope_type, factor, low_f, high_f, orig_max = rs
    if rope_type == "linear":
        return inv_freq / factor
    if rope_type == "llama3":
        low_wavelen = orig_max / low_f
        high_wavelen = orig_max / high_f
        wavelen = 2 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        out = torch.where(wavelen > low_wavelen, scaled, inv_freq)
        is_medium = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        return torch.where(is_medium, smoothed, out)
    raise ValueError(f"unsupported rope_scaling type {rope_type!r}")


def rope_tables(cfg: ModelConfig, max_len: int,
                device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [max_len, head_dim] (HF half-rotation convention)."""
    inv_freq = rope_inv_freq(cfg, device)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, H, T, D]; cos/sin: [B, T, D] or [T, D]."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, None], sin[:, None]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    B, T, _ = x.shape
    return x.reshape(B, T, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, H * D)


def grouped_attention(
    q: torch.Tensor,     # [B, Hq, Tq, D]
    k: torch.Tensor,     # [B, Hk, Tk, D]  (Hk divides Hq)
    v: torch.Tensor,     # [B, Hk, Tk, D]
    mask: torch.Tensor,  # broadcastable to [B, Hq, Tq, Tk] boolean (True=keep)
    return_probs: bool = False,
):
    """GQA attention without materializing repeated K/V.  Products take the
    input dtype with fp32 accumulation; the softmax is fp32; probabilities
    are cast to the value dtype for the PV product, as in the JAX package.
    ``return_probs`` also returns the fp32 probabilities [B, Hk, G, Tq, Tk]."""
    B, Hq, Tq, D = q.shape
    Hk = k.shape[1]
    G = Hq // Hk
    qg = q.reshape(B, Hk, G, Tq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float())
    logits = logits / math.sqrt(D)
    maskg = mask.reshape(B, Hk, G, *mask.shape[2:]) if mask.shape[1] == Hq \
        else mask[:, :, None]
    logits = torch.where(maskg, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).float(), v.float())
    out = out.reshape(B, Hq, Tq, D).to(q.dtype)
    if return_probs:
        return out, probs
    return out


def swiglu_fused(x: torch.Tensor, gate_up_w: torch.Tensor, down_w: torch.Tensor,
                 gate_up_b=None, down_b=None) -> torch.Tensor:
    gu = wdot(x, gate_up_w)
    if gate_up_b is not None:
        gu = gu + gate_up_b
    ffn = wshape(gate_up_w)[-1] // 2
    out = wdot(F.silu(gu[..., :ffn]) * gu[..., ffn:], down_w)
    return out if down_b is None else out + down_b


def moe_router(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Mixtral routing (JAX ``llama.py:183-196``): fp32 softmax over the
    expert logits, top-k, the kept weights renormalized.  Returns (combine
    ``[B, T, E]`` fp32, zero off the top-k; topi ``[B, T, k]``; topv ``[B,
    T, k]`` fp32).  The top-k ranks by a stable descending sort, so equal
    probabilities keep the lower expert first, as ``lax.top_k`` does
    (``torch.topk`` gives no such order)."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    topi = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :top_k]
    topv = probs.gather(-1, topi)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    combine = torch.zeros_like(probs).scatter_(-1, topi, topv)
    return combine, topi, topv


def _expert_dot(a: torch.Tensor, w) -> torch.Tensor:
    """``a [n, m, in] @ w [n, in, out]`` for per-row expert matrices, a
    W8A16 leaf's scale ``[n, 1, out]`` applied after the dot (JAX
    ``moe_ffn::ein``)."""
    if isinstance(w, dict):
        return torch.bmm(a, w["q"].to(a.dtype)) * w["s"].to(a.dtype)
    return torch.bmm(a, w)


def _take_experts(w, idx: torch.Tensor):
    """Expert matrices ``[E, ...]`` at the device-side ids ``idx [n]``, for
    ``q`` and ``s`` of a W8A16 leaf."""
    if isinstance(w, dict):
        return {k: t.index_select(0, idx) for k, t in w.items()}
    return w.index_select(0, idx)


def _expert(w, e: int):
    """Expert ``e``'s matrix, for ``q`` and ``s`` of a W8A16 leaf."""
    return {k: t[e] for k, t in w.items()} if isinstance(w, dict) else w[e]


def moe_ffn(x: torch.Tensor, lp: dict, cfg: ModelConfig, e0: int = 0) -> torch.Tensor:
    """Mixtral's sparse-MoE FFN (JAX ``llama.py:198-272``): the values of
    the JAX function, not its TPU dispatch.  ``gate_up_proj [E, h, 2f]``
    and ``down_proj [E, f, h]``, either possibly W8A16.

    Decode (T == 1) gathers each row's k experts by device-side index
    (``index_select`` on the expert axis) at every B and runs one batched
    product per matrix: no host read, so a decode step never waits on the
    card.  JAX's per-(b, k) dynamic slices and its dense branch at B*k >
    E/2 are TPU choices that compute the same function.

    Prefill (T > 1) dispatches: the (token, slot) pairs sorted by expert,
    each expert's rows through its matrices, and the outputs weighted by
    ``topv`` (cast to the activation dtype, as JAX's combine) summed into
    an fp32 buffer with ``index_add_``, cast once.  The per-expert counts
    are read to the host once per layer.  JAX's dense all-expert combine
    spends E/k times the products.

    Under expert parallelism the leaves hold experts ``[e0, e0 + n)`` of
    the model's ``E`` and the router all ``E`` (replicated, so every rank
    routes alike): the block computes only the local experts' share, the
    sum over experts that JAX's ``force_dense`` branch computes on one ep
    shard (``llama.py:221-233``), which the caller reduces over the ranks.
    Decode gathers each row's k selected experts clamped into the local
    block and weights those not held here by zero; prefill dispatches only
    the local experts' (token, slot) pairs."""
    E, top_k = cfg.num_local_experts, cfg.num_experts_per_tok
    gw, dw = lp["gate_up_proj"], lp["down_proj"]
    F_ = wshape(gw)[-1] // 2
    n_local = wshape(gw)[0]
    _, topi, topv = moe_router(x, lp["router"], top_k)
    B, T, h = x.shape
    if T == 1:
        idx = topi.reshape(B * top_k) - e0
        weight = topv[:, 0].to(x.dtype)
        if n_local != E:
            held = (idx >= 0) & (idx < n_local)
            idx = idx.clamp(0, n_local - 1)
            weight = torch.where(held.reshape(B, top_k), weight, torch.zeros_like(weight))
        xk = x.reshape(B, 1, h).repeat_interleave(top_k, dim=0)        # [B*k, 1, h]
        gu = _expert_dot(xk, _take_experts(gw, idx))                    # [B*k, 1, 2f]
        eo = _expert_dot(F.silu(gu[..., :F_]) * gu[..., F_:], _take_experts(dw, idx))
        eo = eo.reshape(B, top_k, h)
        return torch.einsum("bkh,bk->bh", eo, weight)[:, None]
    flat_x = x.reshape(B * T, h)
    flat_i = topi.reshape(-1)
    order = torch.argsort(flat_i, stable=True)
    counts = torch.bincount(flat_i, minlength=E).tolist()
    weight = topv.to(x.dtype).reshape(-1).float()
    out = torch.zeros((B * T, h), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        slots = order[start:start + n]
        start += n
        if n == 0 or not e0 <= e < e0 + n_local:
            continue
        tok = slots // top_k
        gu = wdot(flat_x.index_select(0, tok), _expert(gw, e - e0))
        eo = wdot(F.silu(gu[..., :F_]) * gu[..., F_:], _expert(dw, e - e0))
        out.index_add_(0, tok, eo.float() * weight.index_select(0, slots)[:, None])
    return out.to(x.dtype).reshape(B, T, h)


def ffn_block(h2: torch.Tensor, lp: dict, cfg: ModelConfig,
              tp: Optional[StagedGroup] = None,
              ep: Optional[ExpertShard] = None) -> torch.Tensor:
    """The layer's FFN: the sparse MoE block on a Mixtral configuration,
    else the fused SwiGLU with its optional biases.  Under ``tp`` each rank
    holds its FFN columns (of every expert), and the block's one reduction
    comes after the down projection (after the weighted combine of the
    experts), the down bias after it (JAX ``parallel/mesh.py:110-117``).
    Under ``ep`` the rank holds its experts (:func:`moe_ffn`) and the one
    reduction runs over the ``(ep, tp)`` plane, ``ep.group``."""
    if cfg.is_moe:
        out = moe_ffn(h2, lp, cfg, 0 if ep is None else ep.e0)
    else:
        out = swiglu_fused(h2, lp["gate_up_proj"], lp["down_proj"], lp.get("gate_up_bias"))
    group = tp if ep is None else ep.group
    if group is not None:
        out = group.all_reduce(out)
    return out if "down_bias" not in lp else out + lp["down_bias"]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


Cache = Union[KVCache, Int8KVCache, Int4KVCache, QuantizedKVCache, EvictingKVCache,
              ThinKCache, OffloadedKVCache]


class PrefillResult(NamedTuple):
    logits_last: torch.Tensor  # [B, V] fp32 logits at each sequence's last token
    cache: Cache


def _check_supported(cfg: ModelConfig, comp: CompressionConfig,
                     quant: Optional[QuantConfig]) -> None:
    """The JAX package's refusals of cache combinations (``ValueError``
    here, assertions there: ``llama.py:482-483, 526-527``)."""
    if comp.think_packed and (quant is not None or comp.decode_evict):
        raise ValueError("think_packed composes with neither the quantized cache nor "
                         "decode_evict")
    if comp.decode_evict and quant is not None:
        raise ValueError("decode_evict composes with the dense cache only, not quant")


def _layer(params: dict, li: int) -> dict:
    """Layer ``li``'s leaves; a W8A16 leaf gives its layer's ``q`` and ``s``."""
    return {name: ({k: t[li] for k, t in w.items()} if isinstance(w, dict) else w[li])
            for name, w in params["layers"].items()}


def _qkv(x, lp, cfg, cos, sin):
    """Pre-norm fused QKV projection with RoPE on q and k."""
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    qkv = wdot(h, lp["qkv_proj"])
    if "qkv_bias" in lp:
        qkv = qkv + lp["qkv_bias"]
    q = _split_heads(qkv[..., :Hq * D], Hq, D)
    k = _split_heads(qkv[..., Hq * D:(Hq + Hkv) * D], Hkv, D)
    v = _split_heads(qkv[..., (Hq + Hkv) * D:], Hkv, D)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _finish_layer(x, attn, lp, cfg, tp: Optional[StagedGroup] = None,
                  ep: Optional[ExpertShard] = None):
    """o_proj + residual, then the pre-norm FFN (:func:`ffn_block`) +
    residual.  Under ``tp`` ``attn`` holds this rank's heads, ``o_proj``
    their rows, and the projection is reduced over tp before its bias;
    attention is replicated over ``ep``."""
    h = wdot(_merge_heads(attn), lp["o_proj"])
    if tp is not None:
        h = tp.all_reduce(h)
    if "o_bias" in lp:
        h = h + lp["o_bias"]
    x = x + h
    return x + ffn_block(rms_norm(x, lp["post_norm"], cfg.rms_norm_eps), lp, cfg, tp, ep)


def lm_logits(x: torch.Tensor, params: dict, tp: Optional[StagedGroup] = None) -> torch.Tensor:
    """fp32 logits ``[..., V]`` of final-normed hidden states; under ``tp``
    each rank's vocabulary columns gathered, so that every token is chosen
    over the whole vocabulary by one device's rule."""
    return gather_vocab(tp, wdot(x, params["lm_head"])).float()


def init_prefill_cache(cfg: ModelConfig, comp: CompressionConfig,
                       quant: Optional[QuantConfig], batch: int, cache_capacity: int,
                       policy_capacity: int, device) -> Cache:
    """The empty cache a prefill fills, by the JAX package's
    ``build_cache_from_packed`` rule: per-token int8/int4 when
    ``quant.per_token``, else grouped, with ``quant``; ThinK's packed cache
    with ``think_packed`` (dense capacity ``min(C, recent_size + C -
    policy_capacity)``); the evicting cache with ``decode_evict``; else
    dense.  With :func:`store_packed_layer`, the cache-building tail shared
    by one-shot :func:`prefill` and chunked prefill's ``finalize``, built
    layer by layer so that no second copy of the packed K/V is held."""
    L, D = cfg.num_hidden_layers, cfg.head_dim
    heads = comp.cache_heads(cfg.num_attention_heads, cfg.num_key_value_heads)
    dtype = dtype_of(cfg)
    C = cache_capacity
    if quant is not None:
        if quant.per_token(D):
            return init_quant_cache(quant.nbits, L, batch, heads, C, D, device)
        return init_grouped_cache(quant, L, batch, heads, C, D, dtype, device)
    if comp.method == "think" and comp.think_packed:
        dense = min(C, comp.recent_size + (C - policy_capacity))
        return init_think_cache(L, batch, heads, C, D, D - int(D * comp.pruning_ratio), dense,
                                dtype, device)
    dense_cache = init_cache(L, batch, heads, C, D, dtype, device)
    if comp.decode_evict:
        scores = torch.zeros((L, batch, heads, C), dtype=torch.float32, device=device)
        return EvictingKVCache(dense_cache.k, dense_cache.v, scores,
                               torch.zeros_like(scores, dtype=torch.int32),
                               dense_cache.lengths, dense_cache.positions)
    return dense_cache


def store_packed_layer(cache: Cache, layer: int, packed: PackedKV, comp: CompressionConfig,
                       quant: Optional[QuantConfig], q: torch.Tensor,
                       true_len: torch.Tensor) -> None:
    """Write one layer's packed K/V ``[B, H, n, D]`` into slots ``[0, n)``
    and its lengths, in the cache's form: quantized per token or per group,
    kept channels for ThinK's packed cache (from the prefill queries ``q``
    ``[B, Hq, S, D]``, averaged per KV head on a grouped cache, as JAX
    ``llama.py:466-478``), or with the evicting cache's stamps (from the
    prompt lengths ``true_len``)."""
    n = packed.k.shape[2]
    if isinstance(cache, (Int8KVCache, Int4KVCache)):
        store_rows(cache, layer, packed.k, packed.v)
    elif isinstance(cache, QuantizedKVCache):
        store_grouped_rows(cache, layer, packed.k, packed.v, packed.lengths, quant)
    elif isinstance(cache, ThinKCache):
        H = packed.k.shape[1]
        q_for = q if q.shape[1] == H else aggregate_queries_per_kv_head(q, H)
        channels = torch.stack([think_channel_keep_idx(
            packed.k[b], packed.lengths[b], q_for[b], true_len[b], comp.pruning_ratio)
            for b in range(packed.k.shape[0])])
        store_think_layer(cache, layer, packed.k, packed.v, packed.lengths, channels,
                          comp.recent_size)
    else:
        cache.k[layer, :, :, :n] = packed.k
        cache.v[layer, :, :, :n] = packed.v
        if isinstance(cache, EvictingKVCache):
            cache.stamps[layer] = init_eviction_stamps(packed.lengths, true_len,
                                                       cache.capacity)
    cache.lengths[layer] = packed.lengths


def attend_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, true_len: torch.Tensor,
                   cfg: ModelConfig, comp: CompressionConfig,
                   sparse_budgets: Optional[torch.Tensor] = None,
                   sparse: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer's prefill attention over the whole prompt by K1, and the
    observation-window scores K1 emits for the methods that reuse them
    (``SCORES_REUSABLE``, no sliding window: JAX ``:388, 416``), masked at
    ``>= true_len - window`` (None for the other methods).  ``sparse``
    False runs dense attention whatever ``comp.sparse_prefill`` says."""
    emit = comp.method in SCORES_REUSABLE and cfg.sliding_window is None
    attn, win_sc = flash_prefill_attention(
        q, k, v, true_len, comp.window_size if emit else 0, sliding_window=cfg.sliding_window,
        sparse_pattern=comp.sparse_prefill if sparse else None,
        sparse_head_budgets=sparse_budgets if sparse else None)
    if not emit:
        return attn, None
    cols = torch.arange(q.shape[2], device=q.device)
    return attn, torch.where(cols >= (true_len[:, None, None] - comp.window_size), NEG_INF,
                             win_sc)


# Methods whose compression reads prefill query rows: the window's
# (scores, cam's probabilities) and ThinK's last 32.  h2o reads every row
# (sequence parallelism hands it its scores); the others read none.
_READS_QUERY_ROWS = SCORES_REUSABLE + ("cam",)


def sp_policy_queries(q: torch.Tensor, true_len: torch.Tensor, comp: CompressionConfig,
                      S: int, sp_group: SequenceParallelGroup) -> torch.Tensor:
    """The prefill queries a compression method reads, as a ``[B, Hq, S,
    D]`` tensor that a sequence-parallel rank can hand ``compress_prefill``:
    the last ``max(window, 32)`` rows of each prompt (the window's, as
    ``window_query_rows`` clamps them, and ThinK's 32 inside them), fetched
    from the ranks that hold them, at their global positions; zeros
    elsewhere, which those methods never read.  For a method that reads no
    row, ``q`` with no rows: only its head count is read."""
    if comp.method not in _READS_QUERY_ROWS:
        return q[:, :, :0]
    B, Hq, _, D = q.shape
    R = min(max(comp.window_size, 32), S)
    rows = torch.stack([window_query_rows(true_len[b], R, S) for b in range(B)])   # [B, R]
    got = sp_group.gather_rows(q, rows, dim=2).transpose(1, 2)                   # [B, Hq, R, D]
    full = q.new_zeros((B, Hq, S, D))
    full.scatter_(2, rows[:, None, :, None].expand(B, Hq, R, D), got)
    return full


def sp_full_scores(q: torch.Tensor, k: torch.Tensor, true_len: torch.Tensor, window: int,
                   row0: int, sp_group: SequenceParallelGroup) -> torch.Tensor:
    """h2o's column sums over every query row under sequence parallelism:
    each rank sums the rows it holds (``q`` ``[B, Hq, S_loc, D]``, rows
    ``[row0, row0 + S_loc)``) against the global keys ``k`` ``[B, Hkv, S,
    D]``, and the partial sums are added over the ranks (one reduction per
    example), ``[B, Hq, S]``.  This moves ``Hq * S`` fp32 a rank, where
    gathering the queries would move ``Hq * S * D`` values."""
    G = q.shape[1] // k.shape[1]
    return torch.stack([full_attention_scores(k[b].repeat_interleave(G, dim=0), q[b],
                                              true_len[b], window, row0=row0,
                                              reduce=sp_group.all_reduce)
                        for b in range(q.shape[0])])


def prefill(
    params: dict,
    cfg: ModelConfig,
    comp: CompressionConfig,
    tokens: torch.Tensor,    # [B, S] int, right-padded
    true_len: torch.Tensor,  # [B] int32
    cache_capacity: int,     # policy capacity + decode headroom
    *,
    quant: Optional[QuantConfig] = None,
    sparse_budgets: Optional[torch.Tensor] = None,  # [L, Hq, 2] int (MInference)
    sp_group: Optional[SequenceParallelGroup] = None,
    rng: Optional[torch.Generator] = None,         # cam, random
    head_capacity: Optional[torch.Tensor] = None,  # [L, H] int (headkv)
    tp: Optional[StagedGroup] = None,
    shard: Optional[HeadShard] = None,
    ep: Optional[ExpertShard] = None,
) -> PrefillResult:
    """Full prefill: attention over the uncompressed prompt, then the
    compression hook between the QKV computation and the cache write.
    The cache is allocated once and filled layer by layer
    (:func:`init_prefill_cache`); with ``quant`` each layer's packed K/V is
    quantized as soon as it is ready.
    Under ``cfg.sliding_window`` K1 masks each row's keys to its window and
    emits no scores: SnapKV's scores are a dense causal softmax, which no
    windowed softmax's ``(m, l)`` can give, so the policy computes them
    itself (``window_attention_scores``), as the JAX package does.  With
    ``comp.sparse_prefill`` K1 runs the MInference pattern; ``sparse_budgets``
    gives each layer's per-head (vertical, slash) budgets (JAX ``:314,
    487-488``), and SnapKV's scores are then sums of the sparse softmax.
    K1 emits the window scores for every method that reuses them
    (:func:`attend_prefill`).  cam and random draw from ``rng`` (a generator
    on the tokens' device seeded 0 when None, as JAX's ``PRNGKey(0)``);
    headkv reads ``head_capacity[li]``; without it every head's budget is 0
    and each head keeps only its window, as the JAX prefill feeds zeros
    (``llama.py:350-351``).

    With ``sp_group`` (JAX ``sp_mesh``, ``:381-405``) every rank receives
    the whole ``[B, S]`` prompt and computes only its rows ``[lo, hi)``
    (RoPE at their global positions); attention is
    :func:`~..parallel.ring_attention.ring_attention`, which hands back the
    global K/V, and every method compresses that, as JAX compresses the
    global K/V GSPMD gathers: the query rows a method reads are fetched
    from their ranks (:func:`sp_policy_queries`), and h2o's scores over
    every row are each rank's partial column sums added over the ranks
    (:func:`sp_full_scores`).  cam and random draw the whole shape on
    every rank from the same generator state.  Every rank builds the same
    cache; each example's last-token logits come from the rank that holds
    its row ``true_len - 1``.  Sparse patterns are not applied under sp,
    as in the JAX ring.

    Under tensor parallelism (``tp``, the JAX ``(dp, tp)`` mesh) ``params``
    and ``cfg`` are one rank's shard (``parallel/mesh.py::shard_params``,
    ``shard_model_config``): its query heads, the KV heads they read and
    its FFN and vocabulary columns.  K1 runs on the rank's heads, each
    layer reduces over ``tp`` twice (:func:`_finish_layer`), and the logits
    are gathered (:func:`lm_logits`).  ``sparse_budgets`` and
    ``head_capacity`` are then the rank's head slices, ``shard`` says where
    its ``[B, H]`` tile lies for the rules that are not tile-local (cam's
    and random's draws, AdaKV's budgets), and the cache holds the rank's
    heads.  Composed with ``sp_group`` (JAX's ring with ``head_axis="tp"``)
    the ring runs in the sp subgroup over the rank's heads.  Under expert
    parallelism (``ep``) ``params`` holds the rank's experts and the MoE
    block is reduced over ``ep.group`` (:func:`ffn_block`); attention runs
    on every head of every rank."""
    _check_supported(cfg, comp, quant)
    B, S = tokens.shape
    L = cfg.num_hidden_layers
    dtype = dtype_of(cfg)
    dev = tokens.device
    true_len = true_len.to(device=dev, dtype=torch.int32)
    lo, hi = (0, S) if sp_group is None else sp_group.bounds(S)

    x = params["embed"][tokens[:, lo:hi]].to(dtype)  # [B, hi - lo, hidden]
    cos, sin = rope_tables(cfg, S, dev)
    cos, sin = cos[lo:hi], sin[lo:hi]
    policy_capacity = comp.layer_capacity(L, S)
    assert cache_capacity >= policy_capacity, (
        f"cache capacity {cache_capacity} < policy capacity {policy_capacity}")
    cache = init_prefill_cache(cfg, comp, quant, B, cache_capacity, policy_capacity, dev)
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    if head_capacity is None and comp.method == "headkv":
        head_capacity = torch.zeros(
            (L, comp.cache_heads(cfg.num_attention_heads, cfg.num_key_value_heads)),
            dtype=torch.int32, device=dev)

    for li in range(L):
        lp = _layer(params, li)
        q, k, v = _qkv(x, lp, cfg, cos, sin)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        full_scores = None
        if sp_group is None:
            attn, window_scores = attend_prefill(
                q, k, v, true_len, cfg, comp,
                None if sparse_budgets is None else sparse_budgets[li])
        else:
            attn, k, v = ring_attention(q, k, v, true_len, sp_group, cfg.sliding_window)
            window_scores = None
            if comp.method == "h2o":
                full_scores = sp_full_scores(q, k, true_len, comp.window_size, lo, sp_group)
            q = sp_policy_queries(q, true_len, comp, S, sp_group)
        x = _finish_layer(x, attn, lp, cfg, tp, ep)
        hc = None if head_capacity is None else head_capacity[li]
        store_packed_layer(cache, li, compress_prefill(
            comp, L, policy_capacity, k, v, q, true_len,
            LayerContext(li, hc, rng, window_scores, shard, full_scores)),
            comp, quant, q, true_len)
    cache.positions.copy_(true_len)

    last = (true_len.to(torch.int64) - 1).clamp(min=0)
    if sp_group is None:
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        x_last = x[torch.arange(B, device=dev), last]
    else:
        x_last = rms_norm(sp_group.gather_rows(x, last[:, None], dim=1)[:, 0],
                          params["final_norm"], cfg.rms_norm_eps)
    return PrefillResult(lm_logits(x_last, params, tp), cache)


def window_lower(cfg: ModelConfig, lens: torch.Tensor,
                 positions: torch.Tensor) -> Optional[torch.Tensor]:
    """Pre-append lengths ``[B, H]`` and the positions ``[B]`` -> the first
    slot each head's decode attention may read under ``cfg.sliding_window``
    (None without one), as the JAX ``window_lower`` (``llama.py:676-686``).
    Only rows whose cache index is the absolute position (pre-append length
    == tokens seen: fullkv and the no-compress branch) are window-masked;
    compressed rows keep their importance-selected entries."""
    if cfg.sliding_window is None:
        return None
    ident = lens == positions[:, None]
    lo = torch.clamp(lens + 1 - cfg.sliding_window, min=0)
    return torch.where(ident, lo, torch.zeros_like(lo)).to(torch.int32)


def decode_mask(cfg: ModelConfig, lens: torch.Tensor, positions: torch.Tensor,
                capacity: int) -> torch.Tensor:
    """Post-append lengths ``[B, H]`` -> the ``[B, H, 1, C]`` mask of the
    plain-torch decode paths (JAX ``decode_mask``, ``llama.py:657-674``): the
    valid slots, and under ``cfg.sliding_window`` only the window's on rows
    whose cache index is the absolute position (``lens == positions + 1``,
    ``positions`` before this step's increment)."""
    m = valid_mask(lens, capacity)
    if cfg.sliding_window is not None:
        ident = lens == (positions + 1)[:, None]
        lo = torch.where(ident, (lens - cfg.sliding_window).clamp(min=0), torch.zeros_like(lens))
        m = m & (torch.arange(capacity, device=lens.device) >= lo[..., None])
    return m[:, :, None, :]


def _attend_kernel(cache, li, q, k, v, cfg, quant, positions):
    """K2 over the dense cache, K3 / K4 over the per-token one: attend over
    layer ``li`` and append the new token in place."""
    B, H, C = cache.lengths.shape[1], cache.lengths.shape[2], cache.capacity
    Hq, D = q.shape[1], q.shape[-1]
    lens = cache.lengths[li]
    lower = window_lower(cfg, lens, positions)
    if lower is not None:
        lower = lower.reshape(B * H)
    q_bh = q.reshape(B * H, Hq // H, D).contiguous()
    k_bh = k.reshape(B * H, D).contiguous()
    v_bh = v.reshape(B * H, D).contiguous()
    if quant is None:
        out = decode_attention_append(
            q_bh, cache.k[li].view(B * H, C, D), cache.v[li].view(B * H, C, D),
            lens.view(B * H), k_bh, v_bh, lower)
    else:
        attend = (quant_decode_attention_append if quant.nbits == 8
                  else quant4_decode_attention_append)
        W = cache.k_codes.shape[-1]
        out = attend(q_bh, cache.k_codes[li].view(B * H, C, W),
                     cache.v_codes[li].view(B * H, C, W),
                     cache.scales[li].view(B * H, C, 4), lens.view(B * H), k_bh, v_bh, lower)
    torch.clamp(lens + 1, max=C, out=lens)
    return out.reshape(B, Hq, 1, D)


def _attend_grouped(cache: QuantizedKVCache, li, q, k, v, cfg, quant, positions):
    """The grouped cache (JAX ``llama.py:974-1035``): encode the new token
    once and write it at each head's length, dropped at a full cache (the
    ring's write too), then dequantize the layer, let the ring win its last
    ``R`` rows, and attend."""
    C, dtype = cache.capacity, k.dtype
    lens = cache.lengths[li]
    keep = lens < C
    outs = (cache.k_oval, cache.k_oidx, cache.v_oval, cache.v_oidx)
    for x, planes in ((k, (cache.qk, cache.k_scale, cache.k_zero) + outs[:2]),
                      (v, (cache.qv, cache.v_scale, cache.v_zero) + outs[2:])):
        for buf, new in zip(planes, encode(x[:, :, 0], quant)):
            if buf is not None:
                write_rows(buf[li], lens, keep, new)
    R = cache.residual_length
    if R:
        write_rows(cache.rk[li], lens % R, keep, k[:, :, 0])
        write_rows(cache.rv[li], lens % R, keep, v[:, :, 0])
    torch.clamp(lens + 1, max=C, out=lens)
    k_read = decode_values(cache.qk[li], cache.k_scale[li], cache.k_zero[li], quant, dtype,
                           None if outs[0] is None else outs[0][li],
                           None if outs[1] is None else outs[1][li])
    v_read = decode_values(cache.qv[li], cache.v_scale[li], cache.v_zero[li], quant, dtype,
                           None if outs[2] is None else outs[2][li],
                           None if outs[3] is None else outs[3][li])
    if R:
        cidx = torch.arange(C, device=lens.device)
        recent = ((cidx >= lens[..., None] - R) & (cidx < lens[..., None]))[..., None]
        k_read = torch.where(recent, cache.rk[li].index_select(2, cidx % R), k_read)
        v_read = torch.where(recent, cache.rv[li].index_select(2, cidx % R), v_read)
    return grouped_attention(q, k_read, v_read, decode_mask(cfg, lens, positions, C))


def _attend_evicting(cache: EvictingKVCache, li, q, k, v, cfg, positions, eviction_recent):
    """Decode-stage eviction (JAX ``llama.py:1113-1141``): a full head's
    new token overwrites the lowest-scored slot not written within the last
    ``eviction_recent`` positions (the first such, as ``jnp.argmin``); the
    slot's score restarts at 0 and every slot gains this step's attention
    mass, summed over the head's query rows in fp32."""
    C = cache.capacity
    lens, scores, stamps = cache.lengths[li], cache.scores[li], cache.stamps[li]
    protected = stamps >= (positions[:, None, None] - eviction_recent)
    victim = torch.where(protected, torch.inf, scores).argmin(dim=-1)
    target = torch.where(lens < C, lens.long(), victim)
    always = torch.ones_like(lens, dtype=torch.bool)
    write_rows(cache.k[li], target, always, k[:, :, 0])
    write_rows(cache.v[li], target, always, v[:, :, 0])
    write_rows(stamps, target, always, positions[:, None].expand_as(lens))
    scores.scatter_(2, target[..., None], 0.0)
    torch.clamp(lens + 1, max=C, out=lens)
    out, probs = grouped_attention(q, cache.k[li], cache.v[li],
                                   decode_mask(cfg, lens, positions, C), return_probs=True)
    scores.add_(probs[:, :, :, 0, :].sum(dim=2))
    return out


def _attend_think(cache: ThinKCache, li, q):
    """ThinK's packed cache after the appends (JAX ``llama.py:1057-1111``):
    pruned logits ``q[channels] . kp`` on every row, the exact ``q . kd`` on
    rows ``[boundary, boundary + Cr)`` by a gather, one ``1/sqrt(D)``
    scale, and the plain PV product."""
    C, Cr = cache.capacity, cache.dense_capacity
    lens, bnd = cache.lengths[li], cache.boundary[li]
    kp, ch, kd, vl = cache.kp[li], cache.channels[li], cache.kd[li], cache.v[li]
    B, Hk = lens.shape
    Hq, D = q.shape[1], q.shape[-1]
    qg = q.reshape(B, Hk, Hq // Hk, D).float()
    qp = qg.gather(3, ch.long()[:, :, None, :].expand(-1, -1, qg.shape[2], -1))
    logit_p = torch.einsum("bhgd,bhkd->bhgk", qp, kp.float())
    logit_d = torch.einsum("bhgd,bhkd->bhgk", qg, kd.float())
    rel = torch.arange(C, device=lens.device) - bnd.long()[..., None]  # [B, Hk, C]
    in_dense = (rel >= 0) & (rel < Cr)
    dense = logit_d.gather(3, rel.clamp(0, Cr - 1)[:, :, None, :].expand(-1, -1, qg.shape[2], -1))
    logit = torch.where(in_dense[:, :, None], dense, logit_p) / math.sqrt(D)
    logit = torch.where(valid_mask(lens, C)[:, :, None], logit, NEG_INF)
    probs = torch.softmax(logit, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs.to(vl.dtype).float(), vl.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def _append_think(cache: ThinKCache, li, k, v):
    """The new token's whole key at ``kd`` slot ``lengths - boundary`` and
    its value at ``lengths``, each dropped past its buffer;
    ``lengths = min(lengths + 1, boundary + Cr, C)``."""
    C, Cr = cache.capacity, cache.dense_capacity
    lens, bnd = cache.lengths[li], cache.boundary[li]
    write_rows(cache.kd[li], lens - bnd, (lens - bnd) < Cr, k[:, :, 0])
    write_rows(cache.v[li], lens, lens < C, v[:, :, 0])
    torch.minimum(torch.clamp(lens + 1, max=C), bnd + Cr, out=lens)


def _attend_offloaded(cache: OffloadedKVCache, li, q, k, v, host_k, host_v):
    """The offloaded cache (JAX ``llama.py:1036-1056``): the new token in
    ring slot ``lengths - prefill_len`` (dropped past the ring), lengths
    capped at ``prefill_len + R``, attention over ``[host rows ‖ ring]``
    with the host layer already on the device."""
    R = cache.device_capacity
    lens, plen = cache.lengths[li], cache.prefill_len[li]
    slot = lens - plen
    write_rows(cache.dk[li], slot, slot < R, k[:, :, 0])
    write_rows(cache.dv[li], slot, slot < R, v[:, :, 0])
    torch.minimum(lens + 1, plen + R, out=lens)
    Ch = host_k.shape[2]
    cidx = torch.arange(Ch + R, device=lens.device)
    mask = torch.where(cidx < Ch, cidx < plen[..., None], (cidx - Ch) < (lens - plen)[..., None])
    return grouped_attention(q, torch.cat([host_k, cache.dk[li]], dim=2),
                             torch.cat([host_v, cache.dv[li]], dim=2), mask[:, :, None, :])


def decode_hidden(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,       # [B, 1, hidden] the layers' input
    cache: Cache,
    quant: Optional[QuantConfig] = None,
    eviction_recent: int = 32,
    tp: Optional[StagedGroup] = None,
    ep: Optional[ExpertShard] = None,
) -> torch.Tensor:
    """The layers of one decode step over hidden states ``x``: every layer
    of ``params["layers"]`` against the matching layer of ``cache`` (a
    pipeline stage's layers and its cache slab), RoPE at
    ``cache.positions``, which advance by one.  Returns the last layer's
    output ``[B, 1, hidden]``; see :func:`decode_step`."""
    per_token = isinstance(cache, (Int8KVCache, Int4KVCache))
    grouped = isinstance(cache, QuantizedKVCache)
    if (quant is None) == (per_token or grouped) or \
            (per_token and quant.nbits != cache.nbits):
        raise ValueError("a quant config must be passed exactly when the cache is "
                         "quantized, with the cache's nbits")
    if grouped and (cache.k_oval is not None) != quant.outlier_extract:
        raise ValueError("cache outlier planes must match QuantConfig.outlier_extract")
    dtype = dtype_of(cfg)
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    H = cache.lengths.shape[2]
    pos = cache.positions
    # RoPE position = uncompressed token count (reference _seen_tokens sync),
    # not the compressed cache length.
    freqs = pos[:, None].float() * rope_inv_freq(cfg, x.device)[None]
    emb = torch.cat([freqs, freqs], dim=-1)[:, None]  # [B, 1, D]
    cos, sin = emb.cos(), emb.sin()
    host = LayerPrefetch(cache, x.device) if isinstance(cache, OffloadedKVCache) else None

    for li in range(wshape(params["layers"]["qkv_proj"])[0]):
        lp = _layer(params, li)
        q, k, v = _qkv(x, lp, cfg, cos, sin)
        if H == Hq and Hq != Hkv:  # per-query-head cache
            k = k.repeat_interleave(Hq // Hkv, dim=1)
            v = v.repeat_interleave(Hq // Hkv, dim=1)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        if isinstance(cache, (KVCache, Int8KVCache, Int4KVCache)):
            out = _attend_kernel(cache, li, q, k, v, cfg, quant, pos)
        elif grouped:
            out = _attend_grouped(cache, li, q, k, v, cfg, quant, pos)
        elif isinstance(cache, EvictingKVCache):
            out = _attend_evicting(cache, li, q, k, v, cfg, pos, eviction_recent)
        elif isinstance(cache, ThinKCache):
            _append_think(cache, li, k, v)
            out = _attend_think(cache, li, q)
        else:
            out = _attend_offloaded(cache, li, q, k, v, *host.layer(li))
        x = _finish_layer(x, out, lp, cfg, tp, ep)
    cache.positions.add_(1)
    return x


def decode_step(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B] int, current input token
    cache: Cache,
    quant: Optional[QuantConfig] = None,
    eviction_recent: int = 32,
    tp: Optional[StagedGroup] = None,
    ep: Optional[ExpertShard] = None,
) -> Tuple[torch.Tensor, Cache]:
    """One decode step: append at each head's length and attend over the
    compressed cache, dispatched on the cache's type (JAX ``:600-606``):
    K2 over a dense ``KVCache``, K3 / K4 over an ``Int8KVCache`` /
    ``Int4KVCache`` (with the :func:`window_lower` bound under a sliding
    window), and plain torch over a ``QuantizedKVCache``,
    ``EvictingKVCache`` (``eviction_recent``), ``ThinKCache`` or
    ``OffloadedKVCache`` (layer ``i + 1``'s host K/V copied while layer
    ``i`` computes, :class:`~..cache.offload_cache.LayerPrefetch`).
    ``quant`` is given exactly when the cache is quantized, as in the JAX
    package.  **Updates ``cache`` in place** (its slots, ``lengths`` and
    ``positions``) and returns it with the logits [B, V] fp32; the JAX
    version returns a new cache.  Under ``tp`` (see :func:`prefill`)
    ``params``, ``cfg`` and ``cache`` are one rank's shard: K2-K4 attend
    over the rank's heads, and the logits are gathered over the vocabulary;
    under ``ep`` ``params`` holds the rank's experts (:func:`ffn_block`)."""
    x = params["embed"][tokens].to(dtype_of(cfg))[:, None]  # [B, 1, hidden]
    x = decode_hidden(params, cfg, x, cache, quant, eviction_recent, tp, ep)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return lm_logits(x[:, 0], params, tp), cache
