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
``parallel/ring_attention.py``).  MoE configurations raise
``NotImplementedError`` naming their ROADMAP.md item.
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
from ..parallel.mesh import SequenceParallelGroup
from ..parallel.ring_attention import ring_attention
from ..policies.base import PackedKV
from ..policies.methods import SCORES_REUSABLE, LayerContext, compress_prefill
from ..policies.scoring import window_attention_scores, window_query_rows
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


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


Cache = Union[KVCache, Int8KVCache, Int4KVCache, QuantizedKVCache, EvictingKVCache,
              ThinKCache, OffloadedKVCache]


class PrefillResult(NamedTuple):
    logits_last: torch.Tensor  # [B, V] fp32 logits at each sequence's last token
    cache: Cache


def _check_supported(cfg: ModelConfig, comp: CompressionConfig,
                     quant: Optional[QuantConfig], sp: bool = False) -> None:
    """The JAX package's refusals of cache combinations (``ValueError``
    here, assertions there: ``llama.py:482-483, 526-527``), then what the
    port does not carry yet."""
    if comp.think_packed and (quant is not None or comp.decode_evict):
        raise ValueError("think_packed composes with neither the quantized cache nor "
                         "decode_evict")
    if comp.decode_evict and quant is not None:
        raise ValueError("decode_evict composes with the dense cache only, not quant")
    if sp and comp.method not in ("snapkv", "fullkv", "minference"):
        raise NotImplementedError(
            f"{comp.method!r} under sequence parallelism is not ported yet (ROADMAP.md "
            "item 1.11)")
    if cfg.is_moe:
        raise NotImplementedError("MoE is not ported yet (ROADMAP.md item 1.9)")


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


def _finish_layer(x, attn, lp, cfg):
    """o_proj + residual, then the pre-norm FFN + residual."""
    h = wdot(_merge_heads(attn), lp["o_proj"])
    if "o_bias" in lp:
        h = h + lp["o_bias"]
    x = x + h
    h2 = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
    return x + swiglu_fused(h2, lp["gate_up_proj"], lp["down_proj"],
                            lp.get("gate_up_bias"), lp.get("down_bias"))


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
    (``SCORES_REUSABLE``).  cam and random draw from ``rng`` (a generator
    on the tokens' device seeded 0 when None, as JAX's ``PRNGKey(0)``);
    headkv reads ``head_capacity[li]``; without it every head's budget is 0
    and each head keeps only its window, as the JAX prefill feeds zeros
    (``llama.py:350-351``).

    With ``sp_group`` (JAX ``sp_mesh``, ``:381-405``) every rank receives
    the whole ``[B, S]`` prompt and computes only its rows ``[lo, hi)``
    (RoPE at their global positions); attention is
    :func:`~..parallel.ring_attention.ring_attention`, which hands back the
    global K/V, and compression runs on that, with SnapKV's scores computed
    from the window's q rows gathered from their ranks (the JAX sp branch
    scores with ``window_attention_scores`` too); the other compressing
    methods raise ``NotImplementedError`` under sp (ROADMAP.md item
    1.11).  Every rank builds the
    same cache; each example's last-token logits come from the rank that
    holds its row ``true_len - 1``.  Sparse patterns are not applied under
    sp, as in the JAX ring."""
    _check_supported(cfg, comp, quant, sp=sp_group is not None)
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
    # Score emission only when the policy reuses it, sparse or not (JAX
    # :388, 416); window=0 skips it.
    emit = comp.method in SCORES_REUSABLE and cfg.sliding_window is None
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    if head_capacity is None and comp.method == "headkv":
        head_capacity = torch.zeros(
            (L, comp.cache_heads(cfg.num_attention_heads, cfg.num_key_value_heads)),
            dtype=torch.int32, device=dev)
    win = comp.window_size if emit else 0
    cols = torch.arange(S, device=dev)
    if sp_group is not None:
        # The SnapKV window's q rows, [B, w] global ids, fetched each layer.
        win_rows = torch.stack([window_query_rows(true_len[b], comp.window_size, S)
                                for b in range(B)])

    for li in range(L):
        lp = _layer(params, li)
        q, k, v = _qkv(x, lp, cfg, cos, sin)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        window_scores = None
        if sp_group is None:
            attn, win_sc = flash_prefill_attention(
                q, k, v, true_len, win, sliding_window=cfg.sliding_window,
                sparse_pattern=comp.sparse_prefill,
                sparse_head_budgets=None if sparse_budgets is None else sparse_budgets[li])
            if emit:
                window_scores = torch.where(
                    cols >= (true_len[:, None, None] - comp.window_size),
                    NEG_INF, win_sc)
        else:
            attn, k, v = ring_attention(q, k, v, true_len, sp_group, cfg.sliding_window)
            if comp.method == "snapkv":
                # compress_layer reads only q's head count once scores are given.
                q = sp_group.gather_rows(q, win_rows, dim=2).transpose(1, 2)  # [B, Hq, w, D]
                G = q.shape[1] // k.shape[1]
                window_scores = torch.stack([window_attention_scores(
                    k[b].repeat_interleave(G, dim=0), None, true_len[b], comp.window_size,
                    q_win=q[b]) for b in range(B)])
        x = _finish_layer(x, attn, lp, cfg)
        hc = None if head_capacity is None else head_capacity[li]
        store_packed_layer(cache, li, compress_prefill(
            comp, L, policy_capacity, k, v, q, true_len,
            LayerContext(li, hc, rng, window_scores)), comp, quant, q, true_len)
    cache.positions.copy_(true_len)

    last = (true_len.to(torch.int64) - 1).clamp(min=0)
    if sp_group is None:
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        x_last = x[torch.arange(B, device=dev), last]
    else:
        x_last = rms_norm(sp_group.gather_rows(x, last[:, None], dim=1)[:, 0],
                          params["final_norm"], cfg.rms_norm_eps)
    logits_last = wdot(x_last, params["lm_head"]).float()
    return PrefillResult(logits_last, cache)


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


def decode_step(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B] int, current input token
    cache: Cache,
    quant: Optional[QuantConfig] = None,
    eviction_recent: int = 32,
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
    version returns a new cache."""
    per_token = isinstance(cache, (Int8KVCache, Int4KVCache))
    grouped = isinstance(cache, QuantizedKVCache)
    if (quant is None) == (per_token or grouped) or \
            (per_token and quant.nbits != cache.nbits):
        raise ValueError("a quant config must be passed exactly when the cache is "
                         "quantized, with the cache's nbits")
    if grouped and (cache.k_oval is not None) != quant.outlier_extract:
        raise ValueError("cache outlier planes must match QuantConfig.outlier_extract")
    if cfg.is_moe:
        raise NotImplementedError("MoE decode is not ported yet (ROADMAP.md item 1.9)")
    L = cfg.num_hidden_layers
    dtype = dtype_of(cfg)
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    H = cache.lengths.shape[2]
    pos = cache.positions

    x = params["embed"][tokens].to(dtype)[:, None]  # [B, 1, hidden]
    # RoPE position = uncompressed token count (reference _seen_tokens sync),
    # not the compressed cache length.
    freqs = pos[:, None].float() * rope_inv_freq(cfg, x.device)[None]
    emb = torch.cat([freqs, freqs], dim=-1)[:, None]  # [B, 1, D]
    cos, sin = emb.cos(), emb.sin()
    host = LayerPrefetch(cache, x.device) if isinstance(cache, OffloadedKVCache) else None

    for li in range(L):
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
        x = _finish_layer(x, out, lp, cfg)

    cache.positions.add_(1)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = wdot(x[:, 0], params["lm_head"]).float()
    return logits, cache
