"""Chunked prefill (port of ``kvcache_factory_tpu/models/chunked_prefill.py``).

A prompt is processed in fixed-size chunks and compressed once at the end,
so that continuous-batching admission can interleave prompt chunks with
decode chunks and bound the stall a long prompt puts on running streams
(``runtime/batching.py``).  The semantics are exact: a chunk's attention is
ordinary causal (and sliding-window) attention of its queries over every
key written so far, K1's chunk mode (``row_offset``), so the hidden states
equal the one-shot prefill's up to rounding, and compression runs once at
the end with the same policy code (``compress_prefill``).

The state between chunks is ``(kbuf, vbuf, qwin, x_last)``: every layer's
uncompressed keys and values ``[L, B, Hkv, S, D]``, a trailing-query store
``[L, B, Hq, WK, D]`` with ``WK = min(max(window, 32), S)`` (every policy
but h2o reads ``q`` only through its last ``max(window, 32)`` rows), and
each row's last hidden state ``[B, hidden]``.  h2o's scores are not causal
(every query row attends to every key, JAX ``chunked_prefill.py:29-36``),
so its store is the full query buffer, ``WK = S``, with rows written at
their global positions like K/V.  Unlike the JAX version,
:func:`chunk_step` updates the state **in place** and returns it.

Every compression method runs, with cam's and random's draws and headkv's
capacities handed to :func:`finalize`, into every cache that one-shot
prefill builds (dense, per-token or grouped quantized, evicting, ThinK
packed).  MInference sparse prefill raises ``NotImplementedError`` as in
the JAX package (a dense chunked pass would compute another function).
A Mixtral layer's FFN is ``llama.ffn_block``, as in one-shot prefill.

Under tensor parallelism (``tp``) ``params`` and ``cfg`` are one rank's
shard, as in one-shot ``llama.prefill``: the state holds the rank's heads,
each layer reduces over tp twice, and ``finalize`` gathers the logits and
takes ``shard`` for the rules that are not local to a head tile.  Expert
parallelism is not taken here: the batching engine refuses chunked
admission under ep, as JAX's does (``runtime/batching.py:144-153``).

Host values: ``c0`` and ``true_len`` are host integers (the engine keeps
them in numpy); each call builds fresh device tensors from them, so a
caller may change its arrays once the call returns.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import CompressionConfig, ModelConfig, QuantConfig, dtype_of
from ..ops.kernels.flash_prefill import flash_prefill_attention
from ..parallel.mesh import StagedGroup
from ..policies.methods import HeadShard, LayerContext, compress_prefill
from . import llama
from .llama import (PrefillResult, _finish_layer, _layer, _qkv, init_prefill_cache,
                    lm_logits, rms_norm, rope_inv_freq, store_packed_layer)

ChunkState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
HostInts = Union[int, Sequence[int], np.ndarray]


def _check_supported(comp: CompressionConfig) -> None:
    if comp.sparse_prefill is not None:
        raise NotImplementedError(
            "chunked prefill computes dense causal attention per chunk; "
            "MInference sparse prefill patterns require the one-shot path, as "
            "in the JAX package (ROADMAP.md queues no port of it).")


def init_chunked_state(cfg: ModelConfig, comp: CompressionConfig, batch: int, S: int,
                       device="cuda") -> ChunkState:
    """Zeroed chunked-prefill state (kbuf, vbuf, qwin, x_last) for ``batch``
    rows of a bucket of ``S`` tokens."""
    _check_supported(comp)
    L = cfg.num_hidden_layers
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    dtype = dtype_of(cfg)
    WK = S if comp.method == "h2o" else min(max(comp.window_size, 32), S)
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return (z(L, batch, Hkv, S, D), z(L, batch, Hkv, S, D), z(L, batch, Hq, WK, D),
            z(batch, cfg.hidden_size))


def chunk_step(
    params: dict,
    cfg: ModelConfig,
    toks_chunk: torch.Tensor,  # [B, Sc] int on the device (right-padded rows are inert)
    c0: HostInts,              # int | [B]: global offset of each row's chunk
    true_len: HostInts,        # [B] global prompt lengths
    state: ChunkState,
    tp: Optional[StagedGroup] = None,
) -> ChunkState:
    """Run one chunk through all layers, updating ``state`` in place.  A
    ``[B]`` ``c0`` gives every row its own prefill depth, so concurrent
    admissions advance in one call.  Rows with ``c0 >= true_len`` are inert:
    their buffers, query store and last hidden state are untouched (free
    pool rows carry ``true_len`` 0)."""
    kbuf, vbuf, qwin, x_last = state
    B, Sc = toks_chunk.shape
    L, S = cfg.num_hidden_layers, kbuf.shape[3]
    Hq, D = cfg.num_attention_heads, cfg.head_dim
    WK = qwin.shape[3]
    dtype = dtype_of(cfg)
    dev = toks_chunk.device
    c0 = np.broadcast_to(np.asarray(c0, np.int64), (B,))
    tl = np.asarray(true_len, np.int64).reshape(B)
    active = c0 < tl
    if (c0[active] + Sc > S).any():
        raise ValueError(f"a {Sc}-token chunk at {c0.tolist()} runs past the {S}-token buffer")
    c0_t = torch.tensor(c0.tolist(), dtype=torch.int32, device=dev)
    tl_t = torch.tensor(tl.tolist(), dtype=torch.int32, device=dev)

    t = (c0_t[:, None] + torch.arange(Sc, device=dev)[None]).float()     # [B, Sc]
    freqs = t[..., None] * rope_inv_freq(cfg, dev)[None, None]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos(), emb.sin()                                       # [B, Sc, D]
    # Trailing-query store: slot j holds global row true_len - WK + j; its
    # row inside this chunk is that minus c0.
    src = tl[:, None] - WK + np.arange(WK)[None] - c0[:, None]            # [B, WK]
    take = torch.tensor((src >= 0) & (src < Sc) & active[:, None], device=dev)
    src_t = torch.tensor(np.clip(src, 0, Sc - 1), device=dev)
    rows = [(b, int(c0[b])) for b in np.nonzero(active)[0]]

    x = params["embed"][toks_chunk].to(dtype)
    for li in range(L):
        lp = _layer(params, li)
        q, k, v = _qkv(x, lp, cfg, cos, sin)
        kl, vl, ql = kbuf[li], vbuf[li], qwin[li]
        for b, c in rows:
            kl[b, :, c:c + Sc] = k[b]
            vl[b, :, c:c + Sc] = v[b]
            if WK == S:  # h2o's full store: rows at their global positions
                ql[b, :, c:c + Sc] = q[b]
        attn, _ = flash_prefill_attention(q.contiguous(), kl, vl, tl_t, 0,
                                          sliding_window=cfg.sliding_window,
                                          row_offset=c0_t)
        x = _finish_layer(x, attn, lp, cfg, tp)
        if WK != S:
            gathered = q.gather(2, src_t[:, None, :, None].expand(B, Hq, WK, D))
            torch.where(take[:, None, :, None], gathered.to(ql.dtype), ql, out=ql)

    last_row = tl - 1 - c0
    for b in np.nonzero((last_row >= 0) & (last_row < Sc) & active)[0]:
        x_last[b] = x[b, last_row[b]]
    return state


def finalize(
    params: dict,
    cfg: ModelConfig,
    comp: CompressionConfig,
    state: ChunkState,
    true_len: HostInts,  # [B]
    cache_capacity: int,
    *,
    quant: QuantConfig = None,
    rng: Optional[torch.Generator] = None,
    head_capacity: Optional[torch.Tensor] = None,
    tp: Optional[StagedGroup] = None,
    shard: Optional[HeadShard] = None,
) -> PrefillResult:
    """Compress every layer's accumulated K/V and build the configured
    cache, with the cache-building tail one-shot ``prefill`` uses.  Reads
    ``state`` only.  ``rng`` and ``head_capacity`` are one-shot
    ``prefill``'s: cam and random draw from the generator (seeded 0 on the
    state's device when None) through ``policies/methods.py::uniform_draw``,
    layer by layer and example by example; headkv reads ``head_capacity
    [L, H]`` (zeros when None: every head keeps only its window, as JAX's
    ``finalize``).

    The trailing-query store goes into a zeros-elsewhere full-shape q at rows
    ``[true_len - WK, true_len)``: the rows the policies read.  A prompt
    shorter than WK fills only the last ``true_len`` slots (slot j holds
    global row ``true_len - WK + j``), so the store is rolled to put its
    valid tail at row 0 and every stored row at its global position (the
    JAX package's round-4 fix, ``chunked_prefill.py:275-284``).  h2o's full
    store is that q already."""
    kbuf, vbuf, qwin, x_last = state
    L, B, Hkv, S, D = kbuf.shape
    Hq, WK = cfg.num_attention_heads, qwin.shape[3]
    dev = kbuf.device
    tl = [int(n) for n in np.asarray(true_len).reshape(B)]
    tl_t = torch.tensor(tl, dtype=torch.int32, device=dev)
    policy_capacity = comp.layer_capacity(L, S)
    assert cache_capacity >= policy_capacity
    cache = init_prefill_cache(cfg, comp, quant, B, cache_capacity, policy_capacity, dev)
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    if head_capacity is None and comp.method == "headkv":
        head_capacity = torch.zeros((L, comp.cache_heads(Hq, Hkv)), dtype=torch.int32,
                                    device=dev)
    for li in range(L):
        if WK == S:
            q_sub = qwin[li]
        else:
            q_sub = torch.zeros((B, Hq, S, D), dtype=qwin.dtype, device=dev)
            for b, n in enumerate(tl):
                start = n - WK if n >= WK else 0
                q_sub[b, :, start:start + WK] = torch.roll(qwin[li, b], min(n, WK) - WK,
                                                           dims=1)
        hc = None if head_capacity is None else head_capacity[li]
        store_packed_layer(cache, li, compress_prefill(
            comp, L, policy_capacity, kbuf[li], vbuf[li], q_sub, tl_t,
            LayerContext(li, hc, rng, None, shard)), comp, quant, q_sub, tl_t)
    cache.positions.copy_(tl_t)
    xf = rms_norm(x_last[:, None], params["final_norm"], cfg.rms_norm_eps)[:, 0]
    return PrefillResult(lm_logits(xf, params, tp), cache)


def prefill_chunked(
    params: dict,
    cfg: ModelConfig,
    comp: CompressionConfig,
    tokens: torch.Tensor,    # [B, S] int, right-padded
    true_len: torch.Tensor,  # [B]
    cache_capacity: int,
    chunk_size: int,
    *,
    quant: QuantConfig = None,
    rng: Optional[torch.Generator] = None,
    head_capacity: Optional[torch.Tensor] = None,
) -> PrefillResult:
    """One-call chunked prefill, the standalone API; the batching engine
    drives :func:`chunk_step` itself so that decode chunks interleave with
    prompt chunks.  Chunks past every row's prompt are skipped (they would
    leave the state untouched).  ``rng`` and ``head_capacity`` go to
    :func:`finalize`."""
    _check_supported(comp)
    llama._check_supported(cfg, comp, quant)
    B, S = tokens.shape
    if S % chunk_size:
        raise ValueError(f"bucket {S} must divide into {chunk_size}-token chunks")
    tl = [int(n) for n in torch.as_tensor(true_len).tolist()]
    state = init_chunked_state(cfg, comp, B, S, tokens.device)
    for c0 in range(0, max(tl), chunk_size):
        chunk_step(params, cfg, tokens[:, c0:c0 + chunk_size], c0, tl, state)
    return finalize(params, cfg, comp, state, tl, cache_capacity, quant=quant, rng=rng,
                    head_capacity=head_capacity)
