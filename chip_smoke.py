#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build the port's CUDA kernels from ``kvcache_factory_tpu_torch/csrc``;
3. K1 (flash prefill + window scores) against its plain version, timed
   beside its plain version, SDPA and its bound; then K1's sliding-window
   and chunk (``row_offset``) variants the same, at the serving path's
   shapes and on edge shapes, with what an off-by-one window or offset
   would show; then K1's MInference variants, a-shape (K1-A) and
   vertical-slash (K1-VS), against the plain version with their block
   masks, with what ignoring the mask or shifting it by one block would
   show, timed at the MInference path's layer shape (32k) beside dense K1;
   with the edges of K1's 128-row CTA among the cases (true_len 1, 127,
   128, 129 and 4095 of 4096 rows, a 64-row observation window across a
   128-row boundary, a chunk offset of 2047, window edges mid-tile, a
   64-row a-shape block at S 1000), two launches held bitwise equal, and the
   window-score pass timed alone (profiler rows); then K5 (the row pack)
   bit for bit against its plain version at the selection probe's shapes,
   timed beside ``torch.gather`` and the port's ``select_and_pack``;
4. K2 (decode attention + in-place append) the same (also at the
   MInference path's 32.8k-entry cache), with the edges of its split
   rule (fewer keys than splits, ``lower == L``, all heads empty, one head
   at C-1 beside 63 empty ones, ``lengths == C``, a window edge mid-tile),
   G 3, 5, 6 and 7, two launches held bitwise equal, 20 CUDA-graph replays
   followed by an eager call that must match the plain version with every
   arrival counter back at 0, what a dropped split's partial would show,
   and a length sweep that splits its time into a fixed part and a
   streaming rate; K3 and K4 (the same over the per-token int8 and int4
   caches, with a bit-for-bit check of the quantized append), each one
   launch like K2, also with its split-rule and tile edges, G 3, 5, 6 and
   7, a range case (q past fp16's range, v_scale small enough that p *
   v_scale falls below fp16's smallest normal), two launches bitwise equal,
   20 graph replays with its counters back at 0, a dropped split, the
   MInference path's 32.8k-entry cache and a length sweep (their ptxas
   lines must show no spill and their SASS no int-to-float conversion);
   then all four kernels on small edge shapes against their plain versions;
5. the main path end to end at Mistral-7B-Instruct-v0.2 widths with random
   weights, three times: with the bf16 cache, with ``QuantConfig(nbits=8)``
   and with ``QuantConfig(nbits=4)``.  Each is one
   ``InferenceEngine.generate_batch`` on two requests, with every kernel's
   launch count set to 0 just before it and read just after, cache
   lengths, and logits held against the fp32 reference forward; then
   timings and a profile of prefill and decode;
5b. every compression policy on the main path: the same weights and two
   requests (16 new tokens) through ``InferenceEngine`` with snapkv, then
   pyramidkv, h2o, streamingllm, l2norm, random, adakv, headkv (capacities
   from a seeded head-score file), cam, think and snapkv with the LOOK-M
   pivot merge, then adakv over the int4 cache, each with every launch
   count set to 0 just before it: K1 and K2 (K4) launches, the score
   window K1 is handed (window scores for snapkv, pyramidkv, think, adakv
   and headkv only), every (layer, head, request) length against the
   method's budget rule, think's zeroed key channels, request (b)'s logits
   against the fp32 reference forward, K2 (K4) called directly on layers 0
   and 31 of the finished adakv and pyramidkv caches against the plain
   version, prefill and decode times, a profiled decode step of snapkv and
   adakv;
6. the serving path: ``ContinuousBatchingEngine`` at Mistral-7B-v0.1 widths
   (sliding window 4096) drains six long-prompt requests through four
   slots twice, with one-shot and with chunked admission, each drain with
   every launch count set to 0 just before it; first-token logits against
   the fp32 reference forward and against each other, greedy streams,
   cache lengths, drain time, admission stalls, decode time and idle share;
7. the MInference path: one 32000-token request through ``InferenceEngine``
   (bucket 32768, 32 new tokens) at Mistral-7B-Instruct-v0.2 widths three
   times, fullkv (dense K1), minference vertical-slash (K1-VS) and
   minference a-shape (K1-A), each with every launch count set to 0 just
   before it; prefill and decode times, profiles, mask densities, cache
   lengths, first-token logits against fullkv's; then a full-budget
   vertical-slash run against fullkv at 8192 tokens (logits within 1e-3,
   the same tokens);
8. the sequence-parallel path: K1-ml (``return_ml``) against its plain
   version (``out``, ``m``, ``l``) at the three ring hops of sp=2 over a
   32000-token prompt and on a sliding-window hop whose upper tiles have no
   key, with what a dropped key tile would show, two launches of a hop
   held bitwise equal, each hop timed beside its plain version, SDPA with
   a boolean mask and its bound (8a); the ring
   fold of every rank emulated in one process against K1 over the whole
   sequence (8b); then the 32000-token SnapKV request through
   ``InferenceEngine(ShardingConfig(sp=2))`` on two spawned ranks that share
   this card (gloo over a file rendezvous, K/V staged through pinned host
   memory), each rank's launch counts set to 0 just before it: K1-ml
   launches, cache lengths, ranks equal, first-token logits and the greedy
   stream against the single-device engine, prefill wall, bytes staged,
   decode ms/step (8c);
9. the checkpoint-to-score path at Qwen2-7B-Instruct widths (28 query and
   4 KV heads, G = 7; q/k/v biases; vocab 152064): (9a) a 4-layer
   checkpoint of random bf16 weights written in the HF layout (two shards
   and ``model.safetensors.index.json``, by a minimal safetensors writer
   here) and read back by ``load_params``: every leaf bitwise equal to the
   fused, transposed tensors built in memory, the native reader serving,
   and a SnapKV prefill on the two bitwise equal; (9b) at full depth,
   random bf16 weights and ``quantize_weights`` (W8A16) through
   ``InferenceEngine`` with phase 5's SnapKV and requests, once with the
   bf16 cache (K2) and once with the int8 cache (K3), then one fullkv
   request with each cache (K2 and K3 at G = 7), then the same requests with
   the bf16 weights, each with every launch count set to 0 just before it:
   launches, cache lengths, the last request's logits against the fp32
   reference forward of the dequantized weights, prefill and decode times, a
   profiled decode step; K1, K2 and K3 at G = 7 against their plain
   versions and timed; (9c) sampling on the W8A16 model (support,
   repeatability, temperature 1e-6 against greedy, no device-to-host copy
   per decode step, sampling's device time); (9d) the LongBench, RULER and
   Needle runners through the W8A16 engine on synthetic data with a
   byte-level tokenizer, then ``score_results_dir``: complete files with the
   JAX runners' keys, one prediction regenerated, wall per example;
10. the cache layer at Meta-Llama-3-8B-Instruct widths (32 / 8 heads, vocab
   128256, rope_theta 5e5), random bf16 weights, phase 5's two requests,
   each run with every launch count set to 0 just before it: (10a) the
   grouped quantized cache (nbits 2 with outliers and a 128-row fp ring,
   nbits 4 with the ring, nbits 3) through ``InferenceEngine`` beside the
   bf16 cache: K1 32 a prefill and no K2-K4 in decode, lengths, layers 0
   and 31 against the CPU's plain ``encode`` of the bf16 run's rows (codes
   apart only on rounding ties, ring rows bitwise), request (b)'s logits
   against the fp32 reference, times, cache bytes and bound; (10b) ThinK's
   channel-packed cache against in-place ThinK (K2): 77 kept channels,
   key bytes, logits; (10c) decode eviction through ``generate`` (capacity
   + 8, 64 new tokens): lengths, stamps, scores, evictions, logits against
   plain snapkv before the fill and the fp32 reference; (10d) the
   host-offloaded cache: pinned host K/V, the card's memory, the bytes a
   step copies from the profiler's trace, logits against the fp32
   reference and the device-resident decode; (10e) generation-state
   checkpoints of five caches, bitwise continuations, bytes and times;
   (10f) a ``ContinuousBatchingEngine`` drain over the nbits-2 cache; (10g)
   the SSM and encoder-decoder caches on the card bitwise against the CPU;
11. summary lines: one ``{"kernels": [...]}`` object, one end-to-end object,
   and last ``{"ok": true, "device": {...}}``.

Imports only torch, numpy and the port.  The full profiler tables go to
``build/chip_smoke.log`` (git-ignored) beside this script.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import json
import math
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import DeviceType

from kvcache_factory_tpu_torch import (CompressionConfig, EngineConfig, GenerationConfig,
                                       ModelConfig, QuantConfig, ShardingConfig)
from kvcache_factory_tpu_torch.cache import encdec_cache, quant_cache, ssm_cache
from kvcache_factory_tpu_torch.cache.kv_cache import KVCache
from kvcache_factory_tpu_torch.cache.offload_cache import LayerPrefetch, offload_kv_cache
from kvcache_factory_tpu_torch.cache.think_cache import ThinKCache
from kvcache_factory_tpu_torch.evals import longbench, needle, ruler, score
from kvcache_factory_tpu_torch.evals.longbench import headkv_capacities
from kvcache_factory_tpu_torch.models import llama
from kvcache_factory_tpu_torch.models.reference import forward_logits
from kvcache_factory_tpu_torch.models.weights import (WEIGHT_QUANT_KEYS, init_params, load_params,
                                                      quantize_weights)
from kvcache_factory_tpu_torch.ops.attention import NEG_INF
from kvcache_factory_tpu_torch.ops.kernels import (_build, decode_attn, decode_attn_quant,
                                                   flash_prefill, pack)
from kvcache_factory_tpu_torch.parallel.ring_attention import hop_visible, ring_attention_emulated
from kvcache_factory_tpu_torch.policies import cam
from kvcache_factory_tpu_torch.policies.base import select_and_pack
from kvcache_factory_tpu_torch.policies.minference import default_pattern
from kvcache_factory_tpu_torch.runtime import generate, native
from kvcache_factory_tpu_torch.runtime.batching import ContinuousBatchingEngine
from kvcache_factory_tpu_torch.runtime.checkpoint import (load_generation_state,
                                                          save_generation_state)
from kvcache_factory_tpu_torch.runtime.engine import InferenceEngine

LOG_PATH = Path(__file__).resolve().parent / "build" / "chip_smoke.log"
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

# The fields the forward reads from the published config.json of
# mistralai/Mistral-7B-Instruct-v0.2 (bf16 weights).
MISTRAL_7B_HF_CONFIG = {
    "model_type": "mistral", "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "max_position_embeddings": 32768, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-05, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
MISTRAL_7B = ModelConfig.from_hf_config(MISTRAL_7B_HF_CONFIG)
# mistralai/Mistral-7B-v0.1 (huggingface.co/mistralai/Mistral-7B-v0.1,
# config.json): the same widths with rope_theta 1e4 and a 4096-token
# sliding window, so the v0.2 weights fit it.
MISTRAL_7B_V01 = ModelConfig.from_hf_config({**MISTRAL_7B_HF_CONFIG, "rope_theta": 10000.0,
                                            "sliding_window": 4096})
# The JAX bench's compression (bench.py:68-73), one entry set per query head.
SNAPKV = CompressionConfig(method="snapkv", max_capacity_prompt=2048,
                           window_size=8, kernel_size=7, pooling="maxpool",
                           group_reduce="none")

# Tolerances, each with its reason.
# K1/K2 against their plain versions, measured as the worst relative L2
# distance ||kernel - plain|| / ||plain|| over each valid output row (K1) or
# each head's [G, D] output (K2).  Both sides compute fp32 logits from the
# same bf16 inputs, keep an fp32 softmax and round the output to bf16 (up to
# 2^-9 relative per element); K1 and its plain version also round the
# unnormalized probabilities to bf16 before the PV product.  Those roundings
# set the floor, and each limit sits above it and far below what a kernel
# that reads one key or one key tile too many or too few would show: the
# script measures that too and fails if such an error would pass.
# K1: the worst row on the card is 4.5e-3 (PERF.md); a skipped key tile
# shows 0.56.
K1_OUT_TOL = 1.5e-2
# K2: the kernel feeds its fp32 probabilities to the tensor cores as two
# bf16 halves (2^-17 relative), so the fp32 results differ by ~1e-5 and the
# outputs mostly where one side rounds to the next bf16 value; one such flip
# on an element three times the head's rms moves that head by
# ~3 * 2^-7.5 / sqrt(128) = 1.5e-3.  The worst head on the card is 7.6e-4
# (a head of few keys, where one flip is not averaged away); a key range off
# by one shows 7.7e-2, a dropped split 0.18.
K2_OUT_TOL = 3e-3
# Window scores are fp32 end to end from bf16-exact products; only the
# summation order differs (~1e-6 relative), on values in [0, window].
K1_SCORE_TOL = 1e-4
# The bf16 model against the fp32 reference: every activation is rounded to
# bf16 (2^-9 relative) at ~10 points per layer over 32 layers; independent
# roundings on the residual stream accumulate to ~2^-9 * sqrt(320) = 3.5%
# relative, so a logits row may differ by up to 10% in relative L2 norm.
E2E_REL_L2_TOL = 0.10
# K3/K4 against their plain versions, worst head rel L2 as for K2: both
# compute fp32 logits from the same codes and bf16 scalars (the kernel
# applies the scale and zero to the reduced dot, the plain version to each
# element first: ~1e-7 apart), keep an fp32 softmax and round the output to
# bf16, so K2's reasoning and limit hold: one bf16 flip on an element three
# times the head's rms is 1.5e-3.  K4 feeds its weights p * v_scale to the
# tensor cores as bf16 hi + lo, as K2 does, and K3 as fp16 hi + lo under a
# power of two (q in fp16 under another, exact); K4's worst head on the card
# is 1.3e-3 (a one-split head of few keys, PERF.md), an off-by-one key range
# shows 7.4e-2 and a dropped split 0.18.
KQ_OUT_TOL = 3e-3
# The quantized paths' decode logits against the fp32 reference, which
# keeps an unquantized cache.  Measured on the CPU, where the plain path is
# fp32 so only the quantization shows (tests/test_torch_quant_decode.py::
# test_quantized_decode_logits_near_fp32_reference: 2 layers, hidden 1024,
# a 600-token prompt, 16 steps): worst row 0.0215 (int8) and 0.2307 (int4).
# Per-token int4 keeps 16 levels over a token's whole range, so its logits
# move by a fifth.  The card adds the bf16 path's own 0.0166 (PERF.md).  The
# limits leave room for the wider, deeper model: int8 keeps the bf16 path's
# 0.10; int4 0.40.  A kernel that reads the wrong keys or values shows far
# more (its worst-head check against the plain version is 3e-3 above).
E2E_QUANT_REL_L2_TOL = {8: 0.10, 4: 0.40}
# Phase 10a's grouped caches, request (b)'s decode logits against the fp32
# reference.  Measured on the CPU before the first card run, where the plain
# path is fp32 so only the quantization shows (tests/
# test_torch_grouped_quant.py::test_grouped_decode_logits_near_fp32_reference:
# Llama-3-shaped, 2 layers, hidden 1024, a 600-token prompt, 16 steps): worst
# row 0.6997 (nbits 2, groups of 64, outliers, ring 128: three quarters of the
# rows at four levels a group), 0.1575 (nbits 4, ring 128) and 0.3503 (nbits
# 3).  Each limit is about 1.6-1.9 times that; logits that do not correlate
# with the reference at all sit near sqrt(2).
GROUPED_REL_L2_TOL = {"nbits2_outliers_ring128": 1.10, "nbits4_ring128": 0.30, "nbits3": 0.60}
# CAM's block solve against the sequential merge, both fp32 on the card:
# forward substitution adds the same terms in another order, each rounding
# by 2^-24 relative, so the two agree to ~1e-6 relative (1e-5 on the CPU,
# tests/test_torch_policies.py); the merge itself moves the values by O(1)
# (printed beside the check).
CAM_MERGE_TOL = 1e-4

# Chunked against one-shot admission, first-token logits rel L2.  Both are
# the bf16 path of one function, held each within 0.10 of fp32.  Where they
# round at other points (projections at another M, attention split into
# chunks) their distance is about sqrt(2) times one path's distance from fp32
# (0.0166 at 4096 tokens, PERF.md): ~0.025.  At this traffic the card gave
# bitwise-equal logits (PERF.md, serving-path findings).  The limit keeps the bf16
# budget, 0.10; a chunk at a wrong offset or without its window moves a row
# by O(1).
CHUNKED_VS_ONESHOT_TOL = 0.10


def log(*parts):
    print(*parts, flush=True)


def sync():
    torch.cuda.synchronize()


def event_ms(fn, iters=10, warmup=2):
    """Mean time per call with CUDA events around back-to-back calls."""
    for _ in range(warmup):
        fn()
    sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def graph_ms(calls, reps=10):
    """Device time per call: ``calls`` captured into one CUDA graph and
    replayed, so host launch overhead is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    sync()
    return start.elapsed_time(end) / (reps * len(calls))


def rel_l2(got, ref):
    """Worst relative L2 distance over rows (the last axis), and the max
    abs difference."""
    got, ref = got.float(), ref.float()
    rel = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    return rel, (got - ref).abs().max().item()


# ---------------------------------------------------------------------------
# Phase 3: K1
# ---------------------------------------------------------------------------


def bf16_normal(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to("cuda", torch.bfloat16)


def k1_case(rng, B, Hq, Hkv, S, W, tls):
    """K1 against its plain version on random inputs: ``out`` over each
    example's valid rows, ``scores`` over its scored columns."""
    D = 128
    q, k, v = (bf16_normal(rng, (B, h, S, D)) for h in (Hq, Hkv, Hkv))
    tl = torch.tensor(tls, dtype=torch.int32, device="cuda")
    out, sc = flash_prefill.flash_prefill_attention(q, k, v, tl, W)
    sync()
    out_ref, sc_ref = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, W)
    sync()
    err_out = abs_out = err_sc = 0.0
    for b, t in enumerate(tls):
        e, a = rel_l2(out[b, :, :t], out_ref[b, :, :t])
        err_out, abs_out = max(err_out, e), max(abs_out, a)
        if t - W > 0:
            err_sc = max(err_sc, (sc[b, :, :t - W] - sc_ref[b, :, :t - W]).abs().max().item())
    finite = all(torch.isfinite(x.float()).all() for x in (out, sc))
    log(f"K1 B={B} Hq={Hq} Hkv={Hkv} S={S} w={W} true_len={tls}: out worst row rel L2 "
        f"{err_out:.3e} (max abs {abs_out:.3e}) tol {K1_OUT_TOL}; scores max abs err "
        f"{err_sc:.3e} tol {K1_SCORE_TOL}; finite {finite}")
    if err_out > K1_OUT_TOL or err_sc > K1_SCORE_TOL or not finite:
        raise SystemExit("K1 disagrees with its plain version")
    return q, k, v, tl, sc, out_ref, err_out, abs_out, err_sc


def k1_skipped_tile_error(q, k, v, tls, out_ref, r0=2048):
    """What K1's check sees from a kernel that skips the key tile [64, 128)
    for the rows past ``r0``: the worst row rel L2 between such an output
    (plain fp32 math, example 0, head 0) and the plain version's."""
    t, D = tls[0], q.shape[-1]
    s = q[0, 0, r0:t].float() @ k[0, 0].float().T * D ** -0.5
    rows = torch.arange(r0, t, device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None]
    keep = (cols <= rows) & (cols < t) & ((cols < 64) | (cols >= 128))
    skipped = torch.softmax(torch.where(keep, s, float("-inf")), dim=-1) @ v[0, 0].float()
    return rel_l2(skipped, out_ref[0, 0, r0:t])[0]


def bitwise_repeat(call):
    """Whether two launches of ``call`` give bitwise-equal outputs."""
    first = call()
    second = call()
    sync()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def k1_pass_ms(call, reps=5):
    """Device time per call of K1's two kernels, the main pass and the
    window-score pass, from profiler rows; None where the profiler saw no
    device time."""
    call()
    sync()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        sync()
    times = dict.fromkeys(("flash_fwd_kernel", "window_scores_kernel"))
    for evt in prof.key_averages():
        for name in times:
            if evt.device_type == DeviceType.CUDA and name in evt.key:
                times[name] = evt.self_device_time_total / reps / 1e3
    return times


def time_k1(q, k, v, tl, W, tls, sc):
    """K1's time beside its plain version, SDPA and its bound (the work this
    call's data needs), as phase 3 times it."""
    D, Hq = q.shape[-1], q.shape[1]
    call = lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, W)  # noqa: E731
    ms = event_ms(call)
    plain_ms = event_ms(lambda: flash_prefill.flash_prefill_attention_reference(q, k, v, tl, W),
                        iters=3, warmup=1)
    lib_ms = event_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=True))
    flops = 4 * D * sum(t * (t + 1) // 2 for t in tls) * Hq
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * sc.numel()
    bound_ms, bound_by = max((flops / PEAK_BF16_FLOPS * 1e3, "operations"),
                             (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    log(f"K1 timed: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); {flops / ms / 1e9:.1f} TFLOP/s")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "tflops": flops / ms / 1e9}


def phase_k1(rng):
    B, Hq, Hkv, S, D, W = 2, 32, 8, 4096, 128, 8
    tls = [4096, 3000]
    q, k, v, tl, sc, out_ref, err_out, abs_out, err_sc = k1_case(rng, B, Hq, Hkv, S, W, tls)
    # The edges of the 128-row CTA: lengths at and around a tile boundary,
    # and a 64-row observation window across one (rows 992-1055, 1936-1999).
    edge_errs = [k1_case(rng, 5, 8, 2, S, W, [1, 127, 128, 129, 4095])[6:9],
                 k1_case(rng, 2, 8, 2, 2048, 64, [1056, 2000])[6:9]]
    call = lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, W)
    same = bitwise_repeat(call)
    log(f"K1 two launches at B={B} S={S}: out and scores bitwise equal {same}")
    if not same:
        raise SystemExit("K1 is not deterministic")
    skip_err = k1_skipped_tile_error(q, k, v, tls, out_ref)
    log(f"K1 a kernel that skipped key tile [64, 128) for rows >= 2048 would show row rel "
        f"L2 up to {skip_err:.3e} ({skip_err / K1_OUT_TOL:.1f} x tol)")
    if skip_err <= K1_OUT_TOL:
        raise SystemExit("K1's tolerance would let a skipped key tile pass")
    del out_ref

    t = time_k1(q, k, v, tl, W, tls, sc)
    ms = t["ms"]
    passes = k1_pass_ms(call)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa: E731
    log(f"K1 main pass {fmt(passes['flash_fwd_kernel'])}, window-score pass "
        f"{fmt(passes['window_scores_kernel'])} (profiled); {t['bound_ms'] / ms:.3f} of the "
        f"bound")
    return {"name": "flash_prefill", "route": "cuda",
            "source": flash_prefill.SOURCE, "replaces": flash_prefill.REPLACES,
            "shape": f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} w={W} true_len={tls}",
            "max_abs_err": abs_out, "rel_l2": err_out, "tol": K1_OUT_TOL,
            "skipped_tile_rel_l2": skip_err,
            "scores_max_abs_err": err_sc, "scores_tol": K1_SCORE_TOL,
            **t, "bound_fraction": t["bound_ms"] / ms, "main_pass_ms": passes["flash_fwd_kernel"],
            "score_pass_ms": passes["window_scores_kernel"], "deterministic": same,
            "edge_cases": [{"rel_l2": e, "max_abs_err": a, "scores_max_abs_err": s}
                           for e, a, s in edge_errs]}


# ---------------------------------------------------------------------------
# Phase 3b: K1's sliding-window and chunk (row_offset) variants
# ---------------------------------------------------------------------------


def k1v_valid_rows(S_q, tls, offsets):
    """[B, S_q] mask of the rows whose global id lies before true_len."""
    off = np.zeros(len(tls), np.int64) if offsets is None else np.asarray(offsets)
    return (off[:, None] + np.arange(S_q)[None]) < np.asarray(tls)[:, None]


def k1v_worst(got, ref, valid):
    """Worst row rel L2 and max abs difference over the valid rows."""
    worst = absd = 0.0
    for b in range(valid.shape[0]):
        rows = torch.from_numpy(np.nonzero(valid[b])[0]).to(got.device)
        if len(rows):
            e, a = rel_l2(got[b][:, rows], ref[b][:, rows])
            worst, absd = max(worst, e), max(absd, a)
    return worst, absd


def k1v_case(rng, B, Hq, Hkv, S_q, S_k, tls, sw, offsets):
    """K1 with a sliding window and/or a row offset against its plain
    version on random inputs: ``out`` over each example's valid rows (global
    id < true_len); every row, inert ones (true_len 0) included, finite."""
    D = 128
    q = bf16_normal(rng, (B, Hq, S_q, D))
    k, v = (bf16_normal(rng, (B, Hkv, S_k, D)) for _ in range(2))
    tl = torch.tensor(tls, dtype=torch.int32, device="cuda")
    off = None if offsets is None else torch.tensor(offsets, dtype=torch.int32,
                                                     device="cuda")
    kw = dict(sliding_window=sw, row_offset=off)
    out, _ = flash_prefill.flash_prefill_attention(q, k, v, tl, 0, **kw)
    sync()
    ref, _ = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, 0, **kw)
    sync()
    valid = k1v_valid_rows(S_q, tls, offsets)
    err, absd = k1v_worst(out, ref, valid)
    finite = bool(torch.isfinite(out.float()).all())
    log(f"K1 {flash_prefill.variant(sw, offsets)} B={B} Hq={Hq} Hkv={Hkv} S_q={S_q} "
        f"S_k={S_k} sw={sw} row_offset={offsets} true_len={tls}: out worst row rel L2 "
        f"{err:.3e} (max abs {absd:.3e}) tol {K1_OUT_TOL}; every row finite {finite}")
    if err > K1_OUT_TOL or not finite:
        raise SystemExit("K1's variant disagrees with its plain version")
    return dict(q=q, k=k, v=v, tl=tl, off=off, ref=ref, valid=valid, err=err, absd=absd)


def k1v_pairs(S_q, S_k, tls, sw, offsets):
    """Visible (row, column) pairs per query head that this data needs:
    valid row R sees the columns from max(R - SW + 1, 0) (0 without a
    window) to min(R, true_len - 1, S_k - 1)."""
    off = np.zeros(len(tls), np.int64) if offsets is None else np.asarray(offsets)
    tl = np.asarray(tls)[:, None]
    R = off[:, None] + np.arange(S_q)[None]
    first = 0 if sw is None else np.maximum(R - sw + 1, 0)
    seen = np.clip(np.minimum(np.minimum(R, tl - 1), S_k - 1) - first + 1, 0, None)
    return int(np.where(R < tl, seen, 0).sum())


def time_k1v(c, sw, offsets, ml=False):
    """Kernel (graph replay), plain (events) and SDPA-with-mask (graph
    replay) times of one call, and its bound; ``ml`` times K1-ml (the same
    call with ``return_ml``).  SDPA gets the same ``out`` as an explicit
    boolean [B, 1, S_q, S_k] mask, with K/V expanded to the query heads
    outside the timed call (it gives no ``(m, l)``)."""
    q, k, v, tl, off = c["q"], c["k"], c["v"], c["tl"], c["off"]
    B, Hq, S_q, D = q.shape
    S_k = k.shape[2]
    tls = tl.tolist()
    kw = dict(sliding_window=sw, row_offset=off, return_ml=ml)
    ms = graph_ms([lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, 0, **kw)] * 5)
    plain_ms = event_ms(lambda: flash_prefill.flash_prefill_attention_reference(
        q, k, v, tl, 0, **kw), iters=2, warmup=1)
    G = Hq // k.shape[1]
    ke, ve = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    offs = torch.zeros(B, dtype=torch.int64, device="cuda") if off is None else off.long()
    rows = offs[:, None, None] + torch.arange(S_q, device="cuda")[None, :, None]
    cols = torch.arange(S_k, device="cuda")[None, None]
    mask = (cols <= rows) & (cols < tl.long()[:, None, None])
    if sw is not None:
        mask &= cols > rows - sw
    mask = mask[:, None]
    lib_ms = graph_ms([lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)] * 5)
    del ke, ve, mask
    pairs = k1v_pairs(S_q, S_k, tls, sw, None if off is None else off.tolist()) * Hq
    flops = 4 * D * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + (8 * B * Hq * S_q if ml else 0)
    bound_ms, bound_by = max((flops / PEAK_BF16_FLOPS * 1e3, "operations"),
                             (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    log(f"K1 {flash_prefill.variant(sw, off, None, ml)} timed at B={B} Hq={Hq} S_q={S_q} "
        f"S_k={S_k} sw={sw} row_offset={None if off is None else off.tolist()} "
        f"true_len={tls}: kernel {ms:.4f} ms (graph replay), plain {plain_ms:.4f} ms, "
        f"SDPA with a boolean mask {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
        f"{pairs / 1e6:.1f} M visible pairs); {flops / ms / 1e9:.1f} TFLOP/s, "
        f"{bound_ms / ms:.3f} of the bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "visible_pairs": pairs, "tflops": flops / ms / 1e9,
            "bound_fraction": bound_ms / ms}


def k1v_off_by_one(c, sw, offsets, what):
    """What the check sees from a kernel whose window is one column too wide
    or narrow (``what="window"``) or whose row offset is one row off
    (``"offset"``): the smaller of the two worst-row rel L2 distances of the
    plain version so shifted from the plain version's output."""
    q, k, v, tl, ref, valid = c["q"], c["k"], c["v"], c["tl"], c["ref"], c["valid"]
    worst = []
    for d in (-1, 1):
        if what == "window":
            kw = dict(sliding_window=sw + d, row_offset=c["off"])
        else:
            kw = dict(sliding_window=sw, row_offset=c["off"] + d)
        off, _ = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, 0, **kw)
        worst.append(k1v_worst(off, ref, valid)[0])
    return min(worst)


def phase_k1_variants(rng):
    """K1-SW and K1-chunk against their plain versions at the serving
    path's shapes and on edge shapes, their off-by-one sensitivity, and
    their times."""
    S, SW = 8192, 4096
    # K1-SW: whole-sequence queries under Mistral-7B-v0.1's window.
    sw = k1v_case(rng, 2, 32, 8, S, S, [8192, 5000], SW, None)
    # K1-chunk: a pool of four 2048-row chunks over 8192-row buffers at
    # three prefill depths, the last row inert, with and without the window.
    chunk_args = (4, 32, 8, 2048, S, [8192, 7000, 6500, 0])
    offsets = [0, 2048, 6144, 0]
    ch = k1v_case(rng, *chunk_args, SW, offsets)
    ch_dense = k1v_case(rng, *chunk_args, None, offsets)
    # Edge shapes: offsets no multiple of a 64-row warpgroup or a 128-row
    # CTA, S_k no multiple of 64, chunks shorter than a CTA, windows shorter
    # than a 128-key tile and
    # longer than the sequence, inert rows.
    for sw_e in (None, 17, 50):
        k1v_case(rng, 2, 8, 2, 96, 300, [300, 120], sw_e, [100, 37])
        k1v_case(rng, 3, 4, 4, 32, 200, [200, 190, 0], sw_e, [0, 160, 64])
    for sw_e in (17, 1000):
        k1v_case(rng, 2, 8, 2, 200, 200, [200, 77], sw_e, None)
    # The 128-row CTA's edges: an offset no multiple of 128, window edges
    # in the middle of a key tile.
    for sw_e in (None, 200):
        k1v_case(rng, 2, 8, 2, 300, 4096, [4096, 2200], sw_e, [2047, 1999])
    for sw_e in (200, 333):
        k1v_case(rng, 1, 8, 2, 1000, 1000, [1000], sw_e, None)
    # Off-by-one sensitivity.  At SW 4096 one column more or less moves a
    # row by about 1/4096 of its norm, under any limit that bf16 rounding
    # allows, so the window is held at SW 64, where the same code runs; the
    # row offset is held at the chunk shape (its depth-0 chunk's first rows
    # see one or two columns).
    sens = k1v_case(rng, 1, 8, 2, 1024, 1024, [1024], 64, None)
    win_err = k1v_off_by_one(sens, 64, None, "window")
    off_err = k1v_off_by_one(ch, SW, offsets, "offset")
    log(f"K1 variants: a window off by one column would show row rel L2 {win_err:.3e} "
        f"({win_err / K1_OUT_TOL:.1f} x tol, at SW 64); a row offset off by one "
        f"{off_err:.3e} ({off_err / K1_OUT_TOL:.1f} x tol)")
    if win_err <= K1_OUT_TOL or off_err <= K1_OUT_TOL:
        raise SystemExit("K1's tolerance would let an off-by-one window or offset pass")
    del sens
    for c in (sw, ch, ch_dense):
        del c["ref"]

    # Times: the serving path's one-shot prefill of one 8192-token request
    # (B=1), the check shape above (B=2), and the pooled chunk.
    main = k1v_case(rng, 1, 32, 8, S, S, [8192], SW, None)
    del main["ref"]
    t_sw = time_k1v(main, SW, None)
    t_sw2 = time_k1v(sw, SW, None)
    t_ch = time_k1v(ch, SW, offsets)
    t_ch_dense = time_k1v(ch_dense, None, offsets)
    entry = lambda name, var, shape, c, t, **extra: {
        "name": name, "route": "cuda", "source": flash_prefill.SOURCE,
        "replaces": flash_prefill.REPLACES_VARIANT[var], "shape": shape,
        "max_abs_err": c["absd"], "rel_l2": c["err"], "tol": K1_OUT_TOL, **t, **extra}
    return (entry("flash_prefill_sliding_window", "sliding_window",
                  f"B=1 Hq=32 Hkv=8 S={S} D=128 sw={SW} true_len=[8192]", main, t_sw,
                  window_off_by_one_rel_l2=win_err, check_rel_l2=sw["err"],
                  b2={"shape": "B=2 true_len=[8192, 5000]", **t_sw2}),
            entry("flash_prefill_chunk", "chunk",
                  f"P=4 Hq=32 Hkv=8 S_q=2048 S_k={S} D=128 sw={SW} row_offset={offsets} "
                  f"true_len={chunk_args[5]}", ch, t_ch,
                  offset_off_by_one_rel_l2=off_err,
                  no_window={"rel_l2": ch_dense["err"], **t_ch_dense}))


# ---------------------------------------------------------------------------
# Phase 3c: K1's MInference variants (a-shape, vertical-slash)
# ---------------------------------------------------------------------------

ASHAPE = ("ashape", 1, 2, 8)
VS_DEFAULT = default_pattern()  # ("vertical_slash", 1024, 128, 64)
SPARSE_ID = {"ashape": "K1-A", "vertical_slash": "K1-VS"}


def density(mask):
    """Share of the causal (q block, k block) pairs that a block mask keeps,
    over its examples and heads."""
    n = mask.shape[-1]
    causal = torch.ones(n, n, dtype=torch.bool, device=mask.device).tril()
    return mask[..., causal].float().mean().item()


def block_pairs(n, block, t):
    """[n, n] visible (row, column) pairs of one example and head in each
    (q block, k block): rows below ``t``, columns at or before the row."""
    rows = np.arange(min(n * block, t))
    j0 = np.arange(n) * block
    seen = np.clip(np.minimum(rows[:, None], j0 + block - 1) - j0 + 1, 0, block)
    table = np.zeros((n, n), np.int64)
    np.add.at(table, rows // block, seen)
    return table


def masked_bound(mask, block, tls, nbytes, D=128):
    """The visible pairs inside the selected blocks of this run's mask, and
    the bound: their QK and PV products at the bf16 peak, or the bytes."""
    pairs = 0
    for b, t in enumerate(tls):
        table = torch.from_numpy(block_pairs(mask.shape[-1], block, t)).to(mask.device)
        pairs += int((mask[b].long() * table).sum().item())
    flops = 4 * D * pairs
    return pairs, max((flops / PEAK_BF16_FLOPS * 1e3, "operations"),
                      (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))


@contextlib.contextmanager
def mask_hook(fixed=None):
    """Intercepts the block-mask build of K1's wrapper (which looks
    ``flash_prefill.sparse_block_mask`` up at each call).  Without ``fixed``
    each mask built is kept (device tensors, no host read) with its build's
    device time (CUDA events); with ``fixed = (mask, block)`` the wrapper
    takes that mask instead of building one, so that a timing holds the
    kernel alone."""
    masks, events = [], []
    orig = flash_prefill.sparse_block_mask

    def hook(*args, **kwargs):
        if fixed is not None:
            return fixed
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = orig(*args, **kwargs)
        end.record()
        masks.append(out[0])
        events.append((start, end))
        return out

    flash_prefill.sparse_block_mask = hook
    try:
        yield masks, events
    finally:
        flash_prefill.sparse_block_mask = orig


def k1s_inputs(rng, B, Hq, Hkv, S, heavy=None):
    """bf16 q, k, v.  With ``heavy = (c0, c1)`` the estimated vertical-slash
    mask is sparse: q and k are halved (logit noise about 0.25), and every
    query favours the keys [c0, c1) by 1.5 in its logits through channel 0
    (4 in q, 4.24 in those keys, 0 in the others).  On random inputs the
    lognormal tail of the column sums puts a few of the top 1024 columns in
    every block, and the mask comes out dense."""
    D = 128
    q, k, v = (bf16_normal(rng, (B, h, S, D)) for h in (Hq, Hkv, Hkv))
    if heavy is not None:
        q, k = q * 0.5, k * 0.5
        q[..., 0] = 4.0
        k[..., 0] = 0.0
        k[:, :, heavy[0]:heavy[1], 0] = 4.24
    return q, k, v


def k1s_case(q, k, v, tls, pattern, window=0, sw=None, budgets=None, q_block=None):
    """K1 with a sparse pattern against its plain version given the same
    block mask: ``out`` over each example's valid rows, ``scores`` over its
    scored columns."""
    B, Hq, S, _ = q.shape
    tl = torch.tensor(tls, dtype=torch.int32, device="cuda")
    out, sc = flash_prefill.flash_prefill_attention(
        q, k, v, tl, window, sliding_window=sw, sparse_pattern=pattern,
        sparse_head_budgets=budgets, q_block=q_block)
    sync()
    mask, block = flash_prefill.sparse_block_mask(q, k, tl, pattern, budgets, q_block)
    ref, sc_ref = flash_prefill.flash_prefill_attention_reference(
        q, k, v, tl, window, sliding_window=sw, block_mask=mask, block=block)
    sync()
    valid = k1v_valid_rows(S, tls, None)
    err, absd = k1v_worst(out, ref, valid)
    err_sc = 0.0
    for b, t in enumerate(tls):
        if window and t - window > 0:
            err_sc = max(err_sc, (sc[b, :t - window] - sc_ref[b, :t - window]).abs().max().item())
    finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(sc).all())
    dens = density(mask)
    log(f"{SPARSE_ID[flash_prefill.pattern_kind(pattern)]} {pattern} B={B} Hq={Hq} "
        f"Hkv={k.shape[1]} S={S} block={block} w={window} sw={sw} budgets="
        f"{'per head' if budgets is not None else None} true_len={tls}: mask keeps {dens:.3f} "
        f"of the causal block pairs; out worst row rel L2 {err:.3e} (max abs {absd:.3e}) tol "
        f"{K1_OUT_TOL}; scores max abs err {err_sc:.3e} tol {K1_SCORE_TOL}; finite {finite}")
    if err > K1_OUT_TOL or err_sc > K1_SCORE_TOL or not finite:
        raise SystemExit("K1's sparse variant disagrees with its plain version")
    return dict(kind=flash_prefill.pattern_kind(pattern), q=q, k=k, v=v, tl=tl, sw=sw,
                mask=mask, block=block, ref=ref, valid=valid, err=err, absd=absd, density=dens)


def k1s_mask_errors(c):
    """What the check sees from a kernel that ignores the block mask (dense)
    or reads it shifted by one block: the worst row rel L2 of each such
    output (plain version) from the plain version's."""
    q, k, v, tl, sw = c["q"], c["k"], c["v"], c["tl"], c["sw"]
    dense, _ = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, 0, sliding_window=sw)
    shifted, _ = flash_prefill.flash_prefill_attention_reference(
        q, k, v, tl, 0, sliding_window=sw, block_mask=torch.roll(c["mask"], 1, dims=-1),
        block=c["block"])
    return k1v_worst(dense, c["ref"], c["valid"])[0], k1v_worst(shifted, c["ref"], c["valid"])[0]


def time_k1s(q, k, v, tls, pattern):
    """At one shape: the kernel alone (its mask built beforehand), held
    against the plain version given the same mask over the valid rows, the
    mask build, the plain version, SDPA with the boolean mask that the block
    mask and causality give, and the bound; ``pattern`` None is dense K1
    against causal SDPA."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    tl = torch.tensor(tls, dtype=torch.int32, device="cuda")
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    if pattern is None:
        mask, block, mask_ms = torch.ones((B, Hq, 1, 1), dtype=torch.int32, device="cuda"), S, None
        plain_mask = dict()
    else:
        mask_ms = event_ms(lambda: flash_prefill.sparse_block_mask(q, k, tl, pattern),
                           iters=3, warmup=1)
        mask, block = flash_prefill.sparse_block_mask(q, k, tl, pattern)
        plain_mask = dict(block_mask=mask, block=block)
    n = mask.shape[-1]
    with mask_hook((mask, block)):
        kern = lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, 0,
                                                             sparse_pattern=pattern)
        out = kern()[0]
        ms = event_ms(kern, iters=3, warmup=1)
    # The plain version's output is kept from its timed call.
    held = {}

    def plain():
        held["ref"] = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, 0,
                                                                      **plain_mask)[0]

    plain_ms = event_ms(plain, iters=1, warmup=1)
    err, absd = k1v_worst(out, held["ref"], k1v_valid_rows(S, tls, None))
    finite = bool(torch.isfinite(out.float()).all())
    del out, held
    if pattern is None:
        lib_ms = event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters=3, warmup=1)
        lib_note = "causal SDPA, GQA (flash), true_len not masked"
    else:
        # SDPA with the [S, S] boolean mask of each head group: one call when
        # every head shares the mask (a-shape), else one call per KV head
        # (the 32-head mask of a 32k prompt does not fit in 80 GB with its
        # bf16 conversion), summed.
        rows = torch.arange(S, device="cuda")
        seen = (rows[None] <= rows[:, None]) & (rows[None] < tls[0])
        groups = [(0, Hq)] if bool((mask == mask[:, :1]).all()) else \
            [(g * (Hq // Hkv), (g + 1) * (Hq // Hkv)) for g in range(Hkv)]
        lib_ms = 0.0
        for h0, h1 in groups:
            blk = mask[0, h0:h1] if len(groups) > 1 else mask[0, :1]
            m = blk.bool().repeat_interleave(block, 1)[:, :S].repeat_interleave(block, 2)[:, :, :S]
            m = (m & seen)[None]
            kk = k[:, h0 // (Hq // Hkv):(h1 - 1) // (Hq // Hkv) + 1].repeat_interleave(
                Hq // Hkv, dim=1)
            vv = v[:, h0 // (Hq // Hkv):(h1 - 1) // (Hq // Hkv) + 1].repeat_interleave(
                Hq // Hkv, dim=1)
            qq = q[:, h0:h1]
            lib_ms += event_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=m),
                               iters=2, warmup=1)
            del m, kk, vv
        lib_note = (f"SDPA with a boolean mask, {len(groups)} call(s) of "
                    f"{groups[0][1] - groups[0][0]} heads")
    pairs, (bound_ms, bound_by) = masked_bound(mask, block, tls, nbytes, D)
    name = "K1" if pattern is None else SPARSE_ID[flash_prefill.pattern_kind(pattern)]
    dens = density(mask) if pattern is not None else 1.0
    log(f"{name} timed at B={B} Hq={Hq} S={S} true_len={tls}{'' if pattern is None else f', {pattern}, block {block}, mask keeps {dens:.4f} of the {n * (n + 1) // 2} causal block pairs'}: "
        f"kernel {ms:.4f} ms, mask build {mask_ms if mask_ms is None else round(mask_ms, 4)} ms, "
        f"plain {plain_ms:.2f} ms, {lib_note} {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, {pairs / 1e6:.1f} M visible pairs); {4 * D * pairs / ms / 1e9:.1f} TFLOP/s, "
        f"{bound_ms / ms:.3f} of the bound; "
        f"against the plain version out worst row rel L2 {err:.3e} (max abs {absd:.3e}) tol "
        f"{K1_OUT_TOL}; finite {finite}")
    if err > K1_OUT_TOL or not finite:
        raise SystemExit(f"{name} disagrees with its plain version at the path's layer shape")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "library": lib_note,
            "bound_ms": bound_ms, "bound_by": bound_by, "mask_ms": mask_ms, "density": dens,
            "visible_pairs": pairs, "tflops": 4 * D * pairs / ms / 1e9,
            "bound_fraction": bound_ms / ms, "path_shape_rel_l2": err, "path_shape_max_abs_err": absd}


def phase_k1_sparse(rng):
    """K1-A and K1-VS against their plain versions, on the check shapes and
    edge shapes, what a kernel that ignored or shifted the mask would show,
    and their times at the MInference path's layer shape beside dense K1."""
    S, Hq, Hkv, tls = 8192, 32, 8, [8192, 6000]
    q, k, v = k1s_inputs(rng, 2, Hq, Hkv, S)
    a = k1s_case(q, k, v, tls, ASHAPE)
    qh, kh, vh = k1s_inputs(rng, 2, Hq, Hkv, S, heavy=(1024, 2048))
    vs = k1s_case(qh, kh, vh, tls, VS_DEFAULT)
    budgets = torch.from_numpy(np.stack([rng.integers(1, 1025, Hq), rng.integers(0, 129, Hq)],
                                        axis=1)).to("cuda", torch.int32)
    vsb = k1s_case(qh, kh, vh, tls, VS_DEFAULT, budgets=budgets)
    sanity = {}
    for name, c in (("K1-A", a), ("K1-VS", vs)):
        dense_err, shift_err = k1s_mask_errors(c)
        log(f"{name}: a kernel that ignored the block mask would show row rel L2 "
            f"{dense_err:.3e} ({dense_err / K1_OUT_TOL:.1f} x tol); one that read it shifted by "
            f"one block {shift_err:.3e} ({shift_err / K1_OUT_TOL:.1f} x tol)")
        if min(dense_err, shift_err) <= 2 * K1_OUT_TOL:
            raise SystemExit(f"{name}'s tolerance would let an ignored or shifted mask pass")
        sanity[name] = {"ignored_mask_rel_l2": dense_err, "shifted_mask_rel_l2": shift_err}
    cases = [a, vs, vsb]
    del q, k, v, qh, kh, vh
    # Edge shapes: S no multiple of the 1024 block, a sliding window, window
    # scores of the sparse softmax, a 64-row pattern block.
    for pattern in (ASHAPE, VS_DEFAULT):
        heavy = None if pattern is ASHAPE else (1024, 2048)
        q, k, v = k1s_inputs(rng, 2, 8, 2, 5000, heavy)
        cases.append(k1s_case(q, k, v, [5000, 3001], pattern))
        q, k, v = k1s_inputs(rng, 1, 8, 2, 8192, heavy)
        cases.append(k1s_case(q, k, v, [8192], pattern, sw=4096))
        q, k, v = k1s_inputs(rng, 2, 8, 2, 8192, heavy)
        cases.append(k1s_case(q, k, v, [8192, 6001], pattern, window=8))
        q, k, v = k1s_inputs(rng, 2, 8, 2, 1000, None if heavy is None else (64, 128))
        small = pattern if pattern is ASHAPE else ("vertical_slash", 64, 16, 64)
        cases.append(k1s_case(q, k, v, [1000, 777], small, window=8, q_block=64))
        del q, k, v
    # 64-row blocks under 128-row CTAs: each CTA spans two q blocks and each
    # key tile two k blocks, selected apart.
    q, k, v = k1s_inputs(rng, 2, 8, 2, 1000)
    cases.append(k1s_case(q, k, v, [1000, 777], ("ashape", 1, 3, 4), q_block=64))
    del q, k, v
    # The worst (row rel L2, max abs) of each variant over its cases.
    worst = {kind: max((c["err"], c["absd"]) for c in cases if c["kind"] == kind)
             for kind in SPARSE_ID}
    densities = [vs["density"], vsb["density"]]
    del cases, a, vs, vsb

    # Times at the MInference path's layer shape (one 32000-token prompt in
    # the 32768 bucket), each kernel held against its plain version there.
    # Vertical-slash takes planted inputs: on random ones its mask keeps
    # every block and the kernel runs dense K1's tiles.
    q, k, v = k1s_inputs(rng, 1, Hq, Hkv, 32768)
    t_dense = time_k1s(q, k, v, [32000], None)
    t_a = time_k1s(q, k, v, [32000], ASHAPE)
    del q, k, v
    q, k, v = k1s_inputs(rng, 1, Hq, Hkv, 32768, heavy=(1024, 2048))
    t_vs = time_k1s(q, k, v, [32000], VS_DEFAULT)
    del q, k, v
    torch.cuda.empty_cache()
    for kind, t in (("ashape", t_a), ("vertical_slash", t_vs)):
        worst[kind] = max(worst[kind], (t["path_shape_rel_l2"], t["path_shape_max_abs_err"]))
    shape = "B=1 Hq=32 Hkv=8 S=32768 D=128 true_len=[32000], block 1024"
    entry = lambda kind, t, **extra: {
        "name": f"flash_prefill_{kind}", "route": "cuda", "source": flash_prefill.SOURCE,
        "replaces": flash_prefill.REPLACES_VARIANT[kind], "shape": shape,
        "max_abs_err": worst[kind][1], "rel_l2": worst[kind][0], "tol": K1_OUT_TOL,
        **sanity[SPARSE_ID[kind]], **t, **extra}
    return (entry("ashape", t_a, pattern=list(ASHAPE)),
            entry("vertical_slash", t_vs, pattern=list(VS_DEFAULT),
                  check_density=densities[0], budgets_density=densities[1]),
            t_dense)


# ---------------------------------------------------------------------------
# Phase 3d: K5, the row pack of the selection probe
# ---------------------------------------------------------------------------

K5_SHAPES = tuple((S, C) for S in (4096, 8192, 32768) for C in (128, 2048))


def probe_pack(kv, scores, C):
    """The selection probe's pack (``tools/bench_select.py``'s
    ``pallas_full``): the top C ids by a stable descending sort, then K5."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :C]
    return pack.pack_rows(kv, idx.to(torch.int32))


def phase_k5(rng):
    """The probe at H 32, K|V rows of 256 bf16 channels: every shape once
    with the launch count set to 0 just before; then K5 bit for bit against
    its plain version (with ids outside [0, S) too) and timed beside it,
    ``torch.gather``, the port's ``select_and_pack`` and its byte bound."""
    H, D2 = 32, 256
    data = {S: (bf16_normal(rng, (H, S, D2)),
                torch.from_numpy(rng.standard_normal((H, S), np.float32)).cuda())
            for S in sorted({S for S, _ in K5_SHAPES})}
    sync()
    pack.pack_rows.launches = 0
    for S, C in K5_SHAPES:
        probe_pack(*data[S], C)
    sync()
    launches = pack.pack_rows.launches
    log(f"K5 launches on the probe ({len(K5_SHAPES)} shapes): {launches}")
    if launches != len(K5_SHAPES):
        raise SystemExit("the probe did not run K5 once per shape")
    rows = []
    for S, C in K5_SHAPES:
        kv, scores = data[S]
        idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :C] \
            .to(torch.int32).contiguous()
        out_of_range = idx.clone()
        at = torch.from_numpy(rng.integers(0, C, size=(H, 4))).cuda()
        out_of_range.scatter_(1, at, torch.tensor([-1, S, S + 5, -1000], dtype=torch.int32,
                                                  device="cuda").expand(H, 4).contiguous())
        apart = 0
        for ids in (idx, out_of_range):
            got, want = pack.pack_rows(kv, ids), pack.pack_rows_reference(kv, ids)
            apart += int((got.view(torch.int16) != want.view(torch.int16)).sum().item())
        if apart:
            raise SystemExit(f"K5 differs from its plain version at S={S} C={C}: "
                             f"{apart} elements apart")
        gidx = idx.long()[:, :, None].expand(H, C, D2)
        k_, v_ = kv[..., :D2 // 2].contiguous(), kv[..., D2 // 2:].contiguous()
        budget = torch.full((H,), C - 8, dtype=torch.int64, device="cuda")
        tl, nc = torch.tensor(S, device="cuda"), torch.tensor(False, device="cuda")
        ms = graph_ms([lambda: pack.pack_rows(kv, idx)] * 20)
        plain_ms = graph_ms([lambda: pack.pack_rows_reference(kv, idx)] * 5)
        lib_ms = graph_ms([lambda: torch.gather(kv, 1, gidx)] * 20)
        probe_ms = event_ms(lambda: probe_pack(kv, scores, C), iters=10)
        shipped_ms = event_ms(lambda: select_and_pack(k_, v_, scores, budget, 8, tl, C, nc),
                              iters=10)
        nbytes = 2 * 2 * H * C * D2 + 4 * H * C
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"K5 S={S} C={C}: bitwise equal to its plain version (ids out of range too); "
            f"kernel {ms * 1e3:.2f} us (graph replay), plain {plain_ms * 1e3:.2f} us, "
            f"torch.gather {lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us (bytes, "
            f"{nbytes / 1e6:.2f} MB); probe (sort + K5) {probe_ms * 1e3:.1f} us, shipped "
            f"select_and_pack {shipped_ms * 1e3:.1f} us")
        rows.append({"S": S, "C": C, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "probe_ms": probe_ms, "shipped_ms": shipped_ms})
        del gidx, k_, v_
    del data
    main = rows[-1]
    return {"name": "pack_rows", "route": "cuda", "source": pack.SOURCE,
            "replaces": pack.REPLACES, "launches": launches,
            "shape": f"H={H} S={main['S']} C={main['C']} D2={D2} bf16",
            "max_abs_err": 0.0, "bitwise": True,
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes", "library": "torch.gather", "probe": rows}


# ---------------------------------------------------------------------------
# Phase 4: K2
# ---------------------------------------------------------------------------


def k2_case(rng, H, G, C, lengths, lower):
    """K2 against its plain version: ``out``, and the whole cache after the
    in-place append, which must be identical."""
    D = 128
    q, kc, vc, kn, vn = (bf16_normal(rng, s) for s in ((H, G, D), (H, C, D), (H, C, D),
                                                       (H, D), (H, D)))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    lo = torch.tensor(lower, dtype=torch.int32, device="cuda")
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out = decode_attn.decode_attention_append(q, k1, v1, lens, kn, vn, lo)
    ref = decode_attn.decode_attention_append_reference(q, k2, v2, lens, kn, vn, lo)
    sync()
    err, abs_err = rel_l2(out.reshape(H, -1), ref.reshape(H, -1))
    slot_ok = torch.equal(k1, k2) and torch.equal(v1, v2)
    log(f"K2 H={H} G={G} C={C}: out worst head rel L2 {err:.3e} (max abs {abs_err:.3e}) "
        f"tol {K2_OUT_TOL}; cache after append identical: {slot_ok}")
    if err > K2_OUT_TOL or not slot_ok or not torch.isfinite(out.float()).all():
        raise SystemExit("K2 disagrees with its plain version")
    return q, kc, vc, kn, vn, lens, lo, ref, err, abs_err


def k2_one_key_off_error(q, kc, vc, kn, vn, lens, ref):
    """What K2's check sees from a kernel whose key range is off by one:
    one that drops slot L-1 (the plain version at lengths - 1) and one that
    also reads the stale slot L (at lengths + 1).  The smaller of the two
    worst head rel L2 distances from the plain version's output."""
    H = q.shape[0]
    worst = []
    for shift in (-1, 1):
        off = decode_attn.decode_attention_append_reference(
            q, kc.clone(), vc.clone(), lens + shift, kn, vn)
        worst.append(rel_l2(off.reshape(H, -1), ref.reshape(H, -1))[0])
    return min(worst)


def k2_dropped_split_error(q, kc, vc, kn, vn, lens, ref):
    """What K2's check sees from a kernel that drops one split's partial:
    the plain math without the keys of the middle split of each head (the
    split rule of ``decode_attn.split_bounds`` at this shape's n_split),
    as the worst head rel L2 from the plain version's output."""
    H, G, D = q.shape
    C = kc.shape[1]
    n_split = decode_attn.split_count(H, C, decode_attn._sm_count(q.device))
    L = lens.long().clamp(max=C - 1)
    start, end = decode_attn.split_bounds(0, L, n_split // 2, n_split)
    heads = torch.arange(H, device=q.device)
    k, v = kc.float(), vc.float()
    k[heads, L], v[heads, L] = kn.float(), vn.float()
    idx = torch.arange(C, device=q.device)[None]
    dropped = (idx >= start[:, None]) & (idx < end[:, None])
    keep = ((idx < L[:, None]) & ~dropped) | (idx == L[:, None])
    logits = torch.einsum("hgd,hcd->hgc", q.float(), k) * D ** -0.5
    probs = torch.softmax(torch.where(keep[:, None], logits, NEG_INF), dim=-1)
    out = torch.einsum("hgc,hcd->hgd", probs, v).to(q.dtype)
    return rel_l2(out.reshape(H, -1), ref.reshape(H, -1))[0], n_split


def k2_split_edges(rng):
    """The edges of K2's split rule (CTA sp of n_split takes the sp-th part
    of its head's valid keys [lower, L)), each against the plain version:
    a range shorter than n_split, ``lower == L``, ``lengths == C``, a window
    ``lower`` mid-tile, all heads empty, one head at C-1 beside 63 empty
    ones; then G 3, 5, 6 and 7 (1, 2, 4 and 8 are in phase 4's other
    cases)."""
    C, H = 2113, 64
    n_split = decode_attn.split_count(H, C, decode_attn._sm_count(torch.device("cuda")))
    lengths = rng.integers(1, C, size=H)
    lower = np.zeros(H, np.int64)
    lengths[0], lower[0] = 500, 500 - (n_split - 1)     # fewer keys than splits
    lengths[1], lower[1] = 700, 700                     # lower == L: no cache key
    lengths[2] = C                                      # full: overwrite slot C-1
    lengths[3], lower[3] = 2079, 1000 + 7               # a window edge mid-tile
    lengths[4], lower[4] = 2079, 2078                   # one key
    errs = [k2_case(rng, H, 1, C, lengths, lower)[8]]
    errs.append(k2_case(rng, H, 1, C, [0] * H, np.zeros(H, np.int64))[8])
    errs.append(k2_case(rng, H, 1, C, [C - 1] + [0] * (H - 1), np.zeros(H, np.int64))[8])
    # G 4 with 33 splits a head: heads shorter than, equal to and one past it.
    errs.append(k2_case(rng, 8, 4, C, [20, 0, 32, 33, 34, C, C - 1, 1000],
                        [0, 0, 0, 0, 1, 0, 0, 993])[8])
    groups = {}
    for G, Hg in ((3, 16), (5, 8), (6, 8), (7, 8)):
        lens = rng.integers(1, C, size=Hg)
        low = np.zeros(Hg, np.int64)
        low[0] = lens[0] // 3
        groups[G] = k2_case(rng, Hg, G, C, lens, low)[8]
    log(f"K2 split edges (n_split {n_split} at H={H}): worst head rel L2 {max(errs):.3e}; "
        f"by G: {groups}")
    return {"n_split": n_split, "edges_rel_l2": max(errs), "groups_rel_l2": groups}


def k2_repeat_and_replay(q, kc, vc, kn, vn, lens):
    """Two launches bitwise equal; 20 CUDA-graph replays of a launch in a
    row, then one eager call that must match the plain version and every
    arrival counter back at 0."""
    H = q.shape[0]

    def call():
        k, v = kc.clone(), vc.clone()
        return decode_attn.decode_attention_append(q, k, v, lens, kn, vn), k, v

    bitwise = bitwise_repeat(call)
    k_g, v_g = kc.clone(), vc.clone()
    call_g = lambda: decode_attn.decode_attention_append(q, k_g, v_g, lens, kn, vn)  # noqa: E731
    graph_ms([call_g], reps=20)
    sync()
    zero_after_graph = bool((decode_attn._counters(q.device, H) == 0).all())
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out = decode_attn.decode_attention_append(q, k1, v1, lens, kn, vn)
    ref = decode_attn.decode_attention_append_reference(q, k2, v2, lens, kn, vn)
    sync()
    err = rel_l2(out.reshape(H, -1), ref.reshape(H, -1))[0]
    zero_after = bool((decode_attn._counters(q.device, H) == 0).all())
    log(f"K2 two launches bitwise equal: {bitwise}; after 20 graph replays the counters are "
        f"all 0: {zero_after_graph}, an eager call after them: head rel L2 {err:.3e} tol "
        f"{K2_OUT_TOL}, counters all 0: {zero_after}")
    if not (bitwise and zero_after_graph and zero_after) or err > K2_OUT_TOL:
        raise SystemExit("K2 is not repeatable or leaves its arrival counters set")
    return {"bitwise_repeat": bitwise, "after_replay_rel_l2": err}


def time_k2(q, kc, vc, kn, vn, lens):
    """Kernel, plain and SDPA times for one decode layer, and its bound.
    Four copies of the layer (each above 30 MB; together above the 50 MB
    L2) rotate so that each call reads its cache from HBM, as the decode
    step does.  Device times come from CUDA-graph replay, so host launch
    overhead is not in them; ``wrapper_ms`` is the eager call with it."""
    H, C, D = kc.shape
    copies = [(kc.clone(), vc.clone()) for _ in range(4)]

    def kern(i):
        return lambda: decode_attn.decode_attention_append(q, copies[i][0], copies[i][1],
                                                           lens, kn, vn)

    def plain(i):
        return lambda: decode_attn.decode_attention_append_reference(
            q, copies[i][0], copies[i][1], lens, kn, vn)

    mask = (torch.arange(C, device="cuda")[None] <= lens[:, None].long())[None, :, None]

    def lib(i):
        return lambda: F.scaled_dot_product_attention(
            q[None], copies[i][0][None], copies[i][1][None], attn_mask=mask)

    ms = graph_ms([kern(i) for i in range(4)] * 5)
    wrapper_ms = event_ms(kern(0), iters=50, warmup=5)
    plain_ms = graph_ms([plain(i) for i in range(4)] * 2)
    lib_ms = graph_ms([lib(i) for i in range(4)] * 5)
    # Bytes this call must move: the valid K/V rows read once; q, k_new,
    # v_new read and out plus the appended K/V row written; lengths read.
    n_keys = int(lens.sum().item())
    nbytes = 2 * D * 2 * n_keys + 2 * D * H * (q.shape[1] * 2 + 2 + 2) + 4 * H
    flops = 4 * D * q.shape[1] * (n_keys + H)
    bound_ms, bound_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                             (flops / PEAK_BF16_FLOPS * 1e3, "operations"))
    log(f"K2 H={H} timed: kernel {ms * 1e3:.2f} us (device, graph replay), wrapper "
        f"{wrapper_ms * 1e3:.2f} us (events, host launch included), plain "
        f"{plain_ms * 1e3:.2f} us, SDPA {lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by}); {nbytes / ms / 1e6:.1f} GB/s")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def k2_sweep(rng, H=64, C=2113, lengths=(0, 256, 1024, 2079)):
    """K2's device time at H heads all holding each of ``lengths`` keys,
    and the least-squares line through them: the intercept is the cost of
    a launch that reads no key (start, merge, the gap between two launches
    in a graph), the slope the rate at which it streams K/V."""
    D = 128
    q, kn, vn = (bf16_normal(rng, s) for s in ((H, 1, D), (H, D), (H, D)))
    copies = [(bf16_normal(rng, (H, C, D)), bf16_normal(rng, (H, C, D))) for _ in range(4)]
    points = []
    for n in lengths:
        lens = torch.full((H,), n, dtype=torch.int32, device="cuda")
        calls = [lambda k=k, v=v: decode_attn.decode_attention_append(q, k, v, lens, kn, vn)
                 for k, v in copies]
        points.append((2 * D * 2 * n * H, graph_ms(calls * 5)))
    nbytes, ms = np.array(points, dtype=np.float64).T
    slope, fixed_ms = np.polyfit(nbytes, ms, 1)
    rate = 1 / slope / 1e9  # TB/s
    log(f"K2 sweep, H={H} C={C}, keys a head {list(lengths)}: "
        f"{[round(t * 1e3, 2) for t in ms]} us; fixed {fixed_ms * 1e3:.2f} us, "
        f"streaming {rate:.2f} TB/s")
    del copies
    return {"lengths": list(lengths), "us": [t * 1e3 for t in ms], "fixed_us": fixed_ms * 1e3,
            "stream_tb_s": rate}


def phase_k2(rng):
    C, D = 2113, 128  # the engine's capacity: 2048 + 64 new tokens + 1
    # One request's 32 cache heads: ragged, one lower-bounded, empty, full.
    H = 32
    lengths = rng.integers(1, C, size=H)
    lengths[0], lengths[1], lengths[2] = 0, C, C - 1  # empty, full (clamp), last slot
    lower = np.zeros(H, np.int64)
    lower[3] = lengths[3] // 2                          # one lower-bounded head
    q, kc, vc, kn, vn, lens, _, _, err, abs_err = k2_case(rng, H, 1, C, lengths, lower)
    err4 = k2_case(rng, 8, 4, C, lengths[:8], lower[:8])[8]
    # The bound at one request, every head holding the compressed prompt
    # plus 32 decoded tokens.
    b1 = time_k2(q, kc, vc, kn, vn, torch.full((H,), 2048 + 32, dtype=torch.int32,
                                               device="cuda"))

    # The main path's shape: B=2 requests x 32 cache heads, half-way through
    # decode (2048 + 31 and 1500 + 31 valid entries).
    Hm = 64
    mid = [2048 + 31] * 32 + [1500 + 31] * 32
    q, kc, vc, kn, vn, lens, _, ref, err_m, abs_m = k2_case(rng, Hm, 1, C, mid,
                                                             np.zeros(Hm, np.int64))
    off_err = k2_one_key_off_error(q, kc, vc, kn, vn, lens, ref)
    log(f"K2 a kernel whose key range is off by one would show head rel L2 up to "
        f"{off_err:.3e} ({off_err / K2_OUT_TOL:.1f} x tol)")
    if off_err <= K2_OUT_TOL:
        raise SystemExit("K2's tolerance would let an off-by-one key range pass")
    drop_err, n_split = k2_dropped_split_error(q, kc, vc, kn, vn, lens, ref)
    checks = {"dropped_split_rel_l2": drop_err, **k2_repeat_and_replay(q, kc, vc, kn, vn, lens),
              **k2_split_edges(rng)}
    main = time_k2(q, kc, vc, kn, vn, lens)
    # The MInference path's shape: one request's 8 KV heads (G 4) over the
    # engine's 32801-slot cache (bucket 32768 + 32 new + 1) at the last
    # step's 32000 + 31 entries.
    C_long = MINF_BUCKET + MINF_NEW + 1
    q, kc, vc, kn, vn, lens, _, ref, err_l, abs_l = k2_case(
        rng, 8, 4, C_long, [MINF_PROMPT + MINF_NEW - 1] * 8, np.zeros(8, np.int64))
    drop_long, n_long = k2_dropped_split_error(q, kc, vc, kn, vn, lens, ref)
    log(f"K2 a kernel that drops one split's partial would show head rel L2 {drop_err:.3e} "
        f"(1 of {n_split} splits, H={Hm}) and {drop_long:.3e} (1 of {n_long}, H=8 G=4 "
        f"C={C_long}); tol {K2_OUT_TOL}")
    if min(drop_err, drop_long) <= K2_OUT_TOL:
        raise SystemExit("K2's tolerance would let a dropped split pass")
    long = time_k2(q, kc, vc, kn, vn, lens)
    sweep = k2_sweep(rng)
    return {"name": "decode_attn_append", "route": "cuda",
            "source": decode_attn.SOURCE, "replaces": decode_attn.REPLACES,
            "shape": f"H={Hm} (B=2 x 32) G=1 C={C} D={D}, lengths 2079 and 1531",
            "max_abs_err": max(abs_err, abs_m, abs_l), "rel_l2": max(err, err_m, err_l),
            "tol": K2_OUT_TOL, "g4_rel_l2": err4, "off_by_one_rel_l2": off_err, **checks,
            "dropped_split_rel_l2_minference": drop_long, "sweep": sweep, **main,
            "b1": {"shape": f"H={H} G=1 C={C} D={D}, lengths 2080", **b1},
            "minference": {"shape": f"H=8 G=4 C={C_long} D={D}, lengths "
                                    f"{MINF_PROMPT + MINF_NEW - 1}", "rel_l2": err_l, **long}}


# ---------------------------------------------------------------------------
# Phase 4b: K3 and K4
# ---------------------------------------------------------------------------

# nbits -> (id, wrapper, plain version, the engine's capacity at the main shape)
QUANT = {8: ("K3", decode_attn_quant.quant_decode_attention_append,
             decode_attn_quant.quant_decode_attention_append_reference, 2176),
         4: ("K4", decode_attn_quant.quant4_decode_attention_append,
             decode_attn_quant.quant4_decode_attention_append_reference, 2304)}


# The range K3's fp16 products must survive (tests/test_torch_quant_decode.py,
# the range case): standard deviations of q, K and V that put q's entries
# past fp16's 65504 and p * v_scale below fp16's smallest normal.
KQ_RANGE = (3e4, 1e-4, 2e-4)


def kq_inputs(rng, nbits, H, G, C, amp=(1.0, 1.0, 1.0)):
    """bf16 q, k_new, v_new and a layer quantized from random bf16 K/V:
    codes [H, C, D or D/2] and scales [H, C, 4].  ``amp`` scales q, K and
    V (with k_new and v_new)."""
    D = 128
    q, k, v, kn, vn = ((bf16_normal(rng, s).float() * a).to(torch.bfloat16)
                       for s, a in (((H, G, D), amp[0]), ((H, C, D), amp[1]),
                                    ((H, C, D), amp[2]), ((H, D), amp[1]), ((H, D), amp[2])))
    kc, ks, kz = quant_cache.encode_per_token(k, nbits)
    vc, vs, vz = quant_cache.encode_per_token(v, nbits)
    return q, kc, vc, torch.stack([ks, kz, vs, vz], dim=-1).contiguous(), kn, vn


def kq_case(rng, nbits, H, G, C, lengths, lower, amp=(1.0, 1.0, 1.0)):
    """K3 or K4 against its plain version: ``out``, and the whole cache after
    the in-place quantized append, which must be identical byte for byte
    (both sides quantize the new token with the same IEEE operations)."""
    kid, kernel, plain, _ = QUANT[nbits]
    q, kc, vc, sc, kn, vn = kq_inputs(rng, nbits, H, G, C, amp)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    lo = torch.tensor(lower, dtype=torch.int32, device="cuda")
    mine = [kc.clone(), vc.clone(), sc.clone()]
    theirs = [kc.clone(), vc.clone(), sc.clone()]
    out = kernel(q, *mine, lens, kn, vn, lo)
    ref = plain(q, *theirs, lens, kn, vn, lo)
    sync()
    err, abs_err = rel_l2(out.reshape(H, -1), ref.reshape(H, -1))
    apart = [int((a != b).sum().item()) for a, b in zip(mine, theirs)]
    log(f"{kid} H={H} G={G} C={C}: out worst head rel L2 {err:.3e} (max abs {abs_err:.3e}) "
        f"tol {KQ_OUT_TOL}; bytes apart after the append (k codes, v codes, scalars): "
        f"{apart}")
    if any(apart):
        for name, a, b in zip(("k codes", "v codes", "scalars"), mine, theirs):
            where = (a != b).nonzero()[:4].tolist()
            log(f"  {name} apart at {where}: kernel "
                f"{[a[tuple(i)].item() for i in where]}, plain {[b[tuple(i)].item() for i in where]}")
        raise SystemExit(f"{kid}'s quantized append differs from its plain version's")
    if err > KQ_OUT_TOL or not torch.isfinite(out.float()).all():
        raise SystemExit(f"{kid} disagrees with its plain version")
    return q, kc, vc, sc, kn, vn, lens, ref, err, abs_err


def kq_one_key_off_error(nbits, q, kc, vc, sc, kn, vn, lens, ref):
    """What the check sees from a kernel whose key range is off by one (the
    plain version at lengths - 1 and + 1): the smaller worst head rel L2."""
    plain, H = QUANT[nbits][2], q.shape[0]
    worst = []
    for shift in (-1, 1):
        off = plain(q, kc.clone(), vc.clone(), sc.clone(), lens + shift, kn, vn)
        worst.append(rel_l2(off.reshape(H, -1), ref.reshape(H, -1))[0])
    return min(worst)


def time_kq(nbits, q, kc, vc, sc, kn, vn, lens):
    """Kernel, plain and composite times for one decode layer, and its
    bound.  Copies of the layer, 150 MB or more together (three times the
    L2), rotate so that each call reads its cache from HBM.  Device times
    come from CUDA-graph replay; ``wrapper_ms`` is the eager call.  No one
    PyTorch call attends over int8 or int4 codes: the yardstick is a
    two-call composite, dequantize the cache to bf16, then SDPA with a
    boolean mask."""
    _, kernel, plain, _ = QUANT[nbits]
    H, C, W = kc.shape
    G, D = q.shape[1], q.shape[2]
    per_copy = 2 * kc.numel() + 2 * sc.numel()
    n = max(4, -(-150_000_000 // per_copy))
    copies = [(kc.clone(), vc.clone(), sc.clone()) for _ in range(n)]

    def kern(i):
        return lambda: kernel(q, *copies[i], lens, kn, vn)

    def plain_call(i):
        return lambda: plain(q, *copies[i], lens, kn, vn)

    mask = (torch.arange(C, device="cuda")[None] <= lens[:, None].long())[None, :, None]

    def composite(i):
        def call():
            c_k, c_v, c_s = copies[i]
            k = quant_cache.dequantize(c_k, c_s[..., 0], c_s[..., 1], nbits).to(torch.bfloat16)
            v = quant_cache.dequantize(c_v, c_s[..., 2], c_s[..., 3], nbits).to(torch.bfloat16)
            return F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=mask)
        return call

    ms = graph_ms([kern(i) for i in range(n)] * max(1, 20 // n))
    wrapper_ms = event_ms(kern(0), iters=50, warmup=5)
    plain_ms = graph_ms([plain_call(i) for i in range(n)])
    composite_ms = graph_ms([composite(i) for i in range(n)])
    # Bytes this call must move: the valid code rows and their four bf16
    # scalars read once; q, k_new, v_new read and out plus the appended row
    # and its scalars written; lengths read.  Operations: the QK and PV
    # products, 2 x 2 x D per key, query row and head.
    n_keys = int(torch.clamp(lens, max=C - 1).sum().item())
    nbytes = n_keys * (2 * W + 8) + H * (2 * D * (2 * G + 2) + 2 * W + 8 + 4)
    ops = 4 * D * G * (n_keys + H)
    bound_ms, bound_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                             (ops / PEAK_INT8_OPS * 1e3, "operations"))
    log(f"{QUANT[nbits][0]} H={H} timed: kernel {ms * 1e3:.2f} us (device, graph replay), "
        f"wrapper {wrapper_ms * 1e3:.2f} us (events, host launch included), plain "
        f"{plain_ms * 1e3:.2f} us, composite (dequantize + SDPA) {composite_ms * 1e3:.2f} us, "
        f"bound {bound_ms * 1e3:.2f} us ({bound_by}, {nbytes / 1e6:.2f} MB); "
        f"{nbytes / ms / 1e6:.1f} GB/s")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "composite_ms": composite_ms}


def phase_kq(rng, nbits):
    kid, _, _, C = QUANT[nbits]
    D = 128
    # One request's 32 cache heads: ragged, one lower-bounded, empty, full.
    H = 32
    lengths = rng.integers(1, C, size=H)
    lengths[0], lengths[1], lengths[2] = 0, C, C - 1
    lower = np.zeros(H, np.int64)
    lower[3] = lengths[3] // 2
    q, kc, vc, sc, kn, vn, _, _, err, abs_err = kq_case(rng, nbits, H, 1, C, lengths, lower)
    err4 = kq_case(rng, nbits, 8, 4, C, lengths[:8], lower[:8])[8]
    b1 = time_kq(nbits, q, kc, vc, sc, kn, vn,
                 torch.full((H,), 2048 + 32, dtype=torch.int32, device="cuda"))

    # The main path's shape: B=2 requests x 32 cache heads at the final
    # lengths of the decode (2048 + 31 and 1500 + 31 before the last step).
    Hm = 64
    final = [2048 + 31] * 32 + [1500 + 31] * 32
    q, kc, vc, sc, kn, vn, lens, ref, err_m, abs_m = kq_case(rng, nbits, Hm, 1, C, final,
                                                             np.zeros(Hm, np.int64))
    off_err = kq_one_key_off_error(nbits, q, kc, vc, sc, kn, vn, lens, ref)
    log(f"{kid} a kernel whose key range is off by one would show head rel L2 up to "
        f"{off_err:.3e} ({off_err / KQ_OUT_TOL:.1f} x tol)")
    if off_err <= KQ_OUT_TOL:
        raise SystemExit(f"{kid}'s tolerance would let an off-by-one key range pass")
    extra = kq_checks(rng, nbits, C, q, kc, vc, sc, kn, vn, lens, ref)
    main = time_kq(nbits, q, kc, vc, sc, kn, vn, lens)
    return {"name": f"quant{nbits}_decode_attn_append", "route": "cuda",
            "source": decode_attn_quant.SOURCE, "replaces": decode_attn_quant.REPLACES[nbits],
            "shape": f"H={Hm} (B=2 x 32) G=1 C={C} D={D} int{nbits}, lengths "
                     f"{final[0]} and {final[-1]}",
            "max_abs_err": max(abs_err, abs_m), "rel_l2": max(err, err_m),
            "tol": KQ_OUT_TOL, "g4_rel_l2": err4, "off_by_one_rel_l2": off_err,
            "append_bit_identical": True, **extra, **main,
            "b1": {"shape": f"H={H} G=1 C={C} D={D}, lengths 2080", **b1}}


def kq_dropped_split_error(nbits, q, kc, vc, sc, kn, vn, lens, ref):
    """What K3's or K4's check sees from a kernel that drops one split's partial:
    the plain math without the keys of the middle split of each head (the
    split rule of ``decode_attn.split_bounds`` at this shape's n_split), as
    the worst head rel L2 from the plain version's output."""
    H, G, D = q.shape
    C = kc.shape[1]
    n_split = decode_attn.split_count(H, C, decode_attn._sm_count(q.device))
    L = lens.long().clamp(max=C - 1)
    start, end = decode_attn.split_bounds(0, L, n_split // 2, n_split)
    k = quant_cache.dequantize(kc, sc[..., 0], sc[..., 1], nbits)
    v = quant_cache.dequantize(vc, sc[..., 2], sc[..., 3], nbits)
    idx = torch.arange(C, device=q.device)[None]
    keep = (idx < L[:, None]) & ~((idx >= start[:, None]) & (idx < end[:, None]))
    qs = q.float() * D ** -0.5
    logits = torch.where(keep[:, None], torch.einsum("hgd,hcd->hgc", qs, k), NEG_INF)
    s_new = torch.einsum("hgd,hd->hg", qs, kn.float())[..., None]
    probs = torch.softmax(torch.cat([logits, s_new], dim=-1), dim=-1)
    out = (torch.einsum("hgc,hcd->hgd", probs[..., :C], v)
           + probs[..., C:] * vn.float()[:, None]).to(q.dtype)
    return rel_l2(out.reshape(H, -1), ref.reshape(H, -1))[0], n_split


def kq_split_edges(rng, nbits, C):
    """The edges of K3's or K4's split rule and tiles, each against the plain
    version with the append byte for byte: a range shorter than n_split,
    ``lower == L``, ``lengths == C``, a window ``lower`` mid-tile, one key,
    all heads empty, one head at C-1 beside 63 empty ones, 8 heads of G 4
    around their split count; one split a head (H = 2 CTAs an SM x SMs) with
    ranges at the edges of a 16-key tile, a warp's stage and a CTA's stage;
    then G 3, 5, 6 and 7 (1, 2, 4 and 8 are in phase 4b's other cases)."""
    H, sm = 64, decode_attn._sm_count(torch.device("cuda"))
    n_split = decode_attn.split_count(H, C, sm)
    lengths = rng.integers(1, C, size=H)
    lower = np.zeros(H, np.int64)
    lengths[0], lower[0] = 500, 500 - (n_split - 1)     # fewer keys than splits
    lengths[1], lower[1] = 700, 700                     # lower == L: no cache key
    lengths[2] = C                                      # full: overwrite slot C-1
    lengths[3], lower[3] = 2079, 1000 + 7               # a window edge mid-tile
    lengths[4], lower[4] = 2079, 2078                   # one key
    errs = [kq_case(rng, nbits, H, 1, C, lengths, lower)[8]]
    errs.append(kq_case(rng, nbits, H, 1, C, [0] * H, np.zeros(H, np.int64))[8])
    errs.append(kq_case(rng, nbits, H, 1, C, [C - 1] + [0] * (H - 1), np.zeros(H, np.int64))[8])
    n8 = decode_attn.split_count(8, C, sm)
    errs.append(kq_case(rng, nbits, 8, 4, C, [n8 - 13, 0, n8 - 1, n8, n8 + 1, C, C - 1, 1000],
                        [0, 0, 0, 0, 1, 0, 0, 993])[8])
    Hs = decode_attn.CTAS_PER_SM * sm  # one CTA a head: the whole range is one CTA's
    edges = [1, 15, 16, 17, 63, 64, 65, 255, 256, 257, 511, 512, 513, 767, 768, 769]
    lens = np.asarray((edges * (Hs // len(edges) + 1))[:Hs])
    low = np.zeros(Hs, np.int64)
    low[len(edges):2 * len(edges)] = 3                  # the same edges, shifted by a lower bound
    lens[len(edges):2 * len(edges)] += 3
    errs.append(kq_case(rng, nbits, Hs, 1, 1024, lens, low)[8])
    groups = {}
    for G, Hg in ((3, 16), (5, 8), (6, 8), (7, 8)):
        lens = rng.integers(1, C, size=Hg)
        low = np.zeros(Hg, np.int64)
        low[0] = lens[0] // 3
        groups[G] = kq_case(rng, nbits, Hg, G, C, lens, low)[8]
    log(f"{QUANT[nbits][0]} split edges (n_split {n_split} at H={H}): worst head rel L2 "
        f"{max(errs):.3e}; "
        f"by G: {groups}")
    return {"n_split": n_split, "edges_rel_l2": max(errs), "groups_rel_l2": groups}


def kq_repeat_and_replay(nbits, q, kc, vc, sc, kn, vn, lens):
    """Two launches bitwise equal (out and the appended cache); 20 CUDA-graph
    replays of a launch in a row, then one eager call that must match the
    plain version, with every arrival counter back at 0 after both."""
    kid, kernel, plain, _ = QUANT[nbits]
    H = q.shape[0]

    def call():
        c = [kc.clone(), vc.clone(), sc.clone()]
        return (kernel(q, *c, lens, kn, vn), *c)

    bitwise = bitwise_repeat(call)
    c_g = [kc.clone(), vc.clone(), sc.clone()]
    graph_ms([lambda: kernel(q, *c_g, lens, kn, vn)], reps=20)
    sync()
    zero_after_graph = bool((decode_attn._counters(q.device, H) == 0).all())
    mine = [kc.clone(), vc.clone(), sc.clone()]
    theirs = [kc.clone(), vc.clone(), sc.clone()]
    out = kernel(q, *mine, lens, kn, vn)
    ref = plain(q, *theirs, lens, kn, vn)
    sync()
    err = rel_l2(out.reshape(H, -1), ref.reshape(H, -1))[0]
    same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
    zero_after = bool((decode_attn._counters(q.device, H) == 0).all())
    log(f"{kid} two launches bitwise equal: {bitwise}; after 20 graph replays the counters are "
        f"all 0: {zero_after_graph}, an eager call after them: head rel L2 {err:.3e} tol "
        f"{KQ_OUT_TOL}, append identical {same}, counters all 0: {zero_after}")
    if not (bitwise and zero_after_graph and zero_after and same) or err > KQ_OUT_TOL:
        raise SystemExit(f"{kid} is not repeatable or leaves its arrival counters set")
    return {"bitwise_repeat": bitwise, "after_replay_rel_l2": err}


def kq_sweep(rng, nbits, H=64, lengths=(0, 256, 1024, 2079)):
    """K3's or K4's device time at H heads all holding each of ``lengths``
    keys (at the main path's capacity), and the least-squares line through
    them: the intercept is the cost of a launch that reads no key, the slope
    the rate at which it streams codes and scalars (264 or 136 bytes a
    key)."""
    kid, kernel, _, C = QUANT[nbits]
    q, kc, vc, sc, kn, vn = kq_inputs(rng, nbits, H, 1, C)
    n = max(4, -(-150_000_000 // (2 * kc.numel() + 2 * sc.numel())))
    copies = [(kc.clone(), vc.clone(), sc.clone()) for _ in range(n)]
    points = []
    for keys in lengths:
        lens = torch.full((H,), keys, dtype=torch.int32, device="cuda")
        calls = [lambda c=c: kernel(q, *c, lens, kn, vn) for c in copies]
        points.append((keys * H * (2 * kc.shape[2] + 8), graph_ms(calls * max(1, 20 // n))))
    nbytes, ms = np.array(points, dtype=np.float64).T
    slope, fixed_ms = np.polyfit(nbytes, ms, 1)
    rate = 1 / slope / 1e9  # TB/s
    log(f"{kid} sweep, H={H} C={C}, keys a head {list(lengths)}: "
        f"{[round(t * 1e3, 2) for t in ms]} us; fixed {fixed_ms * 1e3:.2f} us, "
        f"streaming {rate:.2f} TB/s")
    del copies
    return {"lengths": list(lengths), "us": [t * 1e3 for t in ms], "fixed_us": fixed_ms * 1e3,
            "stream_tb_s": rate}


def kq_checks(rng, nbits, C, q, kc, vc, sc, kn, vn, lens, ref):
    """K3's or K4's one-launch checks at the main shape (``q`` ... ``ref``
    from it), the range case there, then the MInference path's shape (H 8,
    G 4 over 32k) checked and timed, and the length sweep."""
    kid = QUANT[nbits][0]
    drop_err, n_split = kq_dropped_split_error(nbits, q, kc, vc, sc, kn, vn, lens, ref)
    checks = {"dropped_split_rel_l2": drop_err,
              **kq_repeat_and_replay(nbits, q, kc, vc, sc, kn, vn, lens),
              **kq_split_edges(rng, nbits, C)}
    # The range case at the main shape: q past fp16's range, p * v_scale
    # below its smallest normal (KQ_RANGE).
    checks["range_rel_l2"] = kq_case(rng, nbits, q.shape[0], 1, C, lens.tolist(),
                                     np.zeros(q.shape[0], np.int64), KQ_RANGE)[8]
    # One request's 8 KV heads (G 4) over the engine's 32801-slot cache at
    # the last step's 32000 + 31 entries: the shape of a long-context int4
    # user (the fullkv path of phase 7 with a quantized cache).
    C_long = MINF_BUCKET + MINF_NEW + 1
    q, kc, vc, sc, kn, vn, lens, ref, err_l, abs_l = kq_case(
        rng, nbits, 8, 4, C_long, [MINF_PROMPT + MINF_NEW - 1] * 8, np.zeros(8, np.int64))
    drop_long, n_long = kq_dropped_split_error(nbits, q, kc, vc, sc, kn, vn, lens, ref)
    log(f"{kid} a kernel that drops one split's partial would show head rel L2 {drop_err:.3e} "
        f"(1 of {n_split} splits, H=64) and {drop_long:.3e} (1 of {n_long}, H=8 G=4 "
        f"C={C_long}); tol {KQ_OUT_TOL}")
    if min(drop_err, drop_long) <= KQ_OUT_TOL:
        raise SystemExit(f"{kid}'s tolerance would let a dropped split pass")
    long = time_kq(nbits, q, kc, vc, sc, kn, vn, lens)
    return {**checks, "dropped_split_rel_l2_minference": drop_long, "sweep": kq_sweep(rng, nbits),
            "minference": {"shape": f"H=8 G=4 C={C_long} D=128 int{nbits}, lengths "
                                    f"{MINF_PROMPT + MINF_NEW - 1}", "rel_l2": err_l,
                           "max_abs_err": abs_l, **long}}


def phase_edges(rng):
    """Small shapes that the main path does not reach but the wrappers
    accept, each against the plain version.  K1: a length that is no
    multiple of a 128-row CTA or its 64-row warpgroups, a window longer than
    a prompt, no window,
    the largest window, one query head per KV head.  K2, K3 and K4: a
    one-slot cache, a full cache, a lower bound past the length, a capacity
    that is no multiple of 16, and the group sizes 2 and 8."""
    for B, Hq, Hkv, S, W, tls in ((2, 4, 4, 200, 8, [200, 5]),
                                  (1, 8, 2, 130, 0, [97]),
                                  (1, 4, 1, 192, 64, [150])):
        k1_case(rng, B, Hq, Hkv, S, W, tls)
    shapes = ((2, 1, 1, [0, 1], [0, 0]),
              (3, 2, 17, [17, 3, 9], [0, 5, 12]),
              (2, 8, 300, [299, 150], [10, 0]))
    for H, G, C, lengths, lower in shapes:
        k2_case(rng, H, G, C, lengths, lower)
        for nbits in QUANT:
            kq_case(rng, nbits, H, G, C, lengths, lower)


# ---------------------------------------------------------------------------
# Phase 5: end to end
# ---------------------------------------------------------------------------


# The kernel wrappers whose launches the main path counts, by id.
COUNTED = {"K1": flash_prefill.flash_prefill_attention,
           "K2": decode_attn.decode_attention_append,
           "K3": decode_attn_quant.quant_decode_attention_append,
           "K4": decode_attn_quant.quant4_decode_attention_append,
           "K5": pack.pack_rows}
PATHS = (("bf16", None), ("int8", QuantConfig(nbits=8)), ("int4", QuantConfig(nbits=4)))


def phase_e2e(rng, log_file):
    """The main path with each cache, over one set of weights and prompts;
    returns the weights and prompts too, which the policy runs reuse, and
    the serving path the weights (Mistral-7B-v0.1 has the same shapes)."""
    cfg, dev = MISTRAL_7B, "cuda"
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    sync()
    n_params = sum(t.numel() for t in [params["embed"], params["final_norm"], params["lm_head"]]
                   + list(params["layers"].values()))
    log(f"init_params: {n_params / 1e9:.3f} B parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (4096, 1500)]
    return params, prompts, {label: drive_path(params, n_params, prompts, quant, log_file)
                             for label, quant in PATHS}


def drive_path(params, n_params, prompts, quant, log_file):
    """One ``generate_batch`` of the two requests with the bf16 cache
    (``quant`` None) or a per-token quantized one, checked and timed."""
    cfg, comp, dev = MISTRAL_7B, SNAPKV, "cuda"
    L = cfg.num_hidden_layers
    label = "bf16" if quant is None else f"int{quant.nbits}"
    decode_id = "K2" if quant is None else QUANT[quant.nbits][0]
    log(f"== main path, {label} cache")
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=comp, quant=quant),
                             device=dev)
    max_new = 64

    for wrapper in COUNTED.values():
        wrapper.launches = 0
    ids, res = engine.generate_batch(prompts, max_new, return_result=True)
    sync()
    launches = {kid: wrapper.launches for kid, wrapper in COUNTED.items()}
    steps = max_new - 1  # the last token is emitted, never fed back
    expect = dict.fromkeys(COUNTED, 0)
    expect["K1"], expect[decode_id] = L, L * steps
    log(f"launches on the main path ({label}): {launches}; expect K1 {L}, "
        f"{decode_id} {L} x {steps} = {L * steps}, the others 0")
    if launches != expect:
        raise SystemExit("the main path did not run each kernel the expected number of times")
    if quant is not None:
        cls = quant_cache.Int8KVCache if quant.nbits == 8 else quant_cache.Int4KVCache
        C = QUANT[quant.nbits][3]
        log(f"cache: {type(res.cache).__name__}, capacity {res.cache.capacity} "
            f"(expect {cls.__name__}, {C})")
        if not isinstance(res.cache, cls) or res.cache.capacity != C:
            raise SystemExit("the engine built the wrong cache")
    lens = res.cache.lengths
    want = [comp.max_capacity_prompt + steps, len(prompts[1]) + steps]
    got = [sorted(set(lens[:, b].flatten().tolist())) for b in range(2)]
    log(f"cache lengths per request: {got} (expect {want})")
    if got != [[w] for w in want] or [len(x) for x in ids] != [max_new, max_new]:
        raise SystemExit("cache lengths or token counts are wrong")
    if not torch.isfinite(res.logits).all():
        raise SystemExit("non-finite logits")

    # Hold the path to the fp32 reference forward.  Quantization leaves
    # prefill alone, so the quantized paths check request (a)'s prefill
    # logits no further.
    decode_tol = E2E_REL_L2_TOL if quant is None else E2E_QUANT_REL_L2_TOL[quant.nbits]
    with torch.no_grad():
        ref_a = None if quant is not None else \
            forward_logits(params, cfg, torch.tensor([prompts[0]], device=dev))[0, -1]
        seq_b = prompts[1] + ids[1][:steps]
        ref_b = forward_logits(params, cfg, torch.tensor([seq_b], device=dev))[0, len(prompts[1]) - 1:]
    rel_b0, abs_b0 = rel_l2(res.logits[1, :1], ref_b[:1])
    rel_bd, abs_bd = rel_l2(res.logits[1, 1:], ref_b[1:])
    top1 = (res.logits[1].argmax(-1) == ref_b.argmax(-1)).float().mean().item()
    if ref_a is None:
        rel_a = None
        log(f"prefill logits vs fp32 reference: (b) rel L2 {rel_b0:.4f} max abs "
            f"{abs_b0:.4f}; tol rel L2 {E2E_REL_L2_TOL}")
    else:
        rel_a, abs_a = rel_l2(res.logits[0, :1], ref_a[None])
        log(f"prefill logits vs fp32 reference: (a) rel L2 {rel_a:.4f} max abs {abs_a:.4f}; "
            f"(b) rel L2 {rel_b0:.4f} max abs {abs_b0:.4f}; tol rel L2 {E2E_REL_L2_TOL}")
    log(f"(b) decode logits vs fp32 reference, {steps} teacher-forced steps: worst rel L2 "
        f"{rel_bd:.4f}, max abs {abs_bd:.4f}, tol {decode_tol}; greedy top-1 agreement "
        f"{top1:.3f}")
    if max(rel_b0, rel_a or 0.0) > E2E_REL_L2_TOL or rel_bd > decode_tol:
        raise SystemExit("logits disagree with the fp32 reference")
    del ref_a, ref_b

    # Timings: prefill alone (max_new_tokens=1), then the full request.
    t0 = time.perf_counter()
    engine.generate_batch(prompts, 1)
    sync()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.generate_batch(prompts, max_new)
    sync()
    total_s = time.perf_counter() - t0
    step_ms = (total_s - prefill_s) / steps * 1e3
    weight_bytes = 2 * (n_params - params["embed"].numel())
    # Valid cache bytes at the final lengths: K and V, bf16 or codes plus
    # each token's four bf16 scalars.
    row_bytes = 2 * 2 * cfg.head_dim if quant is None else 2 * res.cache.k_codes.shape[-1] + 8
    cache_bytes = row_bytes * int(lens.sum().item())
    bound_step_ms = (weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"prefill {prefill_s:.3f} s for B=2 (4096 + 1500 tokens, bucket 4096); decode "
        f"{step_ms:.3f} ms/step, {2e3 / step_ms:.1f} tok/s at B=2; bandwidth bound "
        f"{bound_step_ms:.3f} ms/step ({weight_bytes / 1e9:.2f} GB weights + "
        f"{cache_bytes / 1e9:.2f} GB cache)")

    # Where the time goes: one profiled prefill, then 8 profiled decode
    # steps on the finished cache (they overwrite its last slots, which
    # nothing reads again).
    pre_busy = profile_device(lambda: engine.generate_batch(prompts, 1), 1,
                              prefill_s * 1e3, f"prefill, {label}", log_file)
    cur = torch.tensor([x[-1] for x in ids], device=dev)
    with torch.no_grad():
        for _ in range(2):
            llama.decode_step(params, cfg, cur, res.cache, quant=quant)
        busy_ms = profile_device(
            lambda: llama.decode_step(params, cfg, cur, res.cache, quant=quant), 8,
            step_ms, f"decode step, {label}", log_file,
            check=None if label not in ONE_LAUNCH_DECODE else
            lambda rows: one_kernel_a_layer(rows, L, *ONE_LAUNCH_DECODE[label]))
    return {"model": "Mistral-7B-Instruct-v0.2 widths, random weights (seed 0)",
            "compression": "snapkv 2048/8/7 maxpool, group_reduce none",
            "cache": label if quant is None else f"{label} per token, capacity "
                                                 f"{res.cache.capacity}",
            "requests": "B=2: 4096 and 1500 prompt tokens, 64 new tokens, bucket 4096",
            "launches": launches,
            "prefill_s": prefill_s, "prefill_device_busy_ms": pre_busy,
            "decode_ms_per_step": step_ms,
            "tok_s": 2e3 / step_ms, "bound_ms_per_step": bound_step_ms,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": None if busy_ms is None else 1 - busy_ms / step_ms,
            "prefill_rel_l2": [rel_a, rel_b0], "decode_rel_l2": rel_bd,
            "rel_l2_tol": E2E_REL_L2_TOL, "decode_rel_l2_tol": decode_tol,
            "decode_top1_agreement": top1}


# The one-launch decode kernels, by cache: (id, a part of the kernel's name).
ONE_LAUNCH_DECODE = {"bf16": ("K2", "decode_attn_kernel"), "int8": ("K3", "quant8_decode_kernel"),
                     "int4": ("K4", "quant4_decode_kernel")}


def one_kernel_a_layer(rows, layers, kid, name):
    """``kid`` in a profiled decode step: one kernel whose name holds
    ``name``, one launch per layer, and no combine kernel."""
    hits = [(n, key) for _, n, key in rows if name in key]
    combine = [key for _, _, key in rows if "combine" in key]
    log(f"{kid} in the decode step's profile: {[(n, key[:60]) for n, key in hits]}; "
        f"combine kernels: {len(combine)}")
    if len(hits) != 1 or hits[0][0] != layers or combine:
        raise SystemExit(f"the decode step does not run {kid} as one kernel, {layers} times: "
                         f"{[(n, key[:60]) for n, key in hits]}, {len(combine)} combine kernels")


# ---------------------------------------------------------------------------
# Phase 5b: every compression policy on the main path
# ---------------------------------------------------------------------------

POLICY_NEW = 16
# The main path's compression with each method in turn (snapkv, first, is
# the baseline the others are read beside), then adakv over the int4 cache.
POLICY_RUNS = (("snapkv", SNAPKV, None),
               ("pyramidkv", dataclasses.replace(SNAPKV, method="pyramidkv"), None),
               ("h2o", dataclasses.replace(SNAPKV, method="h2o"), None),
               ("streamingllm", dataclasses.replace(SNAPKV, method="streamingllm"), None),
               ("l2norm", dataclasses.replace(SNAPKV, method="l2norm"), None),
               ("random", dataclasses.replace(SNAPKV, method="random"), None),
               ("adakv", dataclasses.replace(SNAPKV, method="adakv"), None),
               ("headkv", dataclasses.replace(SNAPKV, method="headkv"), None),
               ("cam", dataclasses.replace(SNAPKV, method="cam"), None),
               ("think", dataclasses.replace(SNAPKV, method="think"), None),
               ("pivot", dataclasses.replace(SNAPKV, merge="pivot"), None),
               ("adakv_int4", dataclasses.replace(SNAPKV, method="adakv"), QuantConfig(nbits=4)))
SCORE_EMITTERS = ("snapkv", "pyramidkv", "think", "adakv", "headkv")


def headkv_file(path, cfg, seed=0):
    """A head-score file (one JSON line: per-head score lists, layer-major)
    from a seeded rng, lognormal so that some heads' budgets pass the
    engine's per-head bound; returns its capacities ``[L, H]``."""
    L, H = cfg.num_hidden_layers, cfg.num_attention_heads
    rng = np.random.default_rng(seed)
    scores = {f"{li}-{h}": rng.lognormal(0.0, 1.0, size=4).tolist()
              for li in range(L) for h in range(H)}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(scores) + "\n")
    return headkv_capacities(str(path), L, H, SNAPKV.max_capacity_prompt)


def expected_lengths(method, comp, L, H, head_cap, S):
    """Request (a)'s prefill lengths [L, H] (``S`` prompt tokens, its own
    bucket) by the method's budget rule (None for adakv, whose budgets
    follow the scores: checked apart)."""
    w, base = comp.window_size, comp.base_capacity
    if method == "pyramidkv":
        # pyramidkv_utils.py:205-238; at 4096 tokens, budget 2048, window 8
        # and 32 layers: 3978 - 125 * layer.
        if S < 2 * base:
            return np.full((L, H), min(base, S - w) + w)
        min_num, max_num = base // comp.beta, 2 * base - base // comp.beta
        if max_num >= S - w:
            max_num = S - w
            min_num = 2 * base - max_num
        steps = (max_num - min_num) // max(L - 1, 1)
        return np.array([[min(max(max_num - li * steps, 0), S - w) + w] * H
                         for li in range(L)])
    if method == "l2norm":
        return np.array([[S if li in comp.skip_layers else comp.max_capacity_prompt] * H
                         for li in range(L)])
    if method == "headkv":
        # Each head's capacity, clipped to the cache's per-head bound.
        return np.clip(head_cap, 0, comp.layer_capacity(L, S) - w) + w
    if method == "adakv":
        return None
    return np.full((L, H), comp.max_capacity_prompt)


@contextlib.contextmanager
def score_window_hook():
    """Record the score window K1 is handed at each prefill call (0: no
    scores emitted)."""
    seen, real = [], llama.flash_prefill_attention

    def hooked(*args, **kwargs):
        seen.append(args[4])
        return real(*args, **kwargs)
    llama.flash_prefill_attention = hooked
    try:
        yield seen
    finally:
        llama.flash_prefill_attention = real


def direct_decode_check(rng, cache, quant, label):
    """K2 (K4 on the int4 cache) and its plain version, called directly on a
    copy of layers 0 and 31 of a finished cache with a random query: the
    ragged per-head lengths of a real policy.  Returns the worst head's rel
    L2 and max abs difference."""
    D, dev = 128, cache.lengths.device
    dtype = cache.k.dtype if quant is None else torch.bfloat16
    worst = (0.0, 0.0)
    for li in (0, cache.lengths.shape[0] - 1):
        B, H = cache.lengths.shape[1:]
        lens = cache.lengths[li].reshape(B * H).contiguous()
        q, kn, vn = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, dtype)
                     for shape in ((B * H, 1, D), (B * H, D), (B * H, D)))
        C = cache.capacity
        if quant is None:
            kid, tol = "K2", K2_OUT_TOL
            layer = [cache.k[li].reshape(B * H, C, D), cache.v[li].reshape(B * H, C, D)]
            out = decode_attn.decode_attention_append(q, *(t.clone() for t in layer), lens, kn, vn)
            ref = decode_attn.decode_attention_append_reference(q, *(t.clone() for t in layer),
                                                                lens, kn, vn)
        else:
            kid, kernel, plain, _ = QUANT[quant.nbits]
            tol = KQ_OUT_TOL
            Wc = cache.k_codes.shape[-1]
            layer = [cache.k_codes[li].reshape(B * H, C, Wc),
                     cache.v_codes[li].reshape(B * H, C, Wc), cache.scales[li].reshape(B * H, C, 4)]
            out = kernel(q, *(t.clone() for t in layer), lens, kn, vn)
            ref = plain(q, *(t.clone() for t in layer), lens, kn, vn)
        sync()
        err = rel_l2(out.reshape(B * H, -1), ref.reshape(B * H, -1))
        log(f"  {label}: {kid} called directly on layer {li}'s cache (lengths "
            f"{int(lens.min())}-{int(lens.max())}): worst head rel L2 {err[0]:.3e}, max abs "
            f"{err[1]:.3e}; tol {tol}")
        if err[0] > tol or not torch.isfinite(out.float()).all():
            raise SystemExit(f"{kid} disagrees with its plain version on the {label} cache")
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
    return worst


def policy_run(rng, params, prompts, label, comp, quant, head_cap, refs, log_file):
    """One ``generate_batch`` of phase 5's two requests under ``comp``, with
    every launch count set to 0 just before it and read just after: launch
    counts, K1's score emission, each (layer, head, request) length against
    the method's budget rule, think's zeroed channels, request (b)'s logits
    against the fp32 reference forward; then times."""
    cfg, dev = MISTRAL_7B, params["embed"].device
    L, H = cfg.num_hidden_layers, cfg.num_attention_heads
    method, steps = comp.method, POLICY_NEW - 1
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=comp, quant=quant),
                             device=dev, head_capacity=head_cap if method == "headkv" else None)
    reset_counts()
    with score_window_hook() as windows:
        ids, res = engine.generate_batch(prompts, POLICY_NEW, return_result=True)
        sync()
    launches = path_launches()
    decode_id = "K2" if quant is None else QUANT[quant.nbits][0]
    expect = dict.fromkeys(launches, 0)
    expect["K1"], expect[decode_id] = L, L * steps
    emitted = sorted(set(windows))
    want_window = comp.window_size if method in SCORE_EMITTERS else 0
    log(f"== policy {label}: launches {launches} (expect K1 {L}, {decode_id} {L * steps}); "
        f"K1 score windows {emitted} (expect [{want_window}])")
    if launches != expect:
        raise SystemExit(f"the {label} run did not run each kernel the expected number of times")
    if emitted != [want_window]:
        raise SystemExit(f"K1 emitted window scores on the {label} run against JAX's gate")

    lens = res.cache.lengths.cpu().numpy() - steps  # [L, B, H] at the end of prefill
    want_a = expected_lengths(method, comp, L, H, head_cap, len(prompts[0]))
    a, b = lens[:, 0], lens[:, 1]
    if want_a is None:  # adakv: each head within the bound; budgets sum to H * base
        bound = comp.layer_capacity(L, len(prompts[0])) - comp.window_size
        budgets = a - comp.window_size
        unclipped = (budgets < bound).all(axis=1)
        dev_sum = np.abs(budgets.sum(axis=1) - H * comp.base_capacity)
        ok_a = (a <= bound + comp.window_size).all() and (dev_sum[unclipped] <= H / 2).all()
        log(f"  request (a) lengths per layer: min {a.min(axis=1).tolist()}, max "
            f"{a.max(axis=1).tolist()}; layers without a clipped head: {int(unclipped.sum())}, "
            f"their budget sums off H * {comp.base_capacity} by at most "
            f"{dev_sum[unclipped].max() if unclipped.any() else None} (limit {H / 2})")
    else:
        ok_a = np.array_equal(a, want_a)
        log(f"  request (a) lengths by layer (first head): {a[:, 0].tolist()}; as the budget "
            f"rule says: {ok_a}")
    ok_b = (b == len(prompts[1])).all()
    log(f"  request (b) lengths: {sorted(set(b.flatten().tolist()))} (expect "
        f"[{len(prompts[1])}]); tokens {[len(x) for x in ids]}")
    if not (ok_a and ok_b) or [len(x) for x in ids] != [POLICY_NEW] * 2:
        raise SystemExit(f"the {label} run left cache lengths against its budget rule")
    if not torch.isfinite(res.logits).all():
        raise SystemExit(f"the {label} run gave non-finite logits")

    think = None
    if method == "think":
        # Rows below length - recent of request (a): exactly int(D * ratio)
        # channels zero in every such row; request (b) (uncompressed) none.
        k = res.cache.k
        n_pruned = comp.max_capacity_prompt - comp.recent_size
        zero_a = (k[:, 0, :, :n_pruned] == 0).all(dim=2).sum(-1)
        zero_a_recent = (k[:, 0, :, n_pruned:comp.max_capacity_prompt] == 0).all(dim=2).sum(-1)
        zero_b = (k[:, 1, :, :len(prompts[1])] == 0).all(dim=2).sum(-1)
        want = int(cfg.head_dim * comp.pruning_ratio)
        think = {"zero_channels_a": sorted(set(zero_a.flatten().tolist())),
                 "zero_channels_a_recent_rows": sorted(set(zero_a_recent.flatten().tolist())),
                 "zero_channels_b": sorted(set(zero_b.flatten().tolist()))}
        log(f"  think: key channels zero in every pruned row, per (layer, head), request (a) "
            f"{think['zero_channels_a']} (expect [{want}]), its last {comp.recent_size} rows "
            f"{think['zero_channels_a_recent_rows']}; request (b) {think['zero_channels_b']} "
            f"(expect [0])")
        if think["zero_channels_a"] != [want] or think["zero_channels_b"] != [0] or \
                think["zero_channels_a_recent_rows"] != [0]:
            raise SystemExit("think zeroed the wrong key channels")

    # Request (b) is below the budget on every method: its logits are held to
    # the fp32 reference forward as phase 5 holds them.
    seq_b = tuple(prompts[1] + ids[1][:steps])
    if seq_b not in refs:
        with torch.no_grad():
            refs[seq_b] = forward_logits(params, cfg, torch.tensor([seq_b], device=dev))[
                0, len(prompts[1]) - 1:]
    ref_b = refs[seq_b]
    decode_tol = E2E_REL_L2_TOL if quant is None else E2E_QUANT_REL_L2_TOL[quant.nbits]
    rel_b0, _ = rel_l2(res.logits[1, :1], ref_b[:1])
    rel_bd, _ = rel_l2(res.logits[1, 1:], ref_b[1:])
    log(f"  request (b) vs fp32 reference: first token rel L2 {rel_b0:.4f} (tol "
        f"{E2E_REL_L2_TOL}), {steps} decode rows worst {rel_bd:.4f} (tol {decode_tol})")
    if rel_b0 > E2E_REL_L2_TOL or rel_bd > decode_tol:
        raise SystemExit(f"the {label} run's logits disagree with the fp32 reference")

    direct = None
    if method in ("adakv", "pyramidkv"):
        direct = direct_decode_check(rng, res.cache, quant, label)

    t0 = time.perf_counter()
    engine.generate_batch(prompts, 1)
    sync()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.generate_batch(prompts, POLICY_NEW)
    sync()
    step_ms = (time.perf_counter() - t0 - prefill_s) / steps * 1e3
    busy_ms = None
    if label in ("snapkv", "adakv"):
        cur = torch.tensor([x[-1] for x in ids], device=dev)
        with torch.no_grad():
            for _ in range(2):
                llama.decode_step(params, cfg, cur, res.cache, quant=quant)
            busy_ms = profile_device(
                lambda: llama.decode_step(params, cfg, cur, res.cache, quant=quant), 4, step_ms,
                f"decode step, policy {label}", log_file)
    cache_entries = int(res.cache.lengths.sum().item())
    log(f"  {label}: prefill {prefill_s:.3f} s (B=2, bucket 4096); decode {step_ms:.3f} ms/step "
        f"wall{'' if busy_ms is None else f', device busy {busy_ms:.3f} ms'}; cache capacity "
        f"{res.cache.capacity}, {cache_entries} valid entries")
    return {"launches": launches, "score_window": emitted[0], "prefill_s": prefill_s,
            "decode_ms_per_step": step_ms, "device_busy_ms_per_step": busy_ms,
            "cache_capacity": res.cache.capacity, "valid_entries": cache_entries,
            "first_token_rel_l2_b": rel_b0, "decode_rel_l2_b": rel_bd,
            "direct_decode_rel_l2": direct, "think": think}


def cam_merge_check(rng, S=4096):
    """CAM's value merge at a phase-5 layer (32 heads x S rows of 128):
    the block solve the engine runs against JAX's sequential form (one
    step per row, here in fp32 on the card), both timed; worst head rel L2
    within CAM_MERGE_TOL."""
    H, D, w = MISTRAL_7B.num_attention_heads, MISTRAL_7B.head_dim, SNAPKV.window_size
    v = torch.from_numpy(rng.standard_normal((H, S, D), np.float32)).cuda()
    col_mean = torch.from_numpy(rng.random((H, S), np.float32) / S).cuda()
    uniforms = torch.from_numpy(rng.random((S, H), np.float32)).cuda()
    tl = torch.tensor(S, device="cuda")
    args = (col_mean, tl, SNAPKV.start_budget_ratio, w, uniforms)
    hits = int((cam.merge_coefficients(*args) > 0).sum().item())
    block_ms = event_ms(lambda: cam.cam_merge_values(v, *args), iters=5, warmup=1)
    out = cam.cam_merge_values(v, *args)
    t0 = time.perf_counter()
    seq = cam.cam_merge_values_sequential(v, *args)
    sync()
    seq_ms = (time.perf_counter() - t0) * 1e3
    err, abs_err = rel_l2(out.reshape(H, -1), seq.reshape(H, -1))
    moved = rel_l2(v.reshape(H, -1), seq.reshape(H, -1))[0]
    log(f"cam merge, H={H} S={S} D={D} w={w}, {hits} merged columns: block solve "
        f"{block_ms:.3f} ms, sequential form {seq_ms:.1f} ms wall; worst head rel L2 "
        f"{err:.3e} (max abs {abs_err:.3e}), tol {CAM_MERGE_TOL}; the merge moved the "
        f"values by {moved:.3f}")
    if err > CAM_MERGE_TOL or hits == 0:
        raise SystemExit("CAM's block solve disagrees with the sequential merge")
    return {"block_ms": block_ms, "sequential_ms": seq_ms, "rel_l2": err,
            "merged_columns": hits, "tol": CAM_MERGE_TOL}


def phase_policies(rng, params, prompts, log_file):
    """Every compression method through ``InferenceEngine`` on phase 5's
    weights and two prompts (16 new tokens), and adakv over the int4 cache."""
    head_cap = headkv_file(LOG_PATH.parent / "policies" / "heads.json", MISTRAL_7B)
    bound = dataclasses.replace(SNAPKV, method="headkv").layer_capacity(
        MISTRAL_7B.num_hidden_layers, len(prompts[0])) - SNAPKV.window_size
    log(f"headkv capacities from a seeded head-score file: min {int(head_cap.min())}, max "
        f"{int(head_cap.max())}, {int((head_cap > bound).sum())} of {head_cap.size} past the "
        f"per-head bound {bound}")
    refs, out = {}, {}
    for label, comp, quant in POLICY_RUNS:
        out[label] = policy_run(rng, params, prompts, label, comp, quant, head_cap, refs,
                                log_file)
        torch.cuda.empty_cache()
    out["cam_merge"] = cam_merge_check(rng)
    return out


# ---------------------------------------------------------------------------
# Phase 6: the serving path
# ---------------------------------------------------------------------------

SERVE_PROMPTS = (8192, 7000, 6100, 5000, 3000, 1500)
SERVE_NEW = 32
SERVE_BUCKETS = (4096, 8192)
SERVE_DRAINS = (("one-shot", 0), ("chunked", 2048))


def serve_drain(params, prompts, chunk_tokens):
    """One drain of the six requests; every launch count set to 0 just
    before ``run`` and read just after."""
    cfg, L = MISTRAL_7B_V01, MISTRAL_7B_V01.num_hidden_layers
    eng = ContinuousBatchingEngine(
        params, EngineConfig(model=cfg, compression=SNAPKV, prefill_buckets=SERVE_BUCKETS),
        n_slots=4, max_new_cap=SERVE_NEW, chunk_size=16, prefill_chunk_tokens=chunk_tokens,
        device="cuda", instrument=True)
    rids = [eng.submit(p, SERVE_NEW) for p in prompts]
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    flash_prefill.reset_launches()
    sync()
    t0 = time.perf_counter()
    out = eng.run()
    sync()
    wall = time.perf_counter() - t0
    var = dict(flash_prefill.flash_prefill_attention.variant_launches)
    launches = {"K1": var["dense"], "K1-SW": var["sliding_window"], "K1-chunk": var["chunk"],
                **{kid: w.launches for kid, w in COUNTED.items() if kid != "K1"}}
    expect = dict.fromkeys(launches, 0)
    expect["K2"] = L * eng.steps_executed
    if chunk_tokens:
        expect["K1-chunk"] = L * eng.prefill_chunk_dispatches
    else:
        expect["K1-SW"] = L * len(prompts)
    label = "chunked" if chunk_tokens else "one-shot"
    stalls = eng.admission_stalls_s
    log(f"{label} drain: {wall:.3f} s wall, {eng.steps_executed} decode steps, "
        f"{eng.prefill_chunk_dispatches} chunk dispatches ({eng.prefill_chunks_executed} "
        f"row-chunks), scheduler {type(eng.scheduler).__name__}; longest admission stall "
        f"{max(stalls):.4f} s over {len(stalls)} loop iterations with prefill work "
        f"(sum {sum(stalls):.3f} s); launches {launches}, expect {expect}")
    if launches != expect or expect["K2"] == 0:
        raise SystemExit(f"the {label} drain did not run each kernel the expected number of times")
    if any(len(out[r]) != SERVE_NEW for r in rids):
        raise SystemExit(f"the {label} drain did not produce {SERVE_NEW} tokens per request")
    # The last request in each slot: 2048 compressed entries + 31 decoded
    # for the prompts above 2048 tokens, 1500 + 31 for the last one.
    got = sorted(sorted(set(eng.cache.lengths[:, b].flatten().tolist())) for b in range(4))
    want = sorted([min(n, SNAPKV.max_capacity_prompt) + SERVE_NEW - 1]
                  for n in SERVE_PROMPTS[-4:])
    log(f"{label} drain: cache lengths per slot {got} (expect {want})")
    if got != want:
        raise SystemExit(f"the {label} drain left wrong cache lengths")
    return {"engine": eng, "tokens": [out[r] for r in rids],
            "logits": [torch.stack(eng.logits[r]) for r in rids],
            "summary": {"wall_s": wall, "decode_steps": eng.steps_executed,
                        "chunk_dispatches": eng.prefill_chunk_dispatches,
                        "row_chunks": eng.prefill_chunks_executed,
                        "longest_stall_s": max(stalls), "stalls_s": stalls,
                        "drain_decode_ms_per_step":
                            (wall - sum(stalls)) / eng.steps_executed * 1e3,
                        "scheduler": type(eng.scheduler).__name__, "launches": launches}}


def phase_serving(rng, params, log_file):
    """Both drains, checked against the fp32 reference and each other, then
    decode timed and profiled on the last drain's batched cache."""
    cfg = MISTRAL_7B_V01
    log("== serving path: Mistral-7B-v0.1 widths (sliding window 4096), "
        f"prompts {SERVE_PROMPTS}, {SERVE_NEW} new tokens each, 4 slots, buckets "
        f"{SERVE_BUCKETS}")
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_PROMPTS]
    drains = {}
    for label, chunk in SERVE_DRAINS:
        drains[label] = serve_drain(params, prompts, chunk)
        if label != SERVE_DRAINS[-1][0]:
            del drains[label]["engine"]
    one, ch = drains["one-shot"], drains["chunked"]

    # First-token logits against the fp32 reference forward (windowed).
    worst = {"one-shot": 0.0, "chunked": 0.0, "between": 0.0}
    max_abs_between = 0.0
    with torch.no_grad():
        for i, p in enumerate(prompts):
            ref = forward_logits(params, cfg, torch.tensor([p], device="cuda"))[0, -1]
            for label in ("one-shot", "chunked"):
                worst[label] = max(worst[label], rel_l2(drains[label]["logits"][i][:1],
                                                        ref[None].cpu())[0])
            e, a = rel_l2(ch["logits"][i][:1], one["logits"][i][:1])
            worst["between"], max_abs_between = max(worst["between"], e), max(max_abs_between, a)
            del ref
    log(f"first-token logits vs fp32 reference, worst rel L2 over {len(prompts)} requests: "
        f"one-shot {worst['one-shot']:.4f}, chunked {worst['chunked']:.4f} (tol "
        f"{E2E_REL_L2_TOL}); chunked vs one-shot {worst['between']:.4f} (tol "
        f"{CHUNKED_VS_ONESHOT_TOL}), max abs {max_abs_between:.4f}")
    if max(worst["one-shot"], worst["chunked"]) > E2E_REL_L2_TOL \
            or worst["between"] > CHUNKED_VS_ONESHOT_TOL:
        raise SystemExit("serving logits disagree with the fp32 reference or each other")

    # Greedy streams: identical up to the first near-tie.  Until two streams
    # part, both drains fed the same tokens, so their logits differ only by
    # the prefill's roundings, which the first token measures; a stream may
    # part where the one-shot top two are within twice the worst first-token
    # logit difference, and the two rows must still agree there.
    tie_margin = 2 * max_abs_between
    parted = []
    for i in range(len(prompts)):
        apart = [j for j, (a, b) in enumerate(zip(one["tokens"][i], ch["tokens"][i])) if a != b]
        if not apart:
            continue
        j = apart[0]
        top2 = one["logits"][i][j].topk(2).values
        gap = (top2[0] - top2[1]).item()
        e = rel_l2(ch["logits"][i][j:j + 1], one["logits"][i][j:j + 1])[0]
        parted.append({"request": i, "step": j, "top2_gap": gap, "rel_l2": e})
        if gap > tie_margin or e > CHUNKED_VS_ONESHOT_TOL:
            raise SystemExit(f"request {i}: the two drains part at step {j} where the one-shot "
                             f"top-2 gap is {gap:.4f} (margin {tie_margin:.4f}), rel L2 {e:.4f}")
    log(f"greedy streams: {len(prompts) - len(parted)} of {len(prompts)} identical over "
        f"{SERVE_NEW} tokens; parted at near-ties (margin {tie_margin:.4f}): {parted}")

    # Decode on the last drain's batched cache, 4 rows: wall time per step
    # and a profile.  The steps overwrite slots past each row's end, which
    # nothing reads again.
    eng = ch["engine"]
    cache, quant = eng.cache, None
    cur = torch.tensor([t[-1] for t in ch["tokens"][-4:]], device="cuda")
    with torch.no_grad():
        for _ in range(2):
            llama.decode_step(params, cfg, cur, cache, quant=quant)
        sync()
        t0 = time.perf_counter()
        for _ in range(8):
            llama.decode_step(params, cfg, cur, cache, quant=quant)
        sync()
        step_ms = (time.perf_counter() - t0) / 8 * 1e3
        busy_ms = profile_device(lambda: llama.decode_step(params, cfg, cur, cache, quant=quant),
                                 8, step_ms, "decode step, serving B=4", log_file)
    log(f"serving decode at B=4: {step_ms:.3f} ms/step wall, device busy "
        f"{busy_ms if busy_ms is None else round(busy_ms, 3)} ms")
    del drains["chunked"]["engine"], eng, cache
    summary = {"model": "Mistral-7B-v0.1 widths (sliding window 4096), random weights (seed 0)",
               "compression": "snapkv 2048/8/7 maxpool, group_reduce none",
               "requests": f"prompts {list(SERVE_PROMPTS)}, {SERVE_NEW} new tokens, 4 slots, "
                           f"buckets {SERVE_BUCKETS}, decode chunk 16",
               "one_shot": one["summary"], "chunked": ch["summary"],
               "first_token_rel_l2": worst, "first_token_max_abs_between": max_abs_between,
               "tie_margin": tie_margin, "parted": parted,
               "decode_ms_per_step_b4": step_ms, "device_busy_ms_per_step_b4": busy_ms,
               "idle_share_b4": None if busy_ms is None else 1 - busy_ms / step_ms}
    return summary


# ---------------------------------------------------------------------------
# Phase 7: the MInference path
# ---------------------------------------------------------------------------

MINF_PROMPT, MINF_NEW, MINF_BUCKET = 32000, 32, 32768
MINF_RUNS = (("fullkv", CompressionConfig(method="fullkv")),
             ("vertical_slash", CompressionConfig(method="minference", sparse_prefill=VS_DEFAULT)),
             ("ashape", CompressionConfig(method="minference", sparse_prefill=ASHAPE)))
# A vertical-slash budget that ranks every column of an 8192-token prompt
# keeps every block: the same function as dense attention.
FULL_BUDGET = ("vertical_slash", 8192, 128, 64)
FULL_BUDGET_TOL = 1e-3


def path_launches():
    """Every kernel's launch count, K1 split by variant."""
    var = flash_prefill.flash_prefill_attention.variant_launches
    return {"K1": var["dense"], "K1-SW": var["sliding_window"], "K1-chunk": var["chunk"],
            "K1-A": var["ashape"], "K1-VS": var["vertical_slash"], "K1-ml": var["ring"],
            **{kid: w.launches for kid, w in COUNTED.items() if kid != "K1"}}


def reset_counts():
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    flash_prefill.reset_launches()
    sync()


def minference_run(params, prompt, label, comp, bucket=MINF_BUCKET):
    """One request through ``InferenceEngine`` with every launch count set
    to 0 just before it and read just after, checked (launches, cache
    lengths, finite logits).  Returns the engine, the summary, the token
    ids, the ``GenerateResult`` and the block masks built (one per layer)."""
    cfg, L = MISTRAL_7B, MISTRAL_7B.num_hidden_layers
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=comp,
                                                  prefill_buckets=(bucket,)), device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    with mask_hook() as (masks, events):
        ids, res = engine.generate_batch([prompt], MINF_NEW, return_result=True)
        sync()
    wall = time.perf_counter() - t0
    launches = path_launches()
    expect = dict.fromkeys(launches, 0)
    k1_id = "K1" if comp.sparse_prefill is None else \
        SPARSE_ID[flash_prefill.pattern_kind(comp.sparse_prefill)]
    expect[k1_id], expect["K2"] = L, L * (MINF_NEW - 1)
    lens = sorted(set(res.cache.lengths.flatten().tolist()))
    want_len = len(prompt) + MINF_NEW - 1
    dens = [density(m) for m in masks]
    mask_ms = sum(s.elapsed_time(e) for s, e in events)
    log(f"minference path, {label} ({comp.method}, {comp.sparse_prefill}), {len(prompt)} prompt "
        f"tokens, bucket {bucket}, {MINF_NEW} new: {wall:.3f} s; launches {launches}, expect "
        f"{expect}; cache lengths {lens} (expect [{want_len}]); mask builds {len(masks)}, "
        f"{mask_ms:.3f} ms on the device")
    if launches != expect:
        raise SystemExit(f"the {label} run did not run each kernel the expected number of times")
    if lens != [want_len] or len(ids[0]) != MINF_NEW:
        raise SystemExit(f"the {label} run left wrong cache lengths or token counts")
    if not torch.isfinite(res.logits).all():
        raise SystemExit(f"the {label} run gave non-finite logits")
    out = {"launches": launches, "run_s": wall, "cache_lengths": lens}
    if dens:
        out["mask_density_per_layer"] = {"min": min(dens), "mean": sum(dens) / len(dens),
                                         "max": max(dens)}
        out["mask_build_ms"] = mask_ms
        log(f"  mask density per layer (share of the causal block pairs kept): min "
            f"{min(dens):.4f}, mean {sum(dens) / len(dens):.4f}, max {max(dens):.4f}")
    return engine, out, ids, res, masks


def minference_times(engine, params, prompt, label, ids, cache, mask_ms, log_file):
    """Decode ms/step (wall and profiled) on the run's finished cache, then
    prefill wall time and a profiled prefill."""
    cfg = MISTRAL_7B
    # The decode steps write slots past the end, which nothing reads again.
    cur = torch.tensor([ids[0][-1]], device="cuda")
    with torch.no_grad():
        for _ in range(2):
            llama.decode_step(params, cfg, cur, cache)
        sync()
        t0 = time.perf_counter()
        for _ in range(8):
            llama.decode_step(params, cfg, cur, cache)
        sync()
        step_ms = (time.perf_counter() - t0) / 8 * 1e3
        busy_ms = profile_device(lambda: llama.decode_step(params, cfg, cur, cache), 4,
                                 step_ms, f"decode step, minference path {label}", log_file)
    t0 = time.perf_counter()
    engine.generate_batch([prompt], 1)
    sync()
    prefill_s = time.perf_counter() - t0
    pre_busy = profile_device(lambda: engine.generate_batch([prompt], 1), 1, prefill_s * 1e3,
                              f"prefill, minference path {label}", log_file)
    share = None if mask_ms is None or pre_busy is None else mask_ms / pre_busy
    log(f"  prefill {prefill_s:.3f} s wall, device busy "
        f"{pre_busy if pre_busy is None else round(pre_busy, 3)} ms"
        f"{'' if share is None else f', mask builds {share:.2%} of it'}; decode {step_ms:.3f} "
        f"ms/step wall, busy {busy_ms if busy_ms is None else round(busy_ms, 3)} ms")
    return {"prefill_s": prefill_s, "prefill_device_busy_ms": pre_busy,
            "mask_build_share_of_prefill_busy": share, "decode_ms_per_step": step_ms,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": None if busy_ms is None else 1 - busy_ms / step_ms}


def model_mask_check(rng, masks, pattern):
    """K1 given the sparsest of a run's layer masks (the model's own) on
    random 32k inputs, against its plain version given the same mask."""
    mask = min(masks, key=density)
    S, tls = MINF_BUCKET, [MINF_PROMPT]
    block = S // mask.shape[-1]
    q, k, v = k1s_inputs(rng, 1, MISTRAL_7B.num_attention_heads,
                         MISTRAL_7B.num_key_value_heads, S)
    tl = torch.tensor(tls, dtype=torch.int32, device="cuda")
    with mask_hook((mask, block)):
        out, _ = flash_prefill.flash_prefill_attention(q, k, v, tl, 0, sparse_pattern=pattern)
    ref, _ = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, 0, block_mask=mask,
                                                             block=block)
    err, absd = k1v_worst(out, ref, k1v_valid_rows(S, tls, None))
    finite = bool(torch.isfinite(out.float()).all())
    log(f"  the sparsest layer mask of this run (keeps {density(mask):.4f}) given to "
        f"K1 on random inputs at S={S} true_len={tls}: out worst row rel L2 against the plain "
        f"version {err:.3e} (max abs {absd:.3e}) tol {K1_OUT_TOL}; finite {finite}")
    if err > K1_OUT_TOL or not finite:
        raise SystemExit("K1 disagrees with its plain version on the model's layer mask")
    del q, k, v, out, ref
    torch.cuda.empty_cache()
    return {"density": density(mask), "rel_l2": err, "max_abs_err": absd, "tol": K1_OUT_TOL}


def phase_minference(rng, params, log_file):
    """The three 32k runs, timed, their first-token logits against
    fullkv's, and the full-budget run against fullkv at 8192 tokens."""
    log(f"== MInference path: Mistral-7B-Instruct-v0.2 widths, one request of {MINF_PROMPT} "
        f"prompt tokens, bucket {MINF_BUCKET}, {MINF_NEW} new tokens")
    prompt = rng.integers(0, MISTRAL_7B.vocab_size, size=MINF_PROMPT).tolist()
    runs, firsts = {}, {}
    for label, comp in MINF_RUNS:
        engine, out, ids, res, masks = minference_run(params, prompt, label, comp)
        firsts[label] = res.logits[0, 0].clone()
        runs[label] = {**out, **minference_times(engine, params, prompt, label, ids, res.cache,
                                                 out.get("mask_build_ms"), log_file)}
        del engine, res
        torch.cuda.empty_cache()
        if label == "vertical_slash":
            # The a-shape run's masks equal phase 3c's 32k mask, held there.
            runs[label]["sparsest_layer_mask_check"] = model_mask_check(
                rng, masks, comp.sparse_prefill)
        del masks
    for label in ("vertical_slash", "ashape"):
        rel, absd = rel_l2(firsts[label][None], firsts["fullkv"][None])
        runs[label]["first_token_rel_l2_vs_fullkv"] = rel
        log(f"{label}: first-token logits against fullkv's rel L2 {rel:.4f} (max abs "
            f"{absd:.4f}): the pattern's approximation, recorded with no limit")
        if not np.isfinite(rel):
            raise SystemExit(f"the {label} run's logits are not finite")

    # Full budget: every column ranked, so every block kept.
    p8 = rng.integers(0, MISTRAL_7B.vocab_size, size=8192).tolist()
    _, _, ids_d, res_d, _ = minference_run(params, p8, "fullkv", CompressionConfig(method="fullkv"),
                                        bucket=8192)
    _, fb, ids_f, res_f, _ = minference_run(
        params, p8, "full_budget", CompressionConfig(method="minference",
                                                     sparse_prefill=FULL_BUDGET), bucket=8192)
    rel, absd = rel_l2(res_f.logits[0, :1], res_d.logits[0, :1])
    bitwise = torch.equal(res_f.logits, res_d.logits)
    same = ids_f == ids_d
    dens = fb["mask_density_per_layer"]
    log(f"full-budget vertical-slash {FULL_BUDGET} at 8192 tokens against fullkv: masks keep "
        f"{dens['min']:.4f}-{dens['max']:.4f} of the causal block pairs; first-token logits rel "
        f"L2 {rel:.3e} (max abs {absd:.3e}) tol {FULL_BUDGET_TOL}; greedy streams identical "
        f"{same}; logits of every step bitwise equal {bitwise}")
    if rel > FULL_BUDGET_TOL or not same or dens["min"] < 1.0:
        raise SystemExit("the full-budget run disagrees with fullkv")
    del res_d, res_f
    torch.cuda.empty_cache()
    return {"model": "Mistral-7B-Instruct-v0.2 widths, random weights (seed 0)",
            "requests": f"one request, {MINF_PROMPT} prompt tokens, bucket {MINF_BUCKET}, "
                        f"{MINF_NEW} new tokens",
            **runs, "full_budget": {"pattern": list(FULL_BUDGET), "prompt": 8192,
                                    "first_token_rel_l2": rel, "tol": FULL_BUDGET_TOL,
                                    "tokens_identical": same, "logits_bitwise_equal": bitwise}}


# ---------------------------------------------------------------------------
# Phase 8: the sequence-parallel path (K1-ml, the ring fold, sp=2 ranks)
# ---------------------------------------------------------------------------

SP, SP_PROMPT, SP_BUCKET, SP_NEW = 2, 32000, 32768, 32
SP_DIR = Path(__file__).resolve().parent / "build" / "sp"
SP_TIMEOUT_S = 600
# K1-ml's (m, l) against its plain version, on the rows that see a column.
# m: both take the max of the same fp32 logits (exact bf16 products summed
# in fp32 in another order, ~1e-6 apart on values of order 5): 1e-4
# absolute.  l: fp32 sums of up to 16384 terms in another order and a chain
# of up to 256 rescales of one ulp each, ~3e-5 relative at worst: 2e-4
# relative.  A kernel that drops one 64-key tile moves l by that tile's
# share of the softmax mass, about 64/16384 = 3.9e-3 on the cross hop, and
# by far more for a row whose max lies in the tile; the script measures it.
K1ML_M_TOL = 1e-4
K1ML_L_TOL = 2e-4


def k1ml_case(q, k, v, tl_hop, off, sw=None):
    """K1-ml against its plain version on one ring hop (q rows at global
    ids ``off + r`` over one K/V shard, valid length ``tl_hop``): ``out``
    over the valid rows that see a column (worst row rel L2), ``m`` (max
    abs) and ``l`` (max relative) there; valid rows that see no column must
    come out exactly ``(NEG_INF, 0)`` with a zero output."""
    S_q = q.shape[2]
    tl = torch.tensor([tl_hop], dtype=torch.int32, device="cuda")
    offs = torch.tensor([off], dtype=torch.int32, device="cuda")
    kw = dict(sliding_window=sw, row_offset=offs, return_ml=True)
    out, _, m, l = flash_prefill.flash_prefill_attention(q, k, v, tl, 0, **kw)
    sync()
    ref, _, m_ref, l_ref = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, 0,
                                                                           **kw)
    sync()
    valid = k1v_valid_rows(S_q, [tl_hop], [off])
    # Whether a row sees a column depends on its position alone, not its head.
    seen_rows = valid & (m_ref[:, 0] > NEG_INF).cpu().numpy()
    empty_rows = valid & ~seen_rows
    err, absd = k1v_worst(out, ref, seen_rows)
    seen = torch.from_numpy(seen_rows).to("cuda")[:, None].expand_as(m)
    empty = torch.from_numpy(empty_rows).to("cuda")[:, None].expand_as(m)
    m_err = (m - m_ref).abs()[seen].max().item()
    l_err = ((l - l_ref).abs() / l_ref)[seen].max().item()
    empty_out = out.transpose(1, 2)[torch.from_numpy(empty_rows).to("cuda")]
    empty_ok = bool((m[empty] == NEG_INF).all() and (l[empty] == 0).all()
                    and (empty_out == 0).all())
    finite = bool(torch.isfinite(out.float()).all())
    log(f"K1-ml hop S_q={S_q} S_k={k.shape[2]} row_offset={off} true_len={tl_hop} sw={sw}: out "
        f"worst row rel L2 {err:.3e} (max abs {absd:.3e}) tol {K1_OUT_TOL}; m max abs err "
        f"{m_err:.3e} tol {K1ML_M_TOL}; l max rel err {l_err:.3e} tol {K1ML_L_TOL}; "
        f"{int(seen_rows.sum())} rows see a column, {int(empty_rows.sum())} see none (exactly "
        f"NEG_INF, 0 and zeros: {empty_ok}); finite {finite}")
    if err > K1_OUT_TOL or m_err > K1ML_M_TOL or l_err > K1ML_L_TOL or not empty_ok \
            or not finite:
        raise SystemExit("K1-ml disagrees with its plain version")
    return dict(q=q, k=k, v=v, tl=tl, off=offs, ref=ref, m_ref=m_ref, l_ref=l_ref, err=err,
                absd=absd, m_err=m_err, l_err=l_err, empty_rows=int(empty_rows.sum()))


def k1ml_dropped_tile(c, rows=512):
    """What K1-ml's check sees from a kernel that drops the key tile
    [64, 128) of a hop (plain fp32 math, head 0, the first ``rows`` rows):
    the worst row rel L2 of ``out`` and the worst relative change of ``l``."""
    q, k, v, off, tl = c["q"], c["k"], c["v"], int(c["off"][0]), int(c["tl"][0])
    D, rows = q.shape[-1], min(rows, q.shape[2])
    s = q[0, 0, :rows].float() @ k[0, 0].float().T * D ** -0.5
    R = off + torch.arange(rows, device="cuda")[:, None]
    cols = torch.arange(k.shape[2], device="cuda")[None]
    keep = (cols <= R) & (cols < tl) & ((cols < 64) | (cols >= 128))
    s = torch.where(keep, s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l_drop = p.sum(-1)
    out_drop = (p @ v[0, 0].float()) / l_drop[:, None]
    l_ref = c["l_ref"][0, 0, :rows]
    return (rel_l2(out_drop, c["ref"][0, 0, :rows])[0],
            ((l_drop - l_ref).abs() / l_ref).max().item())


def phase_k1ml(rng):
    """K1-ml at the three hop shapes of the sp=2 path and on the sliding-
    window geometry whose upper tiles have an empty key range, what a
    dropped key tile would show, and each hop's times."""
    Hq, Hkv = MISTRAL_7B.num_attention_heads, MISTRAL_7B.num_key_value_heads
    S_loc = SP_BUCKET // SP
    log(f"== K1-ml: the ring hops of sp={SP} over a {SP_PROMPT}-token prompt (bucket "
        f"{SP_BUCKET}, shards of {S_loc} rows)")
    q0, q1 = (bf16_normal(rng, (1, Hq, S_loc, 128)) for _ in range(2))
    k0, v0, k1, v1 = (bf16_normal(rng, (1, Hkv, S_loc, 128)) for _ in range(4))
    hops = {"rank0_own": (q0, k0, v0, SP_PROMPT, 0),
            "rank1_own": (q1, k1, v1, SP_PROMPT - S_loc, 0),
            "rank1_cross": (q1, k0, v0, SP_PROMPT, S_loc)}
    cases = {name: k1ml_case(*args) for name, args in hops.items()}
    # Rank 1's hop from shard 0 at S_loc 2048 and SW 1000: the q tiles from
    # row 3072 on start their keys at 3008 or later, past the shard's 2048.
    # (tests/test_ring_attention.py:123-149's case at the card's tile sizes;
    # Mistral's SW 4096 gives no such tile at these shard sizes.)
    edge = k1ml_case(bf16_normal(rng, (1, Hq, 2048, 128)),
                     *(bf16_normal(rng, (1, Hkv, 2048, 128)) for _ in range(2)), 4096, 2048,
                     sw=1000)
    if edge["empty_rows"] == 0:
        raise SystemExit("the sliding-window edge case has no row with an empty key range")
    out_drop, l_drop = k1ml_dropped_tile(cases["rank1_cross"])
    log(f"K1-ml: a kernel that dropped key tile [64, 128) of the cross hop would show out row "
        f"rel L2 {out_drop:.3e} ({out_drop / K1_OUT_TOL:.1f} x tol) and l rel err {l_drop:.3e} "
        f"({l_drop / K1ML_L_TOL:.1f} x tol)")
    if out_drop <= K1_OUT_TOL or l_drop <= K1ML_L_TOL:
        raise SystemExit("K1-ml's tolerances would let a dropped key tile pass")
    c = cases["rank1_cross"]
    same = bitwise_repeat(lambda: flash_prefill.flash_prefill_attention(
        c["q"], c["k"], c["v"], c["tl"], 0, row_offset=c["off"], return_ml=True))
    log(f"K1-ml two launches of the cross hop: out, m and l bitwise equal {same}")
    if not same:
        raise SystemExit("K1-ml is not deterministic")
    checks = {name: {key: c[key] for key in ("err", "absd", "m_err", "l_err")}
              for name, c in cases.items()}
    checks["sw_edge"] = {key: edge[key] for key in ("err", "absd", "m_err", "l_err",
                                                    "empty_rows")}
    del edge
    times = {}
    for name, c in cases.items():
        del c["ref"], c["m_ref"], c["l_ref"]
        times[name] = {**time_k1v(c, None, c["off"].tolist(), ml=True), **checks[name]}
    del cases, q0, q1, k0, v0, k1, v1
    torch.cuda.empty_cache()
    total = lambda key: sum(t[key] for t in times.values())
    return {"name": "flash_prefill_ring", "route": "cuda", "source": flash_prefill.SOURCE,
            "replaces": flash_prefill.REPLACES_VARIANT["ring"],
            "shape": f"the three hops of one layer at sp={SP}: B=1 Hq={Hq} Hkv={Hkv} "
                     f"S_loc={S_loc} D=128, true_len {SP_PROMPT}",
            "max_abs_err": max(c["absd"] for c in checks.values()),
            "rel_l2": max(c["err"] for c in checks.values()), "tol": K1_OUT_TOL,
            "m_max_abs_err": max(c["m_err"] for c in checks.values()), "m_tol": K1ML_M_TOL,
            "l_max_rel_err": max(c["l_err"] for c in checks.values()), "l_tol": K1ML_L_TOL,
            "sw_edge": checks["sw_edge"],
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations", "library_ms": total("library_ms"),
            "tflops": 4 * 128 * total("visible_pairs") / total("ms") / 1e9,
            "bound_fraction": total("bound_ms") / total("ms"), "deterministic": same,
            "library": "SDPA with a boolean mask (out only; it gives no (m, l))",
            "hops": times, "dropped_tile_rel_l2": out_drop, "dropped_tile_l_rel": l_drop}


def fold_case(rng, n, S, tls, sw):
    """Every rank's hops and folds of an ``n``-rank ring in one process
    (``ring_attention_emulated``) against K1 (or K1-SW) over the whole
    sequence, on each example's valid rows; the K1-ml launches it made."""
    Hq, Hkv = MISTRAL_7B.num_attention_heads, MISTRAL_7B.num_key_value_heads
    q = bf16_normal(rng, (1, Hq, S, 128))
    k, v = (bf16_normal(rng, (1, Hkv, S, 128)) for _ in range(2))
    tl = torch.tensor(tls, dtype=torch.int32, device="cuda")
    before = flash_prefill.flash_prefill_attention.variant_launches["ring"]
    out = ring_attention_emulated(q, k, v, tl, n, sw)
    sync()
    hops = flash_prefill.flash_prefill_attention.variant_launches["ring"] - before
    want = sum(hop_visible(my, src, S // n, sw) for my in range(n) for src in range(n))
    ref, _ = flash_prefill.flash_prefill_attention(q, k, v, tl, 0, sliding_window=sw)
    err, absd = k1v_worst(out, ref, k1v_valid_rows(S, tls, None))
    fold_ms = event_ms(lambda: ring_attention_emulated(q, k, v, tl, n, sw), iters=2, warmup=1)
    dense_ms = event_ms(lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, 0,
                                                                      sliding_window=sw),
                        iters=2, warmup=1)
    finite = bool(torch.isfinite(out.float()).all())
    log(f"ring fold of {n} ranks in one process, S={S} true_len={tls} sw={sw}: {hops} K1-ml "
        f"hops (expect {want} of {n * n}); against K1{'' if sw is None else '-SW'} over the "
        f"whole sequence out worst row rel L2 {err:.3e} (max abs {absd:.3e}) tol {K1_OUT_TOL}; "
        f"finite {finite}; fold {fold_ms:.3f} ms against {dense_ms:.3f} ms for one K1 call")
    if err > K1_OUT_TOL or hops != want or not finite:
        raise SystemExit("the ring fold disagrees with K1 over the whole sequence")
    return {"n": n, "S": S, "true_len": tls, "sliding_window": sw, "hops": hops,
            "rel_l2": err, "max_abs_err": absd, "fold_ms": fold_ms, "k1_ms": dense_ms}


def phase_sp_fold(rng):
    """The ring fold, emulated in one process, at the path's shape (n 2,
    32k) and at n 4, S 8192 under Mistral-7B-v0.1's 4096-token window, where
    rank 3's hop over shard 0 is skipped."""
    out = [fold_case(rng, SP, SP_BUCKET, [SP_PROMPT], None),
           fold_case(rng, 4, 8192, [8000], 4096)]
    torch.cuda.empty_cache()
    return out


def weight_checksum(params):
    """Each weight leaf's fp64 sum, layer by layer (no full-size copy)."""
    sums = [float(params[name].sum(dtype=torch.float64)) for name in
            ("embed", "final_norm", "lm_head")]
    for name in sorted(params["layers"]):
        w = params["layers"][name]
        sums.append(sum(float(w[li].sum(dtype=torch.float64)) for li in range(w.shape[0])))
    return sums


def sp_rank(rank, n, directory, prompt):
    """One rank of the sp run (a spawned process): the phase-5 weights from
    ``init_params`` (seed 0), then ``InferenceEngine(ShardingConfig(sp=n))``
    on ``prompt`` with every launch count set to 0 just before it and read
    just after; then prefill and the whole request timed, and one profiled
    prefill.  Writes its results to ``directory/rank{rank}.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Gloo's pairs over the loopback device: the ranks share one host.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=SP_TIMEOUT_S))
    try:
        cfg = MISTRAL_7B
        params = init_params(cfg, seed=0, device="cuda")
        checksum = weight_checksum(params)
        engine = InferenceEngine(params, EngineConfig(
            model=cfg, compression=SNAPKV, sharding=ShardingConfig(sp=n),
            prefill_buckets=(SP_BUCKET,)), device="cuda")
        group = engine.sp_group
        reset_counts()
        dist.barrier()
        t0 = time.perf_counter()
        ids, res = engine.generate_batch([prompt], SP_NEW, return_result=True)
        sync()
        run_s = time.perf_counter() - t0
        launches = path_launches()
        result = {"rank": rank, "checksum": checksum, "launches": launches, "ids": ids[0],
                  "lengths": sorted(set(res.cache.lengths.flatten().tolist())),
                  "logits": res.logits[0].cpu(), "run_s": run_s,
                  "run_staged_bytes": group.staged_bytes, "run_staged_s": group.staged_s}
        del res
        group.staged_bytes, group.staged_s = 0, 0.0
        dist.barrier()
        t0 = time.perf_counter()
        engine.generate_batch([prompt], 1)
        sync()
        result.update(prefill_s=time.perf_counter() - t0, prefill_staged_bytes=group.staged_bytes,
                      prefill_staged_s=group.staged_s)
        dist.barrier()
        t0 = time.perf_counter()
        engine.generate_batch([prompt], SP_NEW)
        sync()
        result["request_s"] = time.perf_counter() - t0
        result["decode_ms_per_step"] = \
            (result["request_s"] - result["prefill_s"]) / (SP_NEW - 1) * 1e3
        dist.barrier()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            engine.generate_batch([prompt], 1)
            sync()
        rows = [(evt.self_device_time_total / 1e3, evt.count, evt.key)
                for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA]
        busy = sum(r[0] for r in rows)
        hop = [(ms, cnt) for ms, cnt, key in rows if "flash_fwd_kernel" in key]
        result["prefill_device_busy_ms"] = busy if busy > 0 else None
        result["k1ml_profiled"] = None if not hop else {
            "launches": sum(c for _, c in hop), "ms_per_launch": sum(m for m, _ in hop)
            / sum(c for _, c in hop)}
        # One layer's K/V shift with both ranks idle: the staging alone (the
        # copies and the gloo exchange), with no wait for the other rank.
        kv = [torch.empty((1, cfg.num_key_value_heads, SP_BUCKET // n, cfg.head_dim),
                          dtype=torch.bfloat16, device="cuda") for _ in range(2)]
        group.shift(kv)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(4):
            group.shift(kv)
        result["idle_shift_ms"] = (time.perf_counter() - t0) / 4 * 1e3
        result["shift_bytes"] = sum(t.numel() * t.element_size() for t in kv)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(directory) / f"rank{rank}.pt")


def phase_sp(rng, params):
    """The sp=2 path end to end: the single-device engine on a 32000-token
    SnapKV request, then ``SP`` spawned ranks sharing this card (gloo, a
    file rendezvous, K/V staged through pinned host memory) on the same
    prompt and weights; launches, cache lengths, equal ranks, and
    first-token logits and streams against the single-device run."""
    cfg, L = MISTRAL_7B, MISTRAL_7B.num_hidden_layers
    log(f"== sp path: Mistral-7B-Instruct-v0.2 widths, one request of {SP_PROMPT} prompt "
        f"tokens, bucket {SP_BUCKET}, {SP_NEW} new tokens, snapkv; single device, then "
        f"sp={SP} ranks on this card over gloo")
    prompt = rng.integers(0, cfg.vocab_size, size=SP_PROMPT).tolist()
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=SNAPKV,
                                                  prefill_buckets=(SP_BUCKET,)), device="cuda")
    reset_counts()
    single_ids, res = engine.generate_batch([prompt], SP_NEW, return_result=True)
    sync()
    single_launches = path_launches()
    single_logits = res.logits[0].cpu()
    del res
    t0 = time.perf_counter()
    engine.generate_batch([prompt], 1)
    sync()
    single_prefill_s = time.perf_counter() - t0
    del engine
    torch.cuda.empty_cache()
    checksum = weight_checksum(params)
    log(f"single device: prefill {single_prefill_s:.3f} s; launches {single_launches}")

    shutil.rmtree(SP_DIR, ignore_errors=True)
    SP_DIR.mkdir(parents=True)
    ctx = torch.multiprocessing.start_processes(sp_rank, args=(SP, str(SP_DIR), prompt),
                                                nprocs=SP, start_method="spawn", join=False)
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > SP_TIMEOUT_S:
                raise SystemExit(f"the sp ranks did not finish in {SP_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(SP_DIR / f"rank{r}.pt") for r in range(SP)]

    want_launches = [dict.fromkeys(single_launches, 0) for _ in range(SP)]
    for r, w in enumerate(want_launches):
        # Rank r folds its own shard and each earlier one: r + 1 hops a layer.
        w["K1-ml"], w["K2"] = L * (r + 1), L * (SP_NEW - 1)
    want_len = [SNAPKV.max_capacity_prompt + SP_NEW - 1]
    for r, rk in enumerate(ranks):
        log(f"rank {r}: launches {rk['launches']} (expect {want_launches[r]}); cache lengths "
            f"{rk['lengths']} (expect {want_len}); weights checksum equal to this process's "
            f"{rk['checksum'] == checksum}")
        if rk["launches"] != want_launches[r]:
            raise SystemExit(f"sp rank {r} did not run each kernel the expected number of times")
        if rk["lengths"] != want_len or len(rk["ids"]) != SP_NEW:
            raise SystemExit(f"sp rank {r} left wrong cache lengths or token counts")
        if rk["checksum"] != checksum:
            raise SystemExit(f"sp rank {r} holds other weights")
        if not torch.isfinite(rk["logits"]).all():
            raise SystemExit(f"sp rank {r} gave non-finite logits")
    equal = all(rk["ids"] == ranks[0]["ids"] and torch.equal(rk["logits"][0], ranks[0]["logits"][0])
                for rk in ranks)
    rel, absd = rel_l2(ranks[0]["logits"][:1], single_logits[:1])
    log(f"sp ranks: tokens and first-token logits equal across ranks {equal}; first-token "
        f"logits against the single-device engine rel L2 {rel:.4f} (max abs {absd:.4f}) tol "
        f"{E2E_REL_L2_TOL}")
    if not equal or rel > E2E_REL_L2_TOL:
        raise SystemExit("the sp ranks disagree with each other or with the single-device run")
    # Greedy streams: identical up to the first near-tie (as phase 6 holds
    # its two drains): where they part, the single-device top two must lie
    # within twice the first token's largest logit difference.
    tie_margin = 2 * absd
    sp_ids = ranks[0]["ids"]
    apart = [j for j, (a, b) in enumerate(zip(sp_ids, single_ids[0])) if a != b]
    parted = None
    if apart:
        j = apart[0]
        top2 = single_logits[j].topk(2).values
        gap = (top2[0] - top2[1]).item()
        e = rel_l2(ranks[0]["logits"][j:j + 1], single_logits[j:j + 1])[0]
        parted = {"step": j, "top2_gap": gap, "rel_l2": e}
        if gap > tie_margin or e > E2E_REL_L2_TOL:
            raise SystemExit(f"the sp stream parts from the single-device one at step {j}, "
                             f"where the top-2 gap is {gap:.4f} (margin {tie_margin:.4f}), "
                             f"rel L2 {e:.4f}")
    log(f"greedy stream against the single-device one: identical over {SP_NEW} tokens "
        f"{not apart}; parted at a near-tie (margin {tie_margin:.4f}): {parted}")
    for r, rk in enumerate(ranks):
        hop, busy = rk["k1ml_profiled"], rk["prefill_device_busy_ms"]
        hop_text = "not measured" if hop is None else \
            f"{hop['ms_per_launch']:.3f} ms per hop over {hop['launches']} hops"
        busy_text = "not measured" if busy is None else f"{busy:.1f} ms"
        log(f"rank {r}: prefill {rk['prefill_s']:.3f} s wall (single device "
            f"{single_prefill_s:.3f} s), device busy {busy_text} (profiled, sharing the card); "
            f"K1-ml {hop_text} (profiled); staged through the host per prefill "
            f"{rk['prefill_staged_bytes'] / 1e9:.3f} GB in {rk['prefill_staged_s']:.3f} s "
            f"({rk['prefill_staged_bytes'] / L / 1e6:.1f} MB per layer), one layer's shift "
            f"with both ranks idle {rk['idle_shift_ms']:.2f} ms "
            f"({rk['shift_bytes'] / rk['idle_shift_ms'] / 1e6:.2f} GB/s each way); decode "
            f"{rk['decode_ms_per_step']:.3f} ms/step (both ranks decoding on this card)")
    keep = ("launches", "lengths", "run_s", "run_staged_bytes", "run_staged_s", "prefill_s",
            "prefill_staged_bytes", "prefill_staged_s", "request_s", "decode_ms_per_step",
            "prefill_device_busy_ms", "k1ml_profiled", "idle_shift_ms", "shift_bytes")
    return {"model": "Mistral-7B-Instruct-v0.2 widths, random weights (seed 0)",
            "compression": "snapkv 2048/8/7 maxpool, group_reduce none",
            "requests": f"one request, {SP_PROMPT} prompt tokens, bucket {SP_BUCKET}, "
                        f"{SP_NEW} new tokens",
            "sp": SP, "transport": "gloo over a file rendezvous, K/V staged through pinned "
                                   "host buffers, all ranks on one card",
            "single_device": {"launches": single_launches, "prefill_s": single_prefill_s},
            "ranks": [{key: rk[key] for key in keep} for rk in ranks],
            "ranks_equal": equal, "first_token_rel_l2_vs_single": rel,
            "first_token_max_abs_vs_single": absd, "rel_l2_tol": E2E_REL_L2_TOL,
            "tie_margin": tie_margin, "parted": parted, "spawn_to_join_s": spawn_s}


# ---------------------------------------------------------------------------
# Phase 9: Qwen2-7B-Instruct: checkpoint, W8A16 weights, sampling, harness
# ---------------------------------------------------------------------------

# The published config.json of Qwen/Qwen2-7B-Instruct
# (huggingface.co/Qwen/Qwen2-7B-Instruct): q/k/v biases (found in the
# checkpoint), an untied lm_head, the window gated off.
QWEN2_7B_HF_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "vocab_size": 152064,
    "hidden_size": 3584, "intermediate_size": 18944, "num_hidden_layers": 28,
    "num_attention_heads": 28, "num_key_value_heads": 4, "max_position_embeddings": 32768,
    "max_window_layers": 28, "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
    "sliding_window": 131072, "use_sliding_window": False, "tie_word_embeddings": False,
    "bos_token_id": 151643, "eos_token_id": 151645, "hidden_act": "silu",
    "torch_dtype": "bfloat16"}
QWEN2_7B = ModelConfig.from_hf_config(QWEN2_7B_HF_CONFIG)
# The checkpoint written and read back in 9a has the published widths and 4
# of the 28 layers (about 4 GB on disk): depth is cut for disk space and time.
LOADER_LAYERS = 4
QWEN_DIR = LOG_PATH.parent / "qwen2_ckpt"
HARNESS_DIR = LOG_PATH.parent / "harness"
QWEN_NEW, FULLKV_NEW, SAMPLE_NEW = 64, 16, 32
FULLKV = CompressionConfig(method="fullkv")
SAMPLED = GenerationConfig(max_new_tokens=SAMPLE_NEW, do_sample=True, temperature=0.7, top_k=50,
                           top_p=0.9)
NEAR_TIE = 1e-4  # a top-2 logit gap below which temperature 1e-6 may pick the runner-up
ST_TAGS = {torch.bfloat16: "BF16", torch.float32: "F32"}
# The keys each JAX runner writes per line (evals/longbench.py, ruler.py,
# needle.py).
LONGBENCH_KEYS = {"prompt", "input", "context", "answers", "pred", "length", "dataset",
                  "language", "all_classes", "_id"}
RULER_KEYS = {"input", "answers", "pred", "length", "dataset", "index"}
NEEDLE_KEYS = {"model", "context_length", "depth_percent", "needle", "model_response", "score",
               "test_duration_seconds", "test_timestamp_utc"}


def hf_layer_shapes(cfg):
    """HF tensor name (in a layer) -> shape, HF ``[out, in]`` layout."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    qd, kvd = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    return {"self_attn.q_proj.weight": (qd, h), "self_attn.q_proj.bias": (qd,),
            "self_attn.k_proj.weight": (kvd, h), "self_attn.k_proj.bias": (kvd,),
            "self_attn.v_proj.weight": (kvd, h), "self_attn.v_proj.bias": (kvd,),
            "self_attn.o_proj.weight": (h, qd), "mlp.gate_proj.weight": (f, h),
            "mlp.up_proj.weight": (f, h), "mlp.down_proj.weight": (h, f),
            "input_layernorm.weight": (h,), "post_attention_layernorm.weight": (h,)}


def random_hf_state(cfg, seed):
    """Random bf16 tensors on the card under HF names: matrices normal /
    sqrt(fan_in), biases 0.1 * normal, norms 1 + 0.1 * normal."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(name, shape):
        x = torch.randn(shape, generator=g, device="cuda")
        if name.endswith("bias"):
            x = 0.1 * x
        elif name.endswith("norm.weight"):
            x = 1 + 0.1 * x
        else:
            x = x / math.sqrt(shape[1])
        return x.to(torch.bfloat16)
    h, V = cfg.hidden_size, cfg.vocab_size
    state = {"model.embed_tokens.weight": draw("embed", (V, h))}
    for li in range(cfg.num_hidden_layers):
        for name, shape in hf_layer_shapes(cfg).items():
            state[f"model.layers.{li}.{name}"] = draw(name, shape)
    state["model.norm.weight"] = draw("model.norm.weight", (h,))
    state["lm_head.weight"] = draw("lm_head", (V, h))
    return state


def write_safetensors(path, tensors):
    """A minimal safetensors writer: 8-byte little-endian header length, the
    JSON header (padded with spaces to 8 bytes), then each tensor's bytes."""
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(memoryview(t.detach().contiguous().cpu().view(torch.uint8).numpy()))
    return 8 + len(blob) + off


def write_checkpoint(directory, hf_config, state, n_shards=2):
    """``state`` as an HF checkpoint: ``config.json``, ``n_shards`` shards in
    name order, and ``model.safetensors.index.json``."""
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    (directory / "config.json").write_text(json.dumps(hf_config))
    names = list(state)
    per = -(-len(names) // n_shards)
    weight_map, nbytes = {}, 0
    for i in range(n_shards):
        shard = f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        part = {n: state[n] for n in names[i * per:(i + 1) * per]}
        nbytes += write_safetensors(directory / shard, part)
        weight_map.update(dict.fromkeys(part, shard))
    (directory / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": nbytes}, "weight_map": weight_map}))
    return nbytes


def fused_in_memory(cfg, state):
    """The port's layout built from ``state`` by hand (independently of
    ``params_from_state_dict``): q/k/v and gate/up concatenated along the
    output axis, matrices transposed to input-major, stacked over layers."""
    lay = lambda li, n: state[f"model.layers.{li}.{n}"]  # noqa: E731

    def stack(fn):
        return torch.stack([fn(li) for li in range(cfg.num_hidden_layers)])
    return {
        "embed": state["model.embed_tokens.weight"],
        "layers": {
            "qkv_proj": stack(lambda li: torch.cat([lay(li, f"self_attn.{p}_proj.weight")
                                                    for p in "qkv"]).T),
            "o_proj": stack(lambda li: lay(li, "self_attn.o_proj.weight").T),
            "gate_up_proj": stack(lambda li: torch.cat([lay(li, "mlp.gate_proj.weight"),
                                                        lay(li, "mlp.up_proj.weight")]).T),
            "down_proj": stack(lambda li: lay(li, "mlp.down_proj.weight").T),
            "input_norm": stack(lambda li: lay(li, "input_layernorm.weight")),
            "post_norm": stack(lambda li: lay(li, "post_attention_layernorm.weight")),
            "qkv_bias": stack(lambda li: torch.cat([lay(li, f"self_attn.{p}_proj.bias")
                                                    for p in "qkv"])),
        },
        "final_norm": state["model.norm.weight"],
        "lm_head": state["lm_head.weight"].T,
    }


def flat_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def phase_loader(rng):
    """9a: a checkpoint at Qwen2-7B-Instruct's widths, 4 layers, written in
    the HF layout and read back by ``load_params``: every leaf bitwise equal
    to the fused tensors built in memory, read by the native reader, and a
    SnapKV prefill bitwise equal on the two."""
    hf_cfg = {**QWEN2_7B_HF_CONFIG, "num_hidden_layers": LOADER_LAYERS}
    cfg = ModelConfig.from_hf_config(hf_cfg)
    log(f"== 9a loader: Qwen2-7B-Instruct widths, {LOADER_LAYERS} of 28 layers, bf16, 2 shards")
    state = random_hf_state(cfg, seed=2)
    t0 = time.perf_counter()
    nbytes = write_checkpoint(QWEN_DIR, hf_cfg, state)
    write_s = time.perf_counter() - t0
    want = fused_in_memory(cfg, state)
    native.SafetensorsFile.bytes_read.update(native=0, python=0)
    sync()
    t0 = time.perf_counter()
    loaded, loaded_cfg = load_params(str(QWEN_DIR), device="cuda")
    sync()
    load_s = time.perf_counter() - t0
    read = dict(native.SafetensorsFile.bytes_read)
    tensor_bytes = sum(t.numel() * t.element_size() for t in state.values())
    got, exp = dict(flat_leaves(loaded)), dict(flat_leaves(want))
    apart = sorted(k for k in exp if k not in got or got[k].dtype != exp[k].dtype
                   or got[k].shape != exp[k].shape or not torch.equal(got[k], exp[k]))
    log(f"wrote {nbytes / 1e9:.3f} GB in {write_s:.2f} s; load_params read {tensor_bytes / 1e9:.3f} "
        f"GB in {load_s:.3f} s ({tensor_bytes / load_s / 1e9:.2f} GB/s, files just written: "
        f"page cache, then host to card); bytes by reader {read}; leaves {sorted(got)}; leaves "
        f"not bitwise equal to the in-memory fusion: {apart}; config equal "
        f"{loaded_cfg == cfg}")
    if apart or sorted(got) != sorted(exp) or loaded_cfg != cfg:
        raise SystemExit("load_params disagrees with the checkpoint's tensors")
    if read != {"native": tensor_bytes, "python": 0}:
        raise SystemExit("the native safetensors reader did not serve the load")
    prompt = rng.integers(0, cfg.vocab_size, size=(1, 4096))
    toks, tl = torch.tensor(prompt, device="cuda"), torch.tensor([4096], device="cuda")
    with torch.no_grad():
        pre = [llama.prefill(p, cfg, SNAPKV, toks, tl, SNAPKV.max_capacity_prompt + 1)
               for p in (loaded, want)]
    sync()
    same = torch.equal(pre[0].logits_last, pre[1].logits_last) and \
        torch.equal(pre[0].cache.k, pre[1].cache.k) and torch.equal(pre[0].cache.v, pre[1].cache.v)
    log(f"SnapKV prefill of one 4096-token request on the loaded and the in-memory weights: "
        f"logits and cache bitwise equal {same}")
    if not same:
        raise SystemExit("prefill on the loaded weights differs from the in-memory ones")
    del state, want, loaded, pre
    shutil.rmtree(QWEN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"layers": LOADER_LAYERS, "bytes_on_disk": nbytes, "tensor_bytes": tensor_bytes,
            "write_s": write_s, "load_s": load_s, "load_gb_s": tensor_bytes / load_s / 1e9,
            "bytes_by_reader": read, "leaves_bitwise_equal": True, "prefill_bitwise_equal": True}


def qwen_params(seed=1):
    """Random bf16 weights at full depth (``init_params``) plus random q/k/v
    biases (0.1 * normal)."""
    params = init_params(QWEN2_7B, seed=seed, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    cfg = QWEN2_7B
    width = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * cfg.head_dim
    params["layers"]["qkv_bias"] = (0.1 * torch.randn((cfg.num_hidden_layers, width), generator=g,
                                                      device="cuda")).to(torch.bfloat16)
    return params


def matmul_weight_bytes(params):
    """Bytes of the matrices a decode step streams (qkv, o, FFN, lm_head):
    bf16, or int8 codes plus fp32 scales."""
    leaves = [params["lm_head"]] + [params["layers"][k] for k in WEIGHT_QUANT_KEYS]
    return sum(sum(t.numel() * t.element_size() for t in w.values()) if isinstance(w, dict)
               else w.numel() * w.element_size() for w in leaves)


def qwen_run(params, label, comp, quant, prompts, max_new, log_file, check_prefill_a=False):
    """One ``generate_batch`` through ``InferenceEngine`` at Qwen2-7B widths,
    every launch count set to 0 just before it and read just after: launches,
    cache lengths, the last request's logits (prefill and every decode row)
    against the fp32 reference forward of the same (dequantized) weights;
    then prefill and decode times and a profiled decode step."""
    cfg, L, dev = QWEN2_7B, QWEN2_7B.num_hidden_layers, "cuda"
    decode_id = "K2" if quant is None else QUANT[quant.nbits][0]
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=comp, quant=quant),
                             device=dev)
    reset_counts()
    ids, res = engine.generate_batch(prompts, max_new, return_result=True)
    sync()
    launches = path_launches()
    steps = max_new - 1
    expect = dict.fromkeys(launches, 0)
    expect["K1"], expect[decode_id] = L, L * steps
    H = res.cache.lengths.shape[2]
    log(f"== 9b {label}: launches {launches} (expect K1 {L}, {decode_id} {L} x {steps}); "
        f"cache {type(res.cache).__name__}, {H} heads a request (G = "
        f"{cfg.num_attention_heads // H}), capacity {res.cache.capacity}")
    if launches != expect:
        raise SystemExit(f"the {label} run did not run each kernel the expected number of times")
    keep = [n if comp.method == "fullkv" else min(n, comp.max_capacity_prompt) for n in
            map(len, prompts)]
    got = [sorted(set(res.cache.lengths[:, b].flatten().tolist())) for b in range(len(prompts))]
    want = [[k + steps] for k in keep]
    log(f"  cache lengths per request {got} (expect {want}); tokens {[len(x) for x in ids]}")
    if got != want or [len(x) for x in ids] != [max_new] * len(prompts):
        raise SystemExit(f"the {label} run left wrong cache lengths or token counts")
    if not torch.isfinite(res.logits).all():
        raise SystemExit(f"the {label} run gave non-finite logits")
    decode_tol = E2E_REL_L2_TOL if quant is None else E2E_QUANT_REL_L2_TOL[quant.nbits]
    with torch.no_grad():
        seq = prompts[-1] + ids[-1][:steps]
        ref = forward_logits(params, cfg, torch.tensor([seq], device=dev))[0, len(prompts[-1]) - 1:]
        rel_a = None
        if check_prefill_a:
            ref_a = forward_logits(params, cfg, torch.tensor([prompts[0]], device=dev))[0, -1]
            rel_a = rel_l2(res.logits[0, :1], ref_a[None])[0]
            del ref_a
    rel_0, _ = rel_l2(res.logits[-1, :1], ref[:1])
    rel_d, abs_d = rel_l2(res.logits[-1, 1:], ref[1:])
    top1 = (res.logits[-1].argmax(-1) == ref.argmax(-1)).float().mean().item()
    del ref
    log(f"  vs the fp32 reference of the same weights: first token rel L2 {rel_0:.4f}"
        f"{'' if rel_a is None else f' (request a {rel_a:.4f})'} (tol {E2E_REL_L2_TOL}), "
        f"{steps} decode rows worst {rel_d:.4f} (max abs {abs_d:.4f}, tol {decode_tol}); "
        f"top-1 agreement {top1:.3f}")
    if max(rel_0, rel_a or 0.0) > E2E_REL_L2_TOL or rel_d > decode_tol:
        raise SystemExit(f"the {label} run's logits disagree with the fp32 reference")
    t0 = time.perf_counter()
    engine.generate_batch(prompts, 1)
    sync()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.generate_batch(prompts, max_new)
    sync()
    step_ms = (time.perf_counter() - t0 - prefill_s) / steps * 1e3
    rows = []
    kid, name = ONE_LAUNCH_DECODE["bf16" if quant is None else f"int{quant.nbits}"]

    def check(r):
        rows.extend(r)
        one_kernel_a_layer(r, L, kid, name)
    cur = torch.tensor([x[-1] for x in ids], device=dev)
    with torch.no_grad():
        for _ in range(2):
            llama.decode_step(params, cfg, cur, res.cache, quant=quant)
        busy_ms = profile_device(lambda: llama.decode_step(params, cfg, cur, res.cache,
                                                           quant=quant), 4, step_ms,
                                 f"decode step, Qwen2-7B {label}", log_file, check=check)
    weight_bytes = matmul_weight_bytes(params)
    log(f"  {label}: prefill {prefill_s:.3f} s; decode {step_ms:.3f} ms/step wall, device busy "
        f"{'not measured' if busy_ms is None else f'{busy_ms:.3f} ms'}; matmul weights "
        f"{weight_bytes / 1e9:.3f} GB")
    return {"launches": launches, "heads_per_request": H, "cache_capacity": res.cache.capacity,
            "prefill_s": prefill_s, "decode_ms_per_step": step_ms,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": None if busy_ms is None else 1 - busy_ms / step_ms,
            "matmul_weight_bytes": weight_bytes, "first_token_rel_l2": rel_0,
            "first_token_rel_l2_a": rel_a, "decode_rel_l2": rel_d,
            "decode_rel_l2_tol": decode_tol, "top1_agreement": top1,
            "top_device_rows": [(ms, n, key[:60]) for ms, n, key in rows[:8]]}


def g7_checks(rng):
    """K1, K2 and K3 at Qwen2-7B's G = 7 against their plain versions, at
    the path's shapes, and timed: K1 at B=2, 28 / 4 heads, S 4096; K2 and
    K3 over one fullkv request's 4 KV heads x 2 (the engine's capacity at
    bucket 4096 with 16 new tokens)."""
    cfg = QWEN2_7B
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    G = Hq // Hkv
    log(f"== 9b kernels at G = {G} against their plain versions")
    tls = [4096, 3000]
    q, k, v, tl, sc, _, e1, a1, s1 = k1_case(rng, 2, Hq, Hkv, 4096, SNAPKV.window_size, tls)
    k1 = {"shape": f"B=2 Hq={Hq} Hkv={Hkv} S=4096 w=8 true_len={tls}", "rel_l2": e1,
          "max_abs_err": a1, "scores_max_abs_err": s1,
          **time_k1(q, k, v, tl, SNAPKV.window_size, tls, sc)}
    del q, k, v, sc
    C = 4096 + FULLKV_NEW + 1
    H = 2 * Hkv
    lengths = [4000 + 8] * Hkv + [3000 + 8] * Hkv
    zeros = np.zeros(H, np.int64)
    q, kc, vc, kn, vn, lens, _, _, e2, a2 = k2_case(rng, H, G, C, lengths, zeros)
    k2 = {"shape": f"H={H} G={G} C={C}, lengths 4008 and 3008", "rel_l2": e2, "max_abs_err": a2,
          **time_k2(q, kc, vc, kn, vn, lens)}
    q, kc, vc, sc8, kn, vn, lens, _, e3, a3 = kq_case(rng, 8, H, G, C, lengths, zeros)
    k3 = {"shape": f"H={H} G={G} C={C}, lengths 4008 and 3008", "rel_l2": e3, "max_abs_err": a3,
          **time_kq(8, q, kc, vc, sc8, kn, vn, lens)}
    return {"K1": k1, "K2": k2, "K3": k3}


class ByteTokenizer:
    """A byte-level tokenizer with the interface the runners use: each UTF-8
    byte b is id b + 3; ids 0-2 are special (2 is EOS); decode drops the
    special ids and every id past the 256 byte ids."""

    eos_token_id = 2

    def encode(self, text, add_special_tokens=True):
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids, skip_special_tokens=True):
        return bytes(i - 3 for i in ids if 3 <= i < 259).decode("utf-8", errors="replace")


def plain_rouge1(reference, response):
    """ROUGE-1 f-measure over lower-cased alphanumeric words, without the
    stemmer ``rouge_score`` applies: the needle score where that package is
    not installed."""
    ref = collections.Counter(re.findall(r"[a-z0-9]+", reference.lower()))
    got = collections.Counter(re.findall(r"[a-z0-9]+", response.lower()))
    hit = sum((ref & got).values())
    if not hit:
        return 0.0
    p, r = hit / sum(got.values()), hit / sum(ref.values())
    return 2 * p * r / (p + r)


def synthetic_text(rng, n_chars):
    words = ["river", "stone", "garden", "lamp", "market", "signal", "paper", "orbit", "harbor",
             "winter", "copper", "violet", "engine", "meadow", "quartz", "ladder"]
    out, n = [], 0
    while n < n_chars:
        sentence = " ".join(rng.choice(words, size=int(rng.integers(6, 14)))).capitalize() + ". "
        out.append(sentence)
        n += len(sentence)
    return "".join(out)[:n_chars]


def check_lines(path, n, keys, what, quiet=False):
    """The ``n`` JSON lines of a runner's output file, each with ``keys`` and
    a string prediction; raises otherwise."""
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    bad = [sorted(set(r) ^ keys) for r in lines if set(r) != keys]
    if not quiet or bad or len(lines) != n:
        log(f"  {what}: {len(lines)} lines (expect {n}); keys as the JAX runner writes them "
            f"{not bad}")
    if len(lines) != n or bad or not all(isinstance(r.get("pred", r.get("model_response")), str)
                                          for r in lines):
        raise SystemExit(f"the {what} output file is incomplete or has other keys")
    return lines


def phase_harness(rng, params, log_file):
    """9d: LongBench, RULER and Needle through the W8A16 engine (SnapKV,
    bf16 cache) with a byte-level tokenizer on synthetic data, then the
    scorer; every launch count set to 0 just before and read just after."""
    cfg, L = QWEN2_7B, QWEN2_7B.num_hidden_layers
    tok = ByteTokenizer()
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=SNAPKV), device="cuda")
    shutil.rmtree(HARNESS_DIR, ignore_errors=True)
    data, out = HARNESS_DIR / "data", HARNESS_DIR / "out"
    (data / "LongBench").mkdir(parents=True)
    (data / "RULER" / "4096").mkdir(parents=True)
    (data / "haystack").mkdir(parents=True)
    model_name = "qwen2-7b-instruct"
    model_max = longbench.model_max_len(model_name)
    answers = {"hotpotqa": lambda i: [f"answer {i}"],
               "passage_retrieval_en": lambda i: [f"Paragraph {i + 3}"]}
    for dataset, ans in answers.items():
        with open(data / "LongBench" / f"{dataset}.jsonl", "w") as f:
            for i in range(2):
                f.write(json.dumps({"input": f"Which {i} came first?", "context":
                                    synthetic_text(rng, 7000), "answers": ans(i), "length": 7000,
                                    "dataset": dataset, "language": "en", "all_classes": None,
                                    "_id": f"{dataset}-{i}"}) + "\n")
    with open(data / "RULER" / "4096" / "niah_single_1.jsonl", "w") as f:
        for i in range(2):
            f.write(json.dumps({"index": i, "input": synthetic_text(rng, 3800) + " The special "
                                f"magic number is {7301 + i}. What is it?",
                                "outputs": [str(7301 + i)], "length": 3900}) + "\n")
    for i in range(3):
        (data / "haystack" / f"essay{i}.txt").write_text(synthetic_text(rng, 4000))
    try:
        import rouge_score  # noqa: F401
        scorer = "rouge_score (stemmed)"
    except ImportError:
        scorer = "unstemmed ROUGE-1 (rouge_score is not installed)"

    reset_counts()
    t0 = time.perf_counter()
    lb_dir = out / "longbench" / f"{model_name}_{SNAPKV.max_capacity_prompt}"
    lb_files = {}
    for dataset in answers:
        lb_files[dataset] = lb_dir / dataset / "snapkv.json"
        longbench.run_dataset(engine, tok, dataset, str(data / "LongBench" / f"{dataset}.jsonl"),
                              str(lb_files[dataset]), model_max, progress=False)
    lb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ruler_dir = out / "ruler" / f"{model_name}_{SNAPKV.max_capacity_prompt}" / "4096"
    ruler_file = ruler_dir / "niah_single_1" / "snapkv.json"
    ruler.run_task(engine, tok, "niah_single_1", str(data / "RULER" / "4096" /
                                                     "niah_single_1.jsonl"),
                   str(ruler_file), model_max, progress=False)
    ruler_s = time.perf_counter() - t0
    real_rouge = needle.rouge1_score
    if not scorer.startswith("rouge_score"):
        needle.rouge1_score = plain_rouge1
    try:
        t0 = time.perf_counter()
        version = f"{model_name}_snapkv_{SNAPKV.max_capacity_prompt}"
        tester = needle.NeedleHaystackTester(
            engine, tok, str(data / "haystack"), str(out / "needle"),
            context_lengths=[2048, 8000], depth_percents=[0, 50, 100], model_version=version,
            print_status=False)
        cells = tester.run()
        needle_s = time.perf_counter() - t0
    finally:
        needle.rouge1_score = real_rouge
    sync()
    launches = path_launches()
    n_prompts = 4 + 2 + len(cells)
    log(f"== 9d harness through the W8A16 engine (snapkv, bf16 cache), byte tokenizer, "
        f"synthetic data: launches {launches} (expect K1 {L} x {n_prompts} prompts, K2 > 0, "
        f"the others 0); needle scorer: {scorer}")
    if launches["K1"] != L * n_prompts or launches["K2"] == 0 or \
            any(n for kid, n in launches.items() if kid not in ("K1", "K2")):
        raise SystemExit("the harness did not run each kernel the expected number of times")
    lines = {d: check_lines(p, 2, LONGBENCH_KEYS, f"LongBench {d}") for d, p in lb_files.items()}
    check_lines(ruler_file, 2, RULER_KEYS, "RULER niah_single_1")
    cell_dir = out / "needle" / "results" / version
    cell_files = sorted(cell_dir.glob("*.json"))
    for p in cell_files:
        check_lines(p, 1, NEEDLE_KEYS, f"needle {p.name}", quiet=True)
    log(f"  needle: {len(cell_files)} cell files (expect 6), each one line with the JAX "
        f"runner's keys; scores {[round(c['score'], 3) for c in cells]}")
    if len(cells) != 6 or len(cell_files) != 6 or not all(0 <= c["score"] <= 10 for c in cells):
        raise SystemExit("the needle sweep did not write its six cells")
    # One prediction regenerated through generate_ids equals the file's.
    first = lines["hotpotqa"][0]
    ids = longbench.middle_truncate(tok.encode(first["prompt"]), model_max, tok)
    again = tok.decode(engine.generate_ids(ids, longbench.DATASET2MAXLEN["hotpotqa"],
                                           [tok.eos_token_id]))
    log(f"  hotpotqa example 0 regenerated: {len(ids)} prompt tokens; prediction equal to the "
        f"file's {again == first['pred']}")
    if again != first["pred"]:
        raise SystemExit("a regenerated prediction differs from the runner's file")
    with contextlib.redirect_stdout(log_file):  # a line per dataset and method
        lb_rows = score.score_results_dir(str(lb_dir), "longbench")
        ruler_rows = score.score_results_dir(str(ruler_dir), "ruler")
    snap = lambda rows: rows[[r[0] for r in rows].index("SnapKV")]  # noqa: E731
    scored = {d: snap(lb_rows)[lb_rows[0].index(d)] for d in answers}
    scored["niah_single_1"] = snap(ruler_rows)[ruler_rows[0].index("niah_single_1")]
    log(f"  score_results_dir: SnapKV row {scored} (-1 is a file that did not score)")
    if any(v == -1 for v in scored.values()):
        raise SystemExit("score_results_dir could not score a runner's file")
    per = {"longbench_s_per_example": lb_s / 4, "ruler_s_per_example": ruler_s / 2,
           "needle_s_per_cell": needle_s / len(cells)}
    log(f"  wall per example: LongBench {per['longbench_s_per_example']:.3f} s (about 7.2k "
        f"tokens, 32 new), RULER {per['ruler_s_per_example']:.3f} s (about 3.9k, 64 new), "
        f"needle {per['needle_s_per_cell']:.3f} s a cell (2048 or 8000 tokens, 30 new)")
    shutil.rmtree(HARNESS_DIR, ignore_errors=True)
    return {"launches": launches, "needle_scorer": scorer, "scores": scored, **per}


def host_reads(fn):
    """Device-to-host copies and host reads of a device scalar during
    ``fn``, from the profiler: (DtoH memcpy events, ``aten::_local_scalar_dense`` calls)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    dtoh = scalar = 0
    for evt in prof.key_averages():
        if "DtoH" in evt.key or "Device -> Pageable" in evt.key or "Device -> Pinned" in evt.key:
            dtoh += evt.count
        if evt.key == "aten::_local_scalar_dense":
            scalar += evt.count
    return dtoh, scalar


def phase_sampling(params, prompts):
    """9c: ``generate(do_sample=True, temperature=0.7, top_k=50, top_p=0.9)``
    on the W8A16 model: every token in its step's masked support, two runs
    from one seed bitwise equal, temperature 1e-6 greedy up to the first
    near-tie, no device-to-host copy per decode step; sampling's device time
    per step."""
    cfg = QWEN2_7B
    toks = np.zeros((len(prompts), 4096), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    cap = SNAPKV.layer_capacity(cfg.num_hidden_layers, 4096) + SAMPLE_NEW + 1

    def run(gen, seed=11):
        return generate.generate(params, cfg, SNAPKV, gen, toks, lens, cap, device="cuda",
                                 return_logits=True,
                                 rng=torch.Generator(device="cuda").manual_seed(seed))
    t0 = time.perf_counter()
    a = run(SAMPLED)
    sync()
    sampled_s = time.perf_counter() - t0
    b = run(SAMPLED)
    masked = generate.mask_logits(a.logits, SAMPLED)
    chosen = masked.gather(-1, a.tokens[..., None])[..., 0]
    support = torch.isfinite(masked).sum(-1)
    in_support = bool(torch.isfinite(chosen).all())
    same = torch.equal(a.tokens, b.tokens) and torch.equal(a.logits, b.logits)
    t0 = time.perf_counter()
    greedy = run(GenerationConfig(max_new_tokens=SAMPLE_NEW))
    sync()
    greedy_s = time.perf_counter() - t0
    cold = run(dataclasses.replace(SAMPLED, temperature=1e-6))
    top2 = greedy.logits.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).cpu()
    compared, cold_ok = [], True
    for r in range(len(prompts)):
        # Token j comes from step j's logits: a near-tie there may go to the
        # runner-up, so the streams are compared on the steps before it.
        ties = (gap[r] < NEAR_TIE).nonzero()
        upto = int(ties[0]) if len(ties) else SAMPLE_NEW
        compared.append(upto)
        cold_ok &= torch.equal(cold.tokens[r, :upto], greedy.tokens[r, :upto])
    log(f"== 9c sampling (T 0.7, top-k 50, top-p 0.9, {SAMPLE_NEW} tokens, B=2) on the W8A16 "
        f"model: every token in its step's masked support {in_support} (support sizes "
        f"{int(support.min())}-{int(support.max())}); two runs from one seed bitwise equal "
        f"{same}; T 1e-6 equal to greedy over the first {compared} steps (before the first "
        f"top-2 gap below {NEAR_TIE}) {cold_ok}")
    if not (in_support and same and cold_ok):
        raise SystemExit("sampling drew outside its support, or is not repeatable, or T 1e-6 "
                         "is not greedy")
    short = dataclasses.replace(SAMPLED, max_new_tokens=4)
    reads = {n: host_reads(lambda n=n: run(dataclasses.replace(short, max_new_tokens=n)))
             for n in (4, 12)}
    log(f"  device-to-host copies and host scalar reads per generate (no EOS ids): 4 tokens "
        f"{reads[4]}, 12 tokens {reads[12]}; the 8 decode steps between add none "
        f"{reads[4] == reads[12]}")
    if reads[4] != reads[12]:
        raise SystemExit("a sampled decode step reads the device from the host")
    g = torch.Generator(device="cuda").manual_seed(3)
    row = a.logits[:, 1].contiguous()
    noise = generate.gumbel_draw(g, 1, tuple(row.shape))
    draw_ms = event_ms(lambda: generate.sample_token(row, SAMPLED, noise), iters=20)
    noise_ms = event_ms(lambda: generate.gumbel_draw(g, 1, tuple(row.shape)), iters=20)
    per_step = (sampled_s - greedy_s) / (SAMPLE_NEW - 1) * 1e3
    log(f"  sampling's device time per step at B=2, V={cfg.vocab_size}: mask and draw "
        f"{draw_ms:.4f} ms, Gumbel noise {noise_ms:.4f} ms (events); whole request sampled "
        f"{sampled_s:.3f} s against greedy {greedy_s:.3f} s ({per_step:.3f} ms/step wall apart, "
        f"host-bound)")
    return {"in_support": in_support, "repeatable": same, "cold_equals_greedy_steps": compared,
            "host_reads_4_vs_12_tokens": [list(reads[4]), list(reads[12])],
            "mask_and_draw_ms": draw_ms, "gumbel_ms": noise_ms, "sampled_request_s": sampled_s,
            "greedy_request_s": greedy_s, "wall_ms_per_step_apart": per_step}


def phase_qwen2(rng, log_file):
    """Phase 9: the checkpoint-to-score path at Qwen2-7B-Instruct widths."""
    cfg = QWEN2_7B
    loader = phase_loader(rng)
    log(f"== 9b Qwen2-7B-Instruct widths, 28 layers, random bf16 weights + q/k/v biases (seed "
        f"1), then quantize_weights (W8A16)")
    params = qwen_params()
    t0 = time.perf_counter()
    qparams = quantize_weights(params)
    sync()
    quant_s = time.perf_counter() - t0
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (4096, 1500)]
    full_prompt = [rng.integers(0, cfg.vocab_size, size=4000).tolist()]
    runs = {"w8a16_bf16": qwen_run(qparams, "W8A16 weights, bf16 cache", SNAPKV, None, prompts,
                                   QWEN_NEW, log_file, check_prefill_a=True),
            "w8a16_int8": qwen_run(qparams, "W8A16 weights, int8 cache", SNAPKV,
                                   QuantConfig(nbits=8), prompts, QWEN_NEW, log_file),
            "w8a16_fullkv_bf16": qwen_run(qparams, "W8A16 weights, fullkv, bf16 cache", FULLKV,
                                          None, full_prompt, FULLKV_NEW, log_file),
            "w8a16_fullkv_int8": qwen_run(qparams, "W8A16 weights, fullkv, int8 cache", FULLKV,
                                          QuantConfig(nbits=8), full_prompt, FULLKV_NEW,
                                          log_file),
            "bf16_bf16": qwen_run(params, "bf16 weights, bf16 cache", SNAPKV, None, prompts,
                                  QWEN_NEW, log_file)}
    torch.cuda.empty_cache()
    b16, w8 = runs["bf16_bf16"], runs["w8a16_bf16"]
    log(f"W8A16 against bf16 weights (snapkv, bf16 cache, B=2): prefill {w8['prefill_s']:.3f} / "
        f"{b16['prefill_s']:.3f} s; decode busy {w8['device_busy_ms_per_step']} / "
        f"{b16['device_busy_ms_per_step']} ms a step, wall {w8['decode_ms_per_step']:.3f} / "
        f"{b16['decode_ms_per_step']:.3f} ms; matmul weights {w8['matmul_weight_bytes'] / 1e9:.3f}"
        f" / {b16['matmul_weight_bytes'] / 1e9:.3f} GB; quantize_weights {quant_s:.2f} s")
    g7 = g7_checks(rng)
    del params
    torch.cuda.empty_cache()
    sampling = phase_sampling(qparams, prompts)
    harness = phase_harness(rng, qparams, log_file)
    del qparams
    torch.cuda.empty_cache()
    return {"model": "Qwen2-7B-Instruct widths (28 layers; the loader's checkpoint 4), random "
                     "weights (seeds 1, 2) with q/k/v biases",
            "compression": "snapkv 2048/8/7 maxpool, group_reduce none; fullkv",
            "requests": f"B=2: 4096 and 1500 prompt tokens, {QWEN_NEW} new; fullkv one of 4000, "
                        f"{FULLKV_NEW} new; bucket 4096",
            "loader": loader, "quantize_s": quant_s, "runs": runs, "g7": g7,
            "sampling": sampling, "harness": harness}

# ---------------------------------------------------------------------------
# Phase 10: the cache layer at Meta-Llama-3-8B-Instruct widths
# ---------------------------------------------------------------------------

# The fields the forward reads from the published config.json of
# meta-llama/Meta-Llama-3-8B-Instruct (bf16 weights, untied lm_head, no rope
# scaling).
LLAMA3_8B_HF_CONFIG = {
    "model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "max_position_embeddings": 8192, "rope_theta": 500000.0,
    "rms_norm_eps": 1e-05, "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
LLAMA3_8B = ModelConfig.from_hf_config(LLAMA3_8B_HF_CONFIG)
# 10a: the grouped caches, each with its new tokens (limits: GROUPED_REL_L2_TOL).
GROUPED_RUNS = (
    ("nbits2_outliers_ring128", QuantConfig(nbits=2, q_group_size=64, outlier_extract=True,
                                            residual_length=128), 32),
    ("nbits4_ring128", QuantConfig(nbits=4, residual_length=128), 32),
    ("nbits3", QuantConfig(nbits=3), 16))
THINK_PACKED = dataclasses.replace(SNAPKV, method="think", pruning_ratio=0.4, recent_size=32,
                                   think_packed=True)
EVICT = dataclasses.replace(SNAPKV, decode_evict=True, eviction_recent=32)
LLAMA3_NEW, EVICT_NEW, EVICT_HEADROOM, OFFLOAD_RING, CKPT_STEPS = 32, 64, 8, 32, 8
CKPT_DIR = LOG_PATH.parent / "generation_state"
# Two bf16 computations of one function held against each other (ThinK's
# packed cache against the in-place one; the evicting run against plain
# snapkv before it fills; the offloaded decode against the device-resident
# one): each path rounds every activation to bf16 and sits ~0.017 from fp32
# (phase 5), so two of them sit ~0.025 apart; a wrong row, channel or
# mask moves a row by O(1).
PAIR_REL_L2_TOL = 0.05
# PCIe 5.0 x16, one direction (the PCI-SIG rate): the host link's bound.
HOST_LINK_BYTES_PER_S = 64e9


def cache_bytes(cache):
    """Bytes of every tensor of a cache (computed), split into the card's and
    the host's."""
    dev = host = 0
    for t in cache:
        if t is not None:
            n = t.numel() * t.element_size()
            dev, host = (dev + n, host) if t.is_cuda else (dev, host + n)
    return dev, host


def valid_row_bytes(cache):
    """Bytes a decode step must read of a cache at its final lengths
    (computed): each per-row tensor's bytes times the valid share of its
    rows, and the ring whole."""
    share = cache.lengths.float().mean().item() / cache.capacity
    total = 0
    for name, t in cache._asdict().items():
        if t is None or name in ("lengths", "positions"):
            continue
        n = t.numel() * t.element_size()
        total += n if name in ("rk", "rv") else n * share
    return total


def llama3_ref(params, seq, start, refs):
    """fp32 reference logits of ``seq`` from row ``start`` on (memoised)."""
    key = (tuple(seq), start)
    if key not in refs:
        with torch.no_grad():
            refs[key] = forward_logits(params, LLAMA3_8B, torch.tensor([seq], device="cuda"))[
                0, start:].clone()
    return refs[key]


def engine_run(params, prompts, comp, quant, new):
    """One ``generate_batch`` through ``InferenceEngine`` with every launch
    count set to 0 just before it and read just after; the engine, ids,
    result, launches and the call's wall seconds."""
    cfg = LLAMA3_8B
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=comp, quant=quant),
                             device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    ids, res = engine.generate_batch(prompts, new, return_result=True)
    sync()
    return engine, ids, res, path_launches(), time.perf_counter() - t0


def expect_launches(launches, label, decode_id=None, steps=0, prefills=1):
    L = LLAMA3_8B.num_hidden_layers
    expect = dict.fromkeys(launches, 0)
    expect["K1"] = L * prefills
    if decode_id:
        expect[decode_id] = L * steps
    log(f"  {label}: launches {launches} (expect K1 {L * prefills}"
        f"{f', {decode_id} {L * steps}' if decode_id else ', no decode kernel'})")
    if launches != expect:
        raise SystemExit(f"the {label} run did not run each kernel the expected number of times")


def time_engine(engine, prompts, new, wall_s, label, log_file, params, cur, cache, quant=None):
    """Prefill s (host clock around a prefill-only call that ends in a
    synchronise), decode wall ms a step (the checked run's ``wall_s`` less
    that, over its steps) and a profiled decode step's busy time."""
    t0 = time.perf_counter()
    engine.generate_batch(prompts, 1)
    sync()
    prefill_s = time.perf_counter() - t0
    step_ms = (wall_s - prefill_s) / (new - 1) * 1e3
    evr = engine.cfg.compression.eviction_recent
    with torch.no_grad():
        busy = profile_device(lambda: llama.decode_step(params, LLAMA3_8B, cur, cache, quant=quant,
                                                        eviction_recent=evr), 4, step_ms,
                              f"decode step, Llama-3-8B {label}", log_file)
    return prefill_s, step_ms, busy


def grouped_values_check(cache, quant, ref_layers, plen, label):
    """The grouped cache's prefill rows of layers 0 and 31 against the plain
    ``encode`` on the CPU in fp32 of the bf16 run's rows (its prefill is the
    same): scales, zeros and outliers bitwise, codes equal or one step apart
    where the CPU's quotient sits on a rounding tie, the ring's slots that
    back prefill rows bitwise.  Returns the worst dequantized difference."""
    nbits, gs = quant.nbits, quant.q_group_size
    worst = apart = 0
    for li, pair in ref_layers.items():
        for b, P in enumerate(plen):
            for x, planes, ring in (
                    (pair[0], (cache.qk, cache.k_scale, cache.k_zero, cache.k_oval,
                               cache.k_oidx), cache.rk),
                    (pair[1], (cache.qv, cache.v_scale, cache.v_zero, cache.v_oval,
                               cache.v_oidx), cache.rv)):
                xs = x[b, :, :P].float()
                want = quant_cache.encode(xs, quant)
                got = [None if t is None else t[li, b, :, :P].cpu() for t in planes]
                for g, w in zip(got[1:], want[1:]):
                    if (g is None) != (w is None) or (g is not None and not torch.equal(g, w)):
                        raise SystemExit(f"{label}: layer {li}'s scales, zeros or outliers "
                                         "differ from the CPU's")
                gc = quant_cache.unpack_codes(got[0], nbits).int()
                wc = quant_cache.unpack_codes(want[0], nbits).int()
                stripped = (quant_cache.extract_group_outliers(xs, gs)[0]
                            if quant.outlier_extract else xs)
                _, scale, zero = quant_cache.quantize_groups(stripped, gs, nbits)
                quot = ((stripped.reshape(*xs.shape[:-1], -1, gs) - zero[..., None])
                        / scale[..., None]).reshape(xs.shape)
                tie = ((quot - quot.floor()) - 0.5).abs() < 1e-3
                diff = gc != wc
                if ((gc - wc).abs() > 1).any() or (diff & ~tie).any():
                    raise SystemExit(f"{label}: layer {li}'s codes differ from the CPU's off a "
                                     "rounding tie")
                apart += int(diff.sum())
                dv = (quant_cache.decode_values(*got[:3], quant, torch.float32, *got[3:])
                      - quant_cache.decode_values(*want[:3], quant, torch.float32, *want[3:]))
                worst = max(worst, dv.abs().max().item())
                if ring is not None:
                    R, Lf = ring.shape[3], int(cache.lengths[li, b, 0])
                    j = torch.arange(R)
                    rows = Lf - R + torch.remainder(j - (Lf - R), R)
                    old = rows < P
                    if not torch.equal(ring[li, b].cpu()[:, old], x[b][:, rows[old]]):
                        raise SystemExit(f"{label}: layer {li}'s ring rows differ from the "
                                         "bf16 cache's")
    return worst, apart


def phase_grouped(params, prompts, refs, log_file):
    """10a: the bf16 baseline, then each grouped cache through
    ``InferenceEngine``."""
    cfg, L = LLAMA3_8B, LLAMA3_8B.num_hidden_layers
    plen = [min(len(p), SNAPKV.max_capacity_prompt) for p in prompts]
    out = {}
    log("== 10a bf16 cache (the baseline the grouped caches are read beside)")
    engine, ids, res, launches, wall = engine_run(params, prompts, SNAPKV, None, LLAMA3_NEW)
    expect_launches(launches, "bf16", "K2", LLAMA3_NEW - 1)
    ref_layers = {li: (res.cache.k[li].cpu(), res.cache.v[li].cpu()) for li in (0, L - 1)}
    cur = torch.tensor([x[-1] for x in ids], device="cuda")
    prefill_s, step_ms, busy = time_engine(engine, prompts, LLAMA3_NEW, wall, "bf16", log_file,
                                           params, cur, res.cache)
    weight_bytes = matmul_weight_bytes(params)
    bound = (weight_bytes + valid_row_bytes(res.cache)) / HBM_BYTES_PER_S * 1e3
    out["bf16"] = {"launches": launches, "prefill_s": prefill_s, "decode_ms_per_step": step_ms,
                   "device_busy_ms_per_step": busy, "cache_bytes": cache_bytes(res.cache)[0],
                   "decode_bound_ms": bound,
                   "idle_share": None if busy is None else 1 - busy / step_ms}
    log(f"  bf16: prefill {prefill_s:.3f} s, decode {step_ms:.3f} ms/step wall, busy {busy} ms, "
        f"bound {bound:.3f} ms")
    del engine, res
    torch.cuda.empty_cache()
    for label, quant, new in GROUPED_RUNS:
        steps = new - 1
        log(f"== 10a grouped cache {label}: {quant}")
        engine, ids, res, launches, wall = engine_run(params, prompts, SNAPKV, quant, new)
        expect_launches(launches, label, None)
        c = res.cache
        lens = [sorted(set(c.lengths[:, b].flatten().tolist())) for b in range(2)]
        log(f"  cache {type(c).__name__}, capacity {c.capacity}, ring {c.residual_length}, "
            f"outliers {c.k_oval is not None}; lengths {lens} (expect "
            f"{[[p + steps] for p in plen]})")
        if not isinstance(c, quant_cache.QuantizedKVCache) or lens != [[p + steps] for p in plen]:
            raise SystemExit(f"the {label} run built the wrong cache or lengths")
        worst, apart = grouped_values_check(c, quant, ref_layers, plen, label)
        log(f"  layers 0 and {L - 1}, prefill rows against the CPU's encode of the bf16 run's "
            f"rows: scales, zeros, outliers and ring rows bitwise; {apart} codes one step apart "
            f"on ties; dequantized values apart by at most {worst:.3e}")
        seq_b = prompts[1] + ids[1][:steps]
        ref_b = llama3_ref(params, seq_b, len(prompts[1]) - 1, refs)
        rel_0 = rel_l2(res.logits[1, :1], ref_b[:1])[0]
        rel_d = rel_l2(res.logits[1, 1:], ref_b[1:])[0]
        tol = GROUPED_REL_L2_TOL[label]
        log(f"  request (b) against the fp32 reference: first token rel L2 {rel_0:.4f} (tol "
            f"{E2E_REL_L2_TOL}), {steps} decode rows worst {rel_d:.4f} (tol {tol})")
        if rel_0 > E2E_REL_L2_TOL or rel_d > tol or not torch.isfinite(res.logits).all():
            raise SystemExit(f"the {label} run's logits disagree with the fp32 reference")
        cur = torch.tensor([x[-1] for x in ids], device="cuda")
        prefill_s, step_ms, busy = time_engine(engine, prompts, new, wall, label, log_file,
                                               params, cur, c, quant)
        nbytes = cache_bytes(c)[0]
        bound = (weight_bytes + valid_row_bytes(c)) / HBM_BYTES_PER_S * 1e3
        log(f"  {label}: prefill {prefill_s:.3f} s; decode {step_ms:.3f} ms/step wall, busy "
            f"{busy} ms (bf16 {out['bf16']['device_busy_ms_per_step']}); cache {nbytes / 1e9:.3f} "
            f"GB (bf16 {out['bf16']['cache_bytes'] / 1e9:.3f}); decode bound {bound:.3f} ms")
        out[label] = {"launches": launches, "capacity": c.capacity, "prefill_s": prefill_s,
                      "decode_ms_per_step": step_ms, "device_busy_ms_per_step": busy,
                      "idle_share": None if busy is None else 1 - busy / step_ms,
                      "cache_bytes": nbytes, "decode_bound_ms": bound,
                      "dequant_max_abs_vs_cpu": worst, "codes_apart_on_ties": apart,
                      "first_token_rel_l2_b": rel_0, "decode_rel_l2_b": rel_d,
                      "decode_rel_l2_tol": tol}
        del engine, res, c
        torch.cuda.empty_cache()
    return out


def agree_rows(ids_x, ids_y):
    """Logits rows computed from equal inputs: up to and including the first
    step whose chosen tokens differ."""
    n = 0
    while n < len(ids_x) - 1 and ids_x[n] == ids_y[n]:
        n += 1
    return n + 1


def phase_think_packed(params, prompts, log_file):
    """10b: ThinK with the channel-packed cache and in place (K2)."""
    L, D = LLAMA3_8B.num_hidden_layers, LLAMA3_8B.head_dim
    steps = LLAMA3_NEW - 1
    log("== 10b ThinK, pruning ratio 0.4, recent 32: packed cache, then in place")
    engine, ids, res, launches, wall = engine_run(params, prompts, THINK_PACKED, None,
                                                  LLAMA3_NEW)
    expect_launches(launches, "think packed", None)
    inplace = engine_run(params, prompts, dataclasses.replace(THINK_PACKED, think_packed=False),
                         None, LLAMA3_NEW)
    expect_launches(inplace[3], "think in place", "K2", steps)
    c, d = res.cache, inplace[2].cache
    keep = D - int(D * THINK_PACKED.pruning_ratio)
    ascending = bool((c.channels.diff(dim=-1) > 0).all()) if isinstance(c, ThinKCache) else False
    if not isinstance(c, ThinKCache) or c.kept_dim != keep or not ascending:
        raise SystemExit("the packed run built the wrong cache or channels")
    key_ratio = (c.kp.numel() + c.kd.numel()) / d.k.numel()
    log(f"  packed cache: {keep} kept channels per (layer, head), ascending; dense buffer "
        f"{c.dense_capacity} rows; key bytes against the in-place cache's {key_ratio:.4f} "
        f"(computed)")
    n = agree_rows(ids[0], inplace[1][0])
    rel_a = rel_l2(res.logits[0, :n], inplace[2].logits[0, :n])[0]
    # Request (b) is under the budget: the in-place cache keeps it dense, the
    # packed one prunes its rows below length - recent all the same.
    zero_b = int((d.k[:, 1, :, :len(prompts[1])] == 0).all(dim=2).sum())
    bnd_b = sorted(set(c.boundary[:, 1].flatten().tolist()))
    log(f"  request (a), packed against in place: {n} rows from equal inputs, worst rel L2 "
        f"{rel_a:.4f} (tol {PAIR_REL_L2_TOL}); request (b): the in-place cache has {zero_b} zero "
        f"channels (expect 0), the packed one's boundary {bnd_b} (expect "
        f"[{len(prompts[1]) - THINK_PACKED.recent_size}])")
    if rel_a > PAIR_REL_L2_TOL or zero_b or bnd_b != [len(prompts[1]) - THINK_PACKED.recent_size]:
        raise SystemExit("ThinK's packed and in-place caches disagree")
    cur = torch.tensor([x[-1] for x in ids], device="cuda")
    prefill_s, step_ms, busy = time_engine(engine, prompts, LLAMA3_NEW, wall, "think packed",
                                           log_file, params, cur, c)
    out = {"launches": launches, "launches_in_place": inplace[3], "kept_channels": keep,
           "dense_capacity": c.dense_capacity, "key_bytes_ratio": key_ratio,
           "rows_compared": n, "rel_l2_packed_vs_in_place_a": rel_a, "prefill_s": prefill_s,
           "decode_ms_per_step": step_ms, "device_busy_ms_per_step": busy}
    log(f"  think packed: prefill {prefill_s:.3f} s, decode {step_ms:.3f} ms/step wall, busy "
        f"{busy} ms")
    del engine, res, inplace, c, d
    torch.cuda.empty_cache()
    return out


def phase_evict(params, prompts, refs):
    """10c: decode-stage eviction through ``generate``: request (a) fills
    its cache after 8 appends and evicts from then on."""
    cfg, L = LLAMA3_8B, LLAMA3_8B.num_hidden_layers
    steps = EVICT_NEW - 1
    cap = SNAPKV.layer_capacity(L, 4096) + EVICT_HEADROOM
    toks = np.zeros((2, 4096), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = [len(p) for p in prompts]
    gen_cfg = GenerationConfig(max_new_tokens=EVICT_NEW)
    log(f"== 10c decode eviction: capacity {cap}, eviction_recent {EVICT.eviction_recent}, "
        f"{EVICT_NEW} new tokens")
    reset_counts()
    t0 = time.perf_counter()
    res = generate.generate(params, cfg, EVICT, gen_cfg, toks, lens, cap, return_logits=True)
    sync()
    wall = time.perf_counter() - t0
    launches = path_launches()
    expect_launches(launches, "evicting", None)
    c = res.cache
    pos = c.positions.tolist()
    end = lens[0] + steps
    stamps_a = c.stamps[:, 0]
    recent = torch.arange(end - EVICT.eviction_recent, end, device="cuda")
    present = bool((stamps_a[..., None] == recent).any(dim=2).all())
    valid = torch.arange(cap, device="cuda") < c.lengths[..., None]
    scores_ok = bool((c.scores[valid] >= 0).all()) and bool((c.scores[valid] > 0).any())
    evictions = sorted(set(((end - lens[0]) - (c.lengths[:, 0] - 2048)).flatten().tolist()))
    log(f"  lengths max {int(c.lengths.max())} (capacity {cap}), per request "
        f"{[sorted(set(c.lengths[:, b].flatten().tolist())) for b in range(2)]}; positions {pos} "
        f"(expect {[n + steps for n in lens]}); last {EVICT.eviction_recent} positions present "
        f"in every (layer, head) of (a): {present}; scores non-negative and some positive: "
        f"{scores_ok}; evictions per (layer, head) of (a): {evictions}")
    if int(c.lengths.max()) > cap or pos != [n + steps for n in lens] or not present or \
            not scores_ok or evictions != [steps - EVICT_HEADROOM]:
        raise SystemExit("the evicting cache broke its rules")
    plain = generate.generate(params, cfg, SNAPKV, gen_cfg, toks, lens,
                              SNAPKV.layer_capacity(L, 4096) + EVICT_NEW + 1, return_logits=True)
    launches_plain = path_launches()
    n = min(EVICT_HEADROOM + 1, agree_rows(res.tokens[0].tolist(), plain.tokens[0].tolist()))
    rel_fill = rel_l2(res.logits[0, :n], plain.logits[0, :n])[0]
    seq_b = prompts[1] + res.tokens[1, :steps].tolist()
    ref_b = llama3_ref(params, seq_b, lens[1] - 1, refs)
    rel_b = rel_l2(res.logits[1], ref_b)[0]
    log(f"  request (a) before the cache fills, against plain snapkv (K2): {n} rows, worst rel "
        f"L2 {rel_fill:.4f} (tol {PAIR_REL_L2_TOL}); request (b) (never full) against the fp32 "
        f"reference: worst rel L2 {rel_b:.4f} (tol {E2E_REL_L2_TOL})")
    if rel_fill > PAIR_REL_L2_TOL or rel_b > E2E_REL_L2_TOL:
        raise SystemExit("the evicting run's logits disagree")
    out = {"launches": launches, "capacity": cap, "evictions_per_head_a": evictions[0],
           "wall_s": wall, "rows_before_fill": n, "rel_l2_vs_plain_before_fill": rel_fill,
           "rel_l2_b_vs_fp32": rel_b, "launches_plain_run": launches_plain}
    del res, plain, c
    torch.cuda.empty_cache()
    return out


def h2d_profile(fn, path):
    """Host-to-device copies of one call of ``fn`` from the profiler's chrome
    trace: (pinned bytes, their copy ms, other host-to-device bytes, copy
    records, ``cudaMemcpy*`` calls).  As in ``profile_device``, the card
    idles ``PROFILE_MARGIN_S`` at each edge of the window, and a trace in
    which some call has no device record (by correlation id) is taken
    again, up to ``PROFILE_ATTEMPTS`` times; the last trace is returned,
    whole or not (after the earlier phases the profiler has dropped the
    same few copy records on every try)."""
    fn()
    sync()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            fn()
            sync()
            time.sleep(PROFILE_MARGIN_S)
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())
        path.unlink()
        events = events["traceEvents"] if isinstance(events, dict) else events
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
        calls = {e["args"].get("correlation") for e in events if e.get("cat") == "cuda_runtime"
                 and e.get("name", "").startswith("cudaMemcpy")}
        missing = calls - {e["args"].get("correlation") for e in copies}
        if not missing:
            break
        log(f"h2d profile, attempt {attempt}: incomplete device trace, {len(missing)} of "
            f"{len(calls)} copies have no record")
    pinned = ms = other = 0
    for e in copies:
        if "HtoD" in e.get("name", ""):
            if "Pinned" in e["name"]:
                pinned += int(e["args"]["bytes"])
                ms += e["dur"] / 1e3
            else:
                other += int(e["args"]["bytes"])
    return pinned, ms, other, len(copies), len(calls)


def phase_offload(params, prompts, refs):
    """10d: prefill (snapkv) into a cache of the policy's capacity, offload
    it with a 32-slot ring, 32 decode steps."""
    cfg, L = LLAMA3_8B, LLAMA3_8B.num_hidden_layers
    cap = SNAPKV.layer_capacity(L, 4096)
    toks = torch.zeros((2, 4096), dtype=torch.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    toks = toks.cuda()
    tl = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    log(f"== 10d host-offloaded cache: prefill capacity {cap}, ring {OFFLOAD_RING}")
    reset_counts()
    def card_memory():
        """(bytes the allocator hands out, bytes the program asked for):
        ``memory_allocated`` counts whole blocks, and the allocator leaves a
        cached block unsplit when less than 1 MiB would remain, so each
        large tensor may count up to 1 MiB more than it asked for."""
        return (torch.cuda.memory_allocated(),
                torch.cuda.memory_stats()["requested_bytes.all.current"])

    with torch.no_grad():
        m0 = card_memory()
        pre = llama.prefill(params, cfg, SNAPKV, toks, tl, cap)
        logits0 = pre.logits_last
        sync()
        m1 = card_memory()
        dense_bytes = cache_bytes(pre.cache)[0]
        off = offload_kv_cache(pre.cache, OFFLOAD_RING)
        del pre
        sync()
        m2 = card_memory()
        ring_bytes, host_bytes = cache_bytes(off)
        pinned = off.hk.is_pinned() and off.hv.is_pinned()
        # Offloading frees the dense cache's card memory and allocates the
        # ring and its lengths: the requested bytes change by the difference.
        freed = m1[1] - m2[1]
        log(f"  host K/V pinned: {pinned}, {host_bytes / 1e9:.3f} GB; card memory allocated "
            f"{(m1[0] - m0[0]) / 1e9:.3f} GB above the weights with the dense cache "
            f"({dense_bytes / 1e9:.3f} GB of it), {(m2[0] - m0[0]) / 1e6:.3f} MB after "
            f"offloading; requested bytes freed {freed} (expect the dense cache less the ring "
            f"and lengths, {dense_bytes - ring_bytes})")
        if not pinned or freed != dense_bytes - ring_bytes:
            raise SystemExit("the offloaded cache's host K/V is not pinned, or its card memory "
                             "is not the ring alone")
        cur = logits0.argmax(-1)
        fed, rows = [cur], [logits0]
        t0 = time.perf_counter()
        for _ in range(OFFLOAD_RING):
            lg, off = llama.decode_step(params, cfg, cur, off)
            cur = lg.argmax(-1)
            fed.append(cur)
            rows.append(lg)
        sync()
        step_ms = (time.perf_counter() - t0) / OFFLOAD_RING * 1e3
        launches = path_launches()
        expect_launches(launches, "offloaded", None)
        lens = off.lengths - off.prefill_len
        if int(lens.max()) != OFFLOAD_RING:
            raise SystemExit("the offloaded ring did not take every append")
        # One more step (the ring full: its append is dropped): the bytes
        # the prefetch queues by its own count, then under the profiler.
        LayerPrefetch.bytes_copied = 0
        llama.decode_step(params, cfg, cur, off)
        sync()
        queued = LayerPrefetch.bytes_copied
        pinned_bytes, copy_ms, other, records, calls = h2d_profile(
            lambda: llama.decode_step(params, cfg, cur, off), LOG_PATH.parent / "h2d.json")
        gbs = pinned_bytes / copy_ms / 1e6 if copy_ms else None
        valid = host_bytes * (off.prefill_len.float().mean().item() / off.host_capacity)
        link_ms = host_bytes / HOST_LINK_BYTES_PER_S * 1e3
        log(f"  decode {step_ms:.3f} ms/step wall; a step queues {queued / 1e9:.4f} GB of "
            f"host-to-device copies (the host cache {host_bytes / 1e9:.4f} GB); the profiled "
            f"step's trace: {records} copy records for {calls} calls, {pinned_bytes / 1e9:.4f} GB "
            f"pinned host-to-device (other host-to-device {other} bytes) in {copy_ms:.3f} ms, "
            f"{gbs if gbs is None else round(gbs, 2)} GB/s; link bound {link_ms:.3f} ms a step "
            f"at 64 GB/s ({valid / 1e9:.3f} GB of valid rows)")
        if queued != host_bytes or other or not pinned_bytes or \
                (records == calls and pinned_bytes != host_bytes):
            raise SystemExit("a decode step did not copy the host cache to the card once")
        logits = torch.stack(rows, dim=1)
        seq_b = prompts[1] + [int(t[1]) for t in fed[:-1]]
        ref_b = llama3_ref(params, seq_b, len(prompts[1]) - 1, refs)
        rel_b = rel_l2(logits[1], ref_b)[0]
        # The same tokens through the device-resident cache (K2).
        dense = KVCache(*(torch.cat([h.cuda(), torch.zeros_like(h[:, :, :, :OFFLOAD_RING],
                                                                device="cuda")], dim=3)
                          for h in (off.hk, off.hv)), off.prefill_len.clone(), tl.clone())
        dev_rows = [logits0]
        for t in fed[:-1]:
            lg, dense = llama.decode_step(params, cfg, t, dense)
            dev_rows.append(lg)
        rel_dev = rel_l2(logits.reshape(-1, logits.shape[-1]),
                         torch.stack(dev_rows, dim=1).reshape(-1, logits.shape[-1]))[0]
        del dense
    log(f"  request (b) against the fp32 reference: worst rel L2 {rel_b:.4f} (tol "
        f"{E2E_REL_L2_TOL}); against the device-resident decode of the same cache and tokens: "
        f"{rel_dev:.4f} (tol {PAIR_REL_L2_TOL})")
    if rel_b > E2E_REL_L2_TOL or rel_dev > PAIR_REL_L2_TOL:
        raise SystemExit("the offloaded decode's logits disagree")
    return {"launches": launches, "host_bytes": host_bytes, "valid_host_bytes": valid,
            "ring_card_bytes": ring_bytes, "card_bytes_after_offload": m2[0] - m0[0],
            "dense_cache_card_bytes": dense_bytes, "decode_ms_per_step": step_ms,
            "h2d_bytes_queued_per_step": queued, "h2d_trace_records": [records, calls],
            "h2d_pinned_bytes_per_step": pinned_bytes, "h2d_copy_ms_per_step": copy_ms,
            "h2d_gb_s": gbs, "link_bound_ms": link_ms, "rel_l2_b_vs_fp32": rel_b,
            "rel_l2_vs_device_resident": rel_dev}


def clone_cache(cache):
    return type(cache)(*(None if t is None else t.clone() for t in cache))


def phase_checkpoints(params, prompts):
    """10e: 8 steps, save, load onto the card, 8 more, against 16 steps
    without a stop, for five caches."""
    cfg, L = LLAMA3_8B, LLAMA3_8B.num_hidden_layers
    base = SNAPKV.layer_capacity(L, 4096)
    kinds = (("dense", SNAPKV, None, base + 2 * CKPT_STEPS + 1),
             ("int8", SNAPKV, QuantConfig(nbits=8), base + 2 * CKPT_STEPS + 1),
             ("nbits2_ring128", SNAPKV, GROUPED_RUNS[0][1], base + 2 * CKPT_STEPS + 1),
             ("evicting", EVICT, None, base + EVICT_HEADROOM),
             ("think_packed", THINK_PACKED, None, base + 2 * CKPT_STEPS + 1))
    toks = torch.zeros((2, 4096), dtype=torch.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    toks = toks.cuda()
    tl = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    out = {}
    for label, comp, quant, cap in kinds:
        with torch.no_grad():
            pre = llama.prefill(params, cfg, comp, toks, tl, cap, quant=quant)
            first = pre.logits_last.argmax(-1)

            def run(c, cur, n):
                got = []
                for _ in range(n):
                    lg, c = llama.decode_step(params, cfg, cur, c, quant=quant,
                                              eviction_recent=comp.eviction_recent)
                    cur = lg.argmax(-1)
                    got.append((cur, lg))
                return c, cur, got

            reset_counts()
            _, _, ref = run(clone_cache(pre.cache), first, 2 * CKPT_STEPS)
            sync()
            launches = path_launches()
            c, cur, part = run(pre.cache, first, CKPT_STEPS)
            del pre
            path = CKPT_DIR / label
            sync()
            t0 = time.perf_counter()
            save_generation_state(str(path), c, cur, torch.stack([t for t, _ in part], 1).cpu(),
                                  {"phase": "10e", "cache": label})
            save_s = time.perf_counter() - t0
            nbytes = sum(f.stat().st_size for f in path.iterdir())
            del c
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            c, cur, gen, meta = load_generation_state(str(path), device="cuda")
            sync()
            load_s = time.perf_counter() - t0
            shutil.rmtree(path)
            _, _, rest = run(c, cur, CKPT_STEPS)
            got = part + rest
            same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                       for a, b in zip(got, ref))
        log(f"  10e {label}: {type(c).__name__}, {nbytes / 1e9:.3f} GB on disk, save {save_s:.2f} "
            f"s, load {load_s:.2f} s; {2 * CKPT_STEPS} steps with the stop bitwise equal to "
            f"16 without: {same}; launches in the 16 uninterrupted steps {launches}")
        if not same or meta != {"phase": "10e", "cache": label} or gen.shape != (2, CKPT_STEPS):
            raise SystemExit(f"the {label} checkpoint did not continue bit for bit")
        out[label] = {"file_bytes": nbytes, "save_s": save_s, "load_s": load_s,
                      "launches_16_steps": launches}
        del c, ref, got
        torch.cuda.empty_cache()
    return out


def phase_llama3_serving(params, prompts, refs):
    """10f: one ``ContinuousBatchingEngine`` drain over the nbits-2 grouped
    cache: phase 5's two requests and two of 1000 tokens, 2 slots."""
    cfg, L = LLAMA3_8B, LLAMA3_8B.num_hidden_layers
    quant, new = GROUPED_RUNS[0][1], 8
    rng = np.random.default_rng(3)
    reqs = prompts + [rng.integers(0, cfg.vocab_size, size=1000).tolist() for _ in range(2)]
    engine = ContinuousBatchingEngine(params, EngineConfig(model=cfg, compression=SNAPKV,
                                                           quant=quant, prefill_buckets=(4096,)),
                                      n_slots=2, max_new_cap=new, instrument=True)
    rids = [engine.submit(p, new) for p in reqs]
    reset_counts()
    t0 = time.perf_counter()
    outs = engine.run()
    sync()
    wall = time.perf_counter() - t0
    launches = path_launches()
    log(f"== 10f serving drain over {quant}: 4 requests (4096, 1500, 1000, 1000 tokens), 2 "
        f"slots, {new} new each: {wall:.3f} s")
    expect_launches(launches, "drain", None, prefills=len(reqs))
    c = engine.cache
    lens = [sorted(set(c.lengths[:, s].flatten().tolist())) for s in range(2)]
    log(f"  pool {type(c).__name__}, capacity {c.capacity}; slot lengths {lens} (expect "
        f"[[{1000 + new - 1}]] twice: the last two requests)")
    if not isinstance(c, quant_cache.QuantizedKVCache) or lens != [[1000 + new - 1]] * 2 or \
            any(len(outs[r]) != new for r in rids):
        raise SystemExit("the drain left the wrong pool, lengths or token counts")
    worst = 0.0
    for r, p in zip(rids, reqs):
        ref = llama3_ref(params, p, len(p) - 1, refs)
        worst = max(worst, rel_l2(engine.logits[r][0][None].cuda(), ref)[0])
    log(f"  first-token logits against the fp32 reference: worst rel L2 {worst:.4f} (tol "
        f"{E2E_REL_L2_TOL})")
    if worst > E2E_REL_L2_TOL:
        raise SystemExit("the drain's first tokens disagree with the fp32 reference")
    out = {"launches": launches, "drain_s": wall, "first_token_rel_l2": worst,
           "admission_stalls_s": engine.admission_stalls_s, "steps": engine.steps_executed}
    del engine, c
    torch.cuda.empty_cache()
    return out


def aux_cache_calls(dev):
    """A fixed sequence of SSM and encoder-decoder cache calls on ``dev``;
    returns every resulting tensor on the CPU."""
    g = torch.Generator().manual_seed(5)
    rnd = lambda *s: torch.randn(s, generator=g).to(dev)  # noqa: E731
    L, B, I, K, St = 4, 3, 64, 4, 16
    c = ssm_cache.init_ssm_cache(L, B, I, K, St, dtype=torch.float32, device=dev)
    for _ in range(6):
        for li in range(L):
            ssm_cache.update_conv(c, li, rnd(B, I))
            ssm_cache.update_ssm(c, li, rnd(B, I, St))
        ssm_cache.advance(c)
    H, C, D = 2, 16, 32
    mk = lambda lens: KVCache(rnd(L, B, H, C, D), rnd(L, B, H, C, D), lens.to(dev),  # noqa: E731
                              torch.arange(B, dtype=torch.int32).to(dev))
    e = encdec_cache.build_encoder_decoder_cache(
        mk(torch.full((L, B, H), 3, dtype=torch.int32)),
        mk(torch.tensor([4, 0, 4, 0], dtype=torch.int32)[:, None, None].expand(L, B, H)))
    e = encdec_cache.mark_cross_written(e, 1)
    sel = encdec_cache.select_cross(e, 1, rnd(B, H, 8, D), rnd(B, H, 8, D))
    picked = encdec_cache.batch_select(e, torch.tensor([2, 0, 2]).to(dev))
    return [t.cpu() for t in (*c, e.cross_written, *sel, *picked.self_cache,
                              *picked.cross_cache)]


def phase_llama3(rng, log_file):
    """Phase 10: every cache kind of the slice at Meta-Llama-3-8B-Instruct
    widths, random bf16 weights (seed 2), phase 5's two requests."""
    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    params = init_params(cfg, seed=2, device="cuda")
    sync()
    log(f"== 10 Meta-Llama-3-8B-Instruct widths (32 layers, 32 / 8 heads, vocab 128256, "
        f"rope_theta 5e5), random bf16 weights (seed 2) in {time.perf_counter() - t0:.1f} s")
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (4096, 1500)]
    refs = {}
    out = {"model": "Meta-Llama-3-8B-Instruct widths, random weights (seed 2)",
           "requests": "B=2: 4096 and 1500 prompt tokens, bucket 4096",
           "compression": "snapkv 2048/8/7 maxpool, group_reduce none"}
    t_phase = time.perf_counter()
    out["grouped"] = phase_grouped(params, prompts, refs, log_file)
    out["think_packed"] = phase_think_packed(params, prompts, log_file)
    out["evict"] = phase_evict(params, prompts, refs)
    out["offload"] = phase_offload(params, prompts, refs)
    out["checkpoints"] = phase_checkpoints(params, prompts)
    out["serving"] = phase_llama3_serving(params, prompts, refs)
    cpu, card = aux_cache_calls("cpu"), aux_cache_calls("cuda")
    same = len(cpu) == len(card) and all(torch.equal(a, b) for a, b in zip(cpu, card))
    log(f"== 10g SSM and encoder-decoder caches: {len(card)} tensors on the card bitwise equal "
        f"to the CPU's: {same}")
    if not same:
        raise SystemExit("the SSM or encoder-decoder cache differs on the card")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 10: {out['phase_s']:.1f} s after the weights")
    del params, refs
    torch.cuda.empty_cache()
    return out


# K3's and K4's kernels in csrc/decode_attn_quant.cu, by a part of their names.
QUANT_KERNELS = {"K3": "quant8_decode_kernel", "K4": "quant4_decode_kernel"}


def ptxas_entries(report, name):
    """(function, registers, spill line) of each kernel in an ``nvcc -Xptxas
    -v`` report whose mangled name holds ``name``."""
    found, fn, spill = [], None, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn, spill = m.group(1), None
        elif fn is not None and "spill" in line:
            spill = line.strip()
        elif fn is not None and (m := re.search(r"Used (\d+) registers", line)):
            if name in fn:
                found.append((fn, int(m.group(1)), spill))
            fn = None
    return found


def sass_i2f(lib, name):
    """Int-to-float conversions (I2F, I2FP) in each function of ``lib`` whose
    name holds ``name``, from ``cuobjdump -sass``, as (conversions, integer
    divisions): an ``I2F.*.RP`` is the reciprocal step of an integer
    division by a value known only at run time (the split rule), not a
    conversion of data.  None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1) if name in m.group(1) else None
            if fn:
                counts[fn] = [0, 0]
        elif fn and (m := re.search(r"\*/\s+(?:@!?U?P\w+\s+)?(I2F\S*)", line)):
            counts[fn][m.group(1).endswith(".RP")] += 1
    return {fn: tuple(c) for fn, c in counts.items()}


# Idle time on each side of a profiled window's edges, and the profiles
# taken before an incomplete device trace fails the run (profile_device).
PROFILE_MARGIN_S = 0.1
PROFILE_ATTEMPTS = 3


def profile_device(fn, reps, wall_ms, what, log_file, check=None):
    """Device time per call of ``fn`` from ``torch.profiler`` (device-side
    kernel and copy events only), printed with the top kernels beside the
    unprofiled wall time ``wall_ms``; None when the profiler sees no device
    time.  ``check``, if given, gets the rows (ms, launches per call, kernel
    name) of every device kernel.  One warm-up call runs under the profiler
    first and is not counted.  The device's timestamps can sit off the host
    clock that bounds the recorded window, so kernels near its edges fall
    out (a decode profile lost its first two layers' kernels): the card
    idles ``PROFILE_MARGIN_S`` on each side of every edge.  Every call of
    ``fn`` launches the same kernels, so a kernel counted a number of times
    that ``reps`` does not divide marks an incomplete trace: it is taken
    again, up to ``PROFILE_ATTEMPTS`` times, before the run fails."""
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=reps, repeat=1)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA],
                                    schedule=schedule) as prof:
            for i in range(reps + 1):
                fn()
                sync()
                if i in (0, reps):
                    time.sleep(PROFILE_MARGIN_S)
                prof.step()
                if i == 0:
                    time.sleep(PROFILE_MARGIN_S)
        # The schedule's ProfilerStep* spans show on the device too: not kernels.
        events = [evt for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA
                  and not evt.key.startswith("ProfilerStep")]
        partial = [(evt.count, evt.key[:60]) for evt in events if evt.count % reps]
        if not partial:
            break
        log(f"profile ({what}), attempt {attempt}: incomplete device trace, counts over "
            f"{reps} calls {partial[:4]}")
    else:
        raise SystemExit(f"profile ({what}): the device trace was incomplete "
                         f"{PROFILE_ATTEMPTS} times")
    rows = sorted(((evt.self_device_time_total / reps / 1e3, evt.count / reps, evt.key)
                   for evt in events), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        log(f"profile ({what}): the profiler reported no device time (not measured)")
        return None
    log(f"profile ({what}): device busy {busy_ms:.3f} ms against {wall_ms:.3f} ms "
        f"unprofiled: idle share {1 - busy_ms / wall_ms:.3f}")
    for ms, n, key in rows[:8]:
        log(f"  {ms:8.4f} ms  {ms / busy_ms:6.1%}  {n:6.1f} launches  {key[:80]}")
    if check is not None:
        check(rows)
    log_file.write(f"== {what}: {reps} call(s) profiled\n")
    log_file.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    return busy_ms


T_START = time.perf_counter()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; name and power limit from nvidia-smi:")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN: fp32 products run in full fp32")

    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(key in line for key in ("registers", "spill", "Compiling entry",
                                           "Performance Loss")):
                log(f"  {name}: {line.strip()}")
    # K2's ptxas lines: each instantiation (G 1-8) must spill nothing.
    k2_spills = [line for line in reports.get("decode_attn", "").splitlines() if "spill" in line]
    if any("0 bytes spill stores, 0 bytes spill loads" not in line for line in k2_spills):
        raise SystemExit("K2 spills registers (ptxas lines above)")
    log(f"K2 ptxas: {len(k2_spills)} entries, 0 spill bytes" if k2_spills else
        "K2 ptxas: library cached, no ptxas report in this run")
    # K3's and K4's ptxas lines (G 1-8 each): no spill; and no int-to-float
    # conversion in their SASS, where the toolkit has cuobjdump.
    for kid, name in QUANT_KERNELS.items():
        entries = ptxas_entries(reports.get("decode_attn_quant", ""), name)
        if any("0 bytes spill stores, 0 bytes spill loads" not in (line or "")
               for _, _, line in entries):
            raise SystemExit(f"{kid} spills registers (ptxas lines above)")
        log(f"{kid} ptxas: {len(entries)} entries, registers "
            f"{sorted(regs for _, regs, _ in entries)}, 0 spill bytes" if entries else
            f"{kid} ptxas: library cached, no ptxas report in this run")
        i2f = sass_i2f(_build._lib_path("decode_attn_quant"), name)
        log(f"{kid} SASS: no cuobjdump in this toolkit (not measured)" if i2f is None else
            f"{kid} SASS (cuobjdump -sass), per instantiation: I2F/I2FP conversions "
            f"{sorted(c for c, _ in i2f.values())}, integer-division reciprocals (I2F.*.RP) "
            f"{sorted(r for _, r in i2f.values())}")
        if i2f is not None and (not i2f or any(c for c, _ in i2f.values())):
            raise SystemExit(f"{kid}'s SASS holds int-to-float conversions (or no {kid} kernel)")

    rng = np.random.default_rng(0)
    k1 = phase_k1(rng)
    k1_sw, k1_chunk = phase_k1_variants(rng)
    k1_a, k1_vs, k1["minference"] = phase_k1_sparse(rng)
    k5 = phase_k5(rng)
    k1_ml = phase_k1ml(rng)
    sp_fold = phase_sp_fold(rng)
    k2 = phase_k2(rng)
    k3 = phase_kq(rng, 8)
    k4 = phase_kq(rng, 4)
    phase_edges(rng)
    LOG_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(LOG_PATH, "w") as log_file:
        params, prompts, e2e = phase_e2e(rng, log_file)
        policies = phase_policies(rng, params, prompts, log_file)
        serving = phase_serving(rng, params, log_file)
        torch.cuda.empty_cache()
        minf = phase_minference(rng, params, log_file)
        sp = phase_sp(rng, params)
        del params
        torch.cuda.empty_cache()
        qwen = phase_qwen2(rng, log_file)
        llama3 = phase_llama3(rng, log_file)
    # Each kernel's launches on the path that runs it: K1 and K2 on the bf16
    # path, K3 on the int8 path, K4 on the int4 path, K1-SW on the one-shot
    # drain, K1-chunk on the chunked drain (K2's count on each drain and each
    # MInference run is in the end-to-end line).
    for k, label, kid in ((k1, "bf16", "K1"), (k2, "bf16", "K2"), (k3, "int8", "K3"),
                          (k4, "int4", "K4")):
        k["launches"] = e2e[label]["launches"][kid]
    k1_sw["launches"] = serving["one_shot"]["launches"]["K1-SW"]
    k1_chunk["launches"] = serving["chunked"]["launches"]["K1-chunk"]
    # K1-A and K1-VS on their MInference runs; K5 on the probe (phase 3d).
    k1_a["launches"] = minf["ashape"]["launches"]["K1-A"]
    k1_vs["launches"] = minf["vertical_slash"]["launches"]["K1-VS"]
    # K1-ml on the sp run: every rank's hops (32 on rank 0, 64 on rank 1).
    k1_ml["launches"] = sum(rk["launches"]["K1-ml"] for rk in sp["ranks"])
    # Phase 9 at Qwen2-7B widths (G = 7): K1 on the W8A16 path's prefill,
    # K2 and K3 on its fullkv runs (the snapkv runs keep a cache per query
    # head, G = 1); each beside the kernel's direct check and time at G = 7.
    runs = qwen["runs"]
    k1["qwen2"] = {"launches": runs["w8a16_bf16"]["launches"]["K1"], "g7": qwen["g7"]["K1"]}
    k2["qwen2"] = {"launches": runs["w8a16_fullkv_bf16"]["launches"]["K2"],
                   "launches_snapkv_g1": runs["w8a16_bf16"]["launches"]["K2"],
                   "g7": qwen["g7"]["K2"]}
    k3["qwen2"] = {"launches": runs["w8a16_fullkv_int8"]["launches"]["K3"],
                   "launches_snapkv_g1": runs["w8a16_int8"]["launches"]["K3"],
                   "g7": qwen["g7"]["K3"]}
    # Phase 10 at Meta-Llama-3-8B widths (G = 1 caches): K1 on every
    # prefill, K2 on the bf16 baseline and in-place ThinK runs and the dense
    # checkpoint, K3 on the int8 checkpoint; the new caches' decode runs
    # none of K2-K4.
    ll = llama3
    k1["llama3"] = {"launches_per_prefill": ll["grouped"]["bf16"]["launches"]["K1"],
                    "launches_serving_drain": ll["serving"]["launches"]["K1"]}
    k2["llama3"] = {"launches_bf16": ll["grouped"]["bf16"]["launches"]["K2"],
                    "launches_think_in_place": ll["think_packed"]["launches_in_place"]["K2"],
                    "launches_dense_checkpoint": ll["checkpoints"]["dense"]["launches_16_steps"]["K2"]}
    k3["llama3"] = {"launches_int8_checkpoint":
                    ll["checkpoints"]["int8"]["launches_16_steps"]["K3"]}
    print(json.dumps({"kernels": [k1, k1_sw, k1_chunk, k1_a, k1_vs, k1_ml, k2, k3, k4, k5]}))
    print(json.dumps({"e2e": e2e["bf16"], "e2e_int8": e2e["int8"], "e2e_int4": e2e["int4"],
                      "policies": policies, "serving": serving, "minference": minf,
                      "sp": {**sp, "fold_emulated": sp_fold}, "qwen2": qwen, "llama3": llama3,
                      "script_s": time.perf_counter() - T_START, "card": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
