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
   then K1-K4 at head_dim 64 and 256 (K3 / K4 at 256; their own generator):
   K1 at B 2, S 4096, window 8 with Llama-3.2-1B's heads at 64 and 16 / 4
   heads at 256, its CTA edges, two launches bitwise equal, timed beside
   its plain version, SDPA and its bound; at 64 a sliding-window case, a
   chunk pool and a ring hop (K1-ml), at 256 two a-shape cases (3e); K2 at
   G 1 and G 4 with its off-by-one, dropped-split, repeat and graph-replay
   checks and split edges (4c); K3 and K4 the same with their range case
   (4d); every instantiation's ptxas registers and spills; then K1 at
   observation windows 65, 96 and 128 (3f: its CTA edges, a true_len
   shorter than the window, what a pass cut at 64 window rows would show,
   the score pass timed beside the main pass); K1's window-score pass
   (``csrc/window_scores.cuh``, 3j): its ptxas lines in every K1 library,
   windows of 1, 32 and 200 rows, G 12 and 16 at W 128, true_len 1, a
   window across a 64-key tile, true_len below the window and an a-shape
   mask, each on every column below true_len; what a pass that drops the
   last window row or pairs each query head with the next KV head would
   show; two launches bitwise equal at D 128 / W 128, D 100 / W 8 and
   D 1024 / W 128; the pass timed alone at D 128 and W 8, 32, 128 and at
   D 1024 and 514 with W 128, beside its plain version, the composite
   matmul + exp + sum and its bound; and K2-K4 at G 9, 12 and 16
   (4e: Mistral-Large-2's and Llama-3.1-405B's 8 KV heads, with K2's
   checks, K3 / K4's range case and appends, times and ptxas lines);
5. the main path end to end at Mistral-7B-Instruct-v0.2 widths (16 of its
   32 layers since phases 3h-4h and 20 joined the script) with random
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
   against the fp32 reference forward, K2 (K4) called directly on the first
   and last layer of the finished adakv and pyramidkv caches against the plain
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
   and a SnapKV prefill on the two bitwise equal; (9b) at 2 of the 28 layers,
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
   128256, rope_theta 5e5; 4 of its 32 layers, for the script's time),
   random bf16 weights, phase 5's two requests,
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
11. Mixtral-8x7B-Instruct-v0.1 widths (sparse MoE, 8 experts, top-2): (11a)
   a one-layer checkpoint in the HF layout (``block_sparse_moe`` router and
   experts) read back by ``load_params``, every leaf bitwise equal to the
   tensors fused by hand, the native reader serving; (11b) the model at 8
   of its 32 layers with random W8A16 weights built layer by layer, phase 5's two
   requests through ``InferenceEngine`` (SnapKV, 32 new): launches, lengths,
   the routing of request (b) against the fp32 reference (flips only at
   near-ties), its logits against the reference with the card's routing
   replayed, the decode gather and the prefill dispatch against the dense
   all-expert form, no host read a decode step, prefill and decode times,
   a profiled decode step beside its bound; (11c) ``ContinuousBatchingEngine``
   with a 2048-token prefix registered (``cache_prefix``): six requests
   drained cold and with the prefix, each resumed request's first token
   from both drains against the fp32 reference with that drain's own
   routing replayed (the cold-vs-resumed distance printed), snapshot bytes
   within the budget; then h2o, headkv, cam and
   random through chunked admission against the one-shot engine, each run
   with every launch count set to 0 just before it;
12. (run right after phase 8, on phase 5's requests and widths at 16 of
   its 32 layers, ``GRID_MODEL``) the
   ``(dp, sp, tp)`` layouts on ranks that share this card over gloo, each
   CUDA tensor staged through pinned host memory: the single-device
   references and the fp32 reference forward first, phase 5's weights
   then freed; each rank draws the weights (seed 0) in turn and keeps its
   tp=2 shard.  (12a) two ranks: ``ShardingConfig(tp=2)`` over the bf16,
   int8 and int4 caches (K1 with K2, K3, K4 on each rank's 16 heads),
   ``dp=2`` over the bf16 cache, ``tp=2`` with fullkv (K2 at G 4 on 4 KV
   heads); (12b) four ranks: ``(dp, tp) = (2, 2)``, ``(sp, tp) = (2, 2)``
   on one 8192-token request (K1-ml in the ring, K2 in decode) and a
   ``ContinuousBatchingEngine`` drain at ``(2, 2)`` of four 4096-token
   requests with chunked admission (K1-chunk).  Each run with every launch
   and collective count set to 0 just before it: launches per rank, each
   rank's cache lengths and head count, the ranks' ids and first-token
   logits equal, logits against the single-device engine and the fp32
   reference within phase 5's limits, streams equal up to a near-tie, K2
   (K3, K4) on the first and last layer of each rank's cache against the plain
   version with every rank on the card at once; prefill wall, decode
   ms/step wall and busy (rank 0, profiled), collectives and bytes and
   seconds staged per prefill and per step; K2 at one tp=2 rank's shape
   timed beside its bound; 12a also runs ``ShardingConfig(dp=2,
   dcn_dp=2)`` (bitwise the dp=2 run: one host) and h2o, adakv and cam at
   sp=2 on the 8192-token request (16 new), each against the single
   device's run of its method, the fp32 reference and its length rule;
13. (right after phase 12) pipeline parallelism: phase 5's requests
   through ``InferenceEngine(ShardingConfig(pp=2, pp_microbatches=2))`` on
   two stages sharing this card (gloo, hidden states and tokens staged
   through pinned host memory), each drawing the weights in turn and
   keeping its 16 layers: K1 16 a microbatch and K2 16 a tick on each
   stage, the slab's lengths, stages equal, first-token logits against the
   fp32 reference and the single device, streams up to a near-tie, K2 on
   the first and last layer of each slab against its plain version;
   prefill and decode wall and busy, bytes and seconds staged;
14. (after phase 11, which keeps every (layer, expert)'s checksums and
   11b's run) expert parallelism: two ranks sharing this card, each
   rebuilding only its 4 experts a layer from phase 11's generator
   (checksums bitwise phase 11's), phase 11b's requests through
   ``InferenceEngine(ShardingConfig(ep=2))``: K1 32 and K2 992 a rank,
   lengths, ranks equal (routing too), request (b) against the fp32
   reference with the run's routing replayed (its MoE block summed over
   the ranks), flips only at near-ties, the distance from 11b's run, the
   decode step's wall and busy time beside 11b's;
16. Llama-3.2-1B-Instruct at full width (4 of its 16 layers, head_dim 64,
   G 4, llama3 rope scaling, tied embeddings; random bf16 weights), phase
   5's requests through ``InferenceEngine`` with snapkv (K1 8 a prefill,
   K2 252 at G 1) and fullkv (K2 at G 4), each checked as phase 5's paths
   (launches, lengths, logits against the fp32 reference, K2 directly on
   layers 0 and 3, times and a profiled decode step), then a
   ``ContinuousBatchingEngine`` drain of four 4096-token requests with
   chunked admission (K1-chunk at 64); 16b: a 2-layer head_dim 256 model
   over the bf16, int8 and int4 caches (K1-K4 at 256), checked the same;
17. Mistral-Large-Instruct-2407 at full width (2 of 88 layers, G 12;
   random bf16 weights): phase 5's requests through ``InferenceEngine``
   with fullkv over the bf16, int8 and int4 caches (K2 / K3 / K4 at G 12),
   snapkv with the mean group reduction and snapkv with a 128-row window
   (K1 at W 128), each checked as phase 16's runs; 18: one run on those
   weights under ``utils.trace`` with ``annotate`` and a ``PhaseTimer``
   (every K1 and K2 launch in the trace, inside its annotation),
   ``utils.infer_attention`` against the CPU, and
   ``examples/serving_torch.py`` with a one-chunk system prompt (prefix
   resumes); 17b: Llama-3.1-405B-Instruct at full width (1 of 126 layers,
   G 16) with fullkv over the three caches (K2 / K3 / K4 at G 16);
19. (3g-4g, after phase 4e, on a generator of their own) K1 and K2
   at every head_dim of ``NEW_HEAD_DIMS`` (16 ... 512, each on the
   narrowest instantiation at least as wide, with its own 1/sqrt(D)) and
   K3 / K4 at 384 and 512, against their plain versions on inputs whose
   buffers end in NaN (K1 dense with scores, the CTA's edges and, at 80,
   384 and 512, its sliding-window, chunk, a-shape, vertical-slash and
   ring-hop variants; K2 at G 1, 4 and 12 and the edge shapes; K3 / K4 at
   G 1, 4 and 12, the range case and the edge shapes, appends byte for
   byte), with what a skipped tile, an off-by-one key range, a dropped
   split and the instantiation's 1/sqrt(width) in place of 1/sqrt(D) would
   show, each beside its plain version, its library yardstick and its
   bound; then h2o-danube2-1.8b at full width (8 of its 24 layers,
   head_dim 80, G 4; random bf16 weights) through ``InferenceEngine`` with
   snapkv and fullkv (K1 8 a prefill, K2 8 x 63 a run) and a chunked
   drain (K1-chunk at 80), checked as phase 16; 19b: two 2-layer models at
   head_dim 384 and 512 over the bf16, int8 and int4 caches (K1-K4 at 384
   and 512, the quantized caches per token);
20. (3h-4h, after phase 4g, on a generator of their own) K1 and K2 at
   every head_dim of ``RAGGED_HEAD_DIMS`` (20 ... 510: no multiple of 8,
   the libraries that copy rows in 8- or 4-byte pieces, every
   instantiation) against their plain versions on inputs whose buffers end
   in NaN (K1 dense with scores, the CTA's edges and, at 100, its
   variants; K2 at G 1, 4 and 12, the edge shapes, the append byte for
   byte), with what a skipped tile (a dropped split, an off-by-one key
   range), 1/sqrt(width), a row's tail piece dropped and a row read at the
   instantiation's width would show; then, last, OpenLLaMA-3B v2 at full
   width and depth (26 layers, head_dim 100, MHA; random bf16 weights),
   two requests of 1984 and 1500 tokens through ``InferenceEngine`` with
   snapkv at 1024 and fullkv (K1 26 a prefill, K2 26 x 63 a run) and a
   chunked drain (K1-chunk at 100), checked as phase 16;
21. summary lines: one ``{"kernels": [...]}`` object, one end-to-end object,
   and last ``{"ok": true, "device": {...}}``.

Imports only torch, numpy and the port.  The full profiler tables go to
``build/chip_smoke.log`` (git-ignored) beside this script.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import datetime
import functools
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
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
from kvcache_factory_tpu_torch.parallel import pipeline
from kvcache_factory_tpu_torch.parallel.mesh import shard_tree
from kvcache_factory_tpu_torch.parallel.ring_attention import hop_visible, ring_attention_emulated
from kvcache_factory_tpu_torch.policies import cam
from kvcache_factory_tpu_torch.policies.base import select_and_pack
from kvcache_factory_tpu_torch.policies.minference import default_pattern
from kvcache_factory_tpu_torch.runtime import batching, generate, native
from kvcache_factory_tpu_torch.runtime.batching import ContinuousBatchingEngine
from kvcache_factory_tpu_torch.runtime.checkpoint import (load_generation_state,
                                                          save_generation_state)
from kvcache_factory_tpu_torch.runtime.engine import InferenceEngine
from kvcache_factory_tpu_torch.utils import PhaseTimer, annotate, infer_attention, trace

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
# Phases 5, 5b, 6, 7 and 8c run Mistral-7B at 16 of its 32 layers (the first
# 16 of the seed-0 draw, ``first_layers``; 8c's ranks cut their own draw the
# same way) since phases 3h-4h and 20 joined the script, for its time limit:
# their checks count launches per layer and hold logits to the fp32
# reference at any depth.
SHARED_LAYERS = 16
MISTRAL_7B_16 = dataclasses.replace(MISTRAL_7B, num_hidden_layers=SHARED_LAYERS)
MISTRAL_7B_V01_16 = dataclasses.replace(MISTRAL_7B_V01, num_hidden_layers=SHARED_LAYERS)
MAIN_MODEL = "Mistral-7B-Instruct-v0.2 widths (16 of 32 layers), random weights (seed 0)"
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


def first_layers(params, n):
    """``params`` with only its first ``n`` layers (views, no copy)."""
    return {**params, "layers": {k: v[:n] for k, v in params["layers"].items()}}


class DeviceDraws:
    """A numpy generator whose bf16 normal tensors (``bf16_normal``) are
    drawn on the card by a CUDA ``torch.Generator`` of the same seed; every
    other draw (lengths, offsets, prompts) is the numpy generator's own.
    numpy's draws take about 20 ns an element on the H100 machine's host
    CPU, minutes over the wide head_dims' caches; the card's draws take
    almost none of the script's time."""

    def __init__(self, seed):
        self.numpy = np.random.default_rng(seed)
        self.torch = torch.Generator(device="cuda")
        self.torch.manual_seed(seed)

    def __getattr__(self, name):
        return getattr(self.numpy, name)


def bf16_normal(rng, shape):
    if isinstance(rng, DeviceDraws):
        return torch.randn(shape, generator=rng.torch, device="cuda", dtype=torch.bfloat16)
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to("cuda", torch.bfloat16)


NAN_TAIL = 4096  # elements after an input's last row that nan_tailed fills


def nan_tailed(x):
    """``x`` copied to the front of a buffer whose ``NAN_TAIL`` elements
    after its last row are NaN (0xFF bytes for an integer type), so that a
    kernel that reads past the end shows it."""
    buf = torch.empty(x.numel() + NAN_TAIL, dtype=x.dtype, device=x.device)
    buf[x.numel():] = float("nan") if x.dtype.is_floating_point else 255
    buf[:x.numel()] = x.reshape(-1)
    return buf[:x.numel()].view(x.shape)


def k1_case(rng, B, Hq, Hkv, S, W, tls, D=128, tail=False, pattern=None):
    """K1 against its plain version on random inputs: ``out`` over each
    example's valid rows, ``scores`` over every column below its true_len
    (the scored ones and the window's own) and zero past it; with ``tail``
    the inputs lie in ``nan_tailed`` buffers, with ``pattern`` K1 runs that
    sparse pattern in 64-row blocks."""
    q, k, v = (bf16_normal(rng, (B, h, S, D)) for h in (Hq, Hkv, Hkv))
    if tail:
        q, k, v = (nan_tailed(x) for x in (q, k, v))
    tl = torch.tensor(tls, dtype=torch.int32, device="cuda")
    mask, block = (None, 0) if pattern is None else \
        flash_prefill.sparse_block_mask(q, k, tl, pattern, None, 64)
    out, sc = flash_prefill.flash_prefill_attention(
        q, k, v, tl, W, sparse_pattern=pattern, q_block=64 if pattern else None)
    sync()
    out_ref, sc_ref = flash_prefill.flash_prefill_attention_reference(
        q, k, v, tl, W, block_mask=mask, block=block)
    sync()
    err_out = abs_out = err_sc = past = 0.0
    for b, t in enumerate(tls):
        e, a = rel_l2(out[b, :, :t], out_ref[b, :, :t])
        err_out, abs_out = max(err_out, e), max(abs_out, a)
        err_sc = max(err_sc, (sc[b, :, :t] - sc_ref[b, :, :t]).abs().max().item())
        if t < S:
            past = max(past, sc[b, :, t:].abs().max().item())
    finite = all(torch.isfinite(x.float()).all() for x in (out, sc))
    log(f"K1 B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} w={W} true_len={tls}"
        f"{f' {pattern}' if pattern else ''}: out worst row rel L2 {err_out:.3e} (max abs "
        f"{abs_out:.3e}) tol {K1_OUT_TOL}; scores max abs err {err_sc:.3e} tol {K1_SCORE_TOL}, "
        f"{past} past true_len; finite {finite}")
    if err_out > K1_OUT_TOL or err_sc > K1_SCORE_TOL or past != 0 or not finite:
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


def k1_pass_ms(call, reps=5, names=("flash_fwd_kernel", flash_prefill.SCORE_KERNEL)):
    """Device time per launch of K1's two kernels, the main pass and the
    window-score pass (their kernel ``names``), from profiler rows; None
    where the profiler saw no device time (``score_pass_ms`` exits on that).  Each row's time is divided by
    the launches the trace holds, not by ``reps``: a trace can miss launches
    at its edges."""
    call()
    sync()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        profile_burst()  # takes the profiler's loss of a session's first records
        for _ in range(reps):
            call()
        sync()
    times = dict.fromkeys(names)
    for evt in prof.key_averages():
        for name in times:
            if evt.device_type == DeviceType.CUDA and name in evt.key and evt.count:
                times[name] = evt.self_device_time_total / evt.count / 1e3
                if evt.count != reps:
                    log(f"K1 profile: {evt.count} of {reps} {name} launches in the trace")
    return times


def score_pass_ms(passes):
    """The window-score pass's time in ``passes`` (``k1_pass_ms``); exits
    when the profile holds no row of it, so that a renamed kernel cannot
    blank the record."""
    ms = passes.get(flash_prefill.SCORE_KERNEL)
    if ms is None:
        raise SystemExit(f"K1's profile holds no {flash_prefill.SCORE_KERNEL} row")
    return ms


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
        f"{score_pass_ms(passes):.4f} ms (profiled); {t['bound_ms'] / ms:.3f} of the bound")
    return {"name": "flash_prefill", "route": "cuda",
            "source": flash_prefill.SOURCE, "replaces": flash_prefill.REPLACES,
            "shape": f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} w={W} true_len={tls}",
            "max_abs_err": abs_out, "rel_l2": err_out, "tol": K1_OUT_TOL,
            "skipped_tile_rel_l2": skip_err,
            "scores_max_abs_err": err_sc, "scores_tol": K1_SCORE_TOL,
            **t, "bound_fraction": t["bound_ms"] / ms, "main_pass_ms": passes["flash_fwd_kernel"],
            "score_pass_ms": score_pass_ms(passes), "deterministic": same,
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


def k1v_case(rng, B, Hq, Hkv, S_q, S_k, tls, sw, offsets, D=128, tail=False):
    """K1 with a sliding window and/or a row offset against its plain
    version on random inputs: ``out`` over each example's valid rows (global
    id < true_len); every row, inert ones (true_len 0) included, finite.
    With ``tail`` the inputs lie in ``nan_tailed`` buffers."""
    q = bf16_normal(rng, (B, Hq, S_q, D))
    k, v = (bf16_normal(rng, (B, Hkv, S_k, D)) for _ in range(2))
    if tail:
        q, k, v = (nan_tailed(x) for x in (q, k, v))
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
        f"S_k={S_k} D={D} sw={sw} row_offset={offsets} true_len={tls}: out worst row rel L2 "
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


def masked_bound(mask, block, tls, nbytes, D):
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


def k1s_inputs(rng, B, Hq, Hkv, S, heavy=None, D=128):
    """bf16 q, k, v.  With ``heavy = (c0, c1)`` the estimated vertical-slash
    mask is sparse: q and k are halved (logit noise about 0.25), and every
    query favours the keys [c0, c1) by 1.5 in its logits through channel 0
    (4 in q, 4.24 in those keys, 0 in the others).  On random inputs the
    lognormal tail of the column sums puts a few of the top 1024 columns in
    every block, and the mask comes out dense."""
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
        f"Hkv={k.shape[1]} S={S} D={q.shape[-1]} block={block} w={window} sw={sw} budgets="
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


def k2_case(rng, H, G, C, lengths, lower, D=128, tail=False):
    """K2 against its plain version: ``out``, and the whole cache after the
    in-place append, which must be identical; with ``tail`` the kernel's
    inputs lie in ``nan_tailed`` buffers."""
    q, kc, vc, kn, vn = (bf16_normal(rng, s) for s in ((H, G, D), (H, C, D), (H, C, D),
                                                       (H, D), (H, D)))
    if tail:
        q, kn, vn = (nan_tailed(x) for x in (q, kn, vn))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    lo = torch.tensor(lower, dtype=torch.int32, device="cuda")
    copy = nan_tailed if tail else torch.clone
    k1, v1, k2, v2 = copy(kc), copy(vc), kc.clone(), vc.clone()
    out = decode_attn.decode_attention_append(q, k1, v1, lens, kn, vn, lo)
    ref = decode_attn.decode_attention_append_reference(q, k2, v2, lens, kn, vn, lo)
    sync()
    err, abs_err = rel_l2(out.reshape(H, -1), ref.reshape(H, -1))
    slot_ok = torch.equal(k1, k2) and torch.equal(v1, v2)
    log(f"K2 H={H} G={G} C={C} D={D}: out worst head rel L2 {err:.3e} (max abs {abs_err:.3e}) "
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
    n_split = k2_splits(H, C, D, G)
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


def k2_splits(H, C, D=128, G=1):
    """K2's n_split at H heads of G query rows, capacity C and head_dim D on
    this card (G above 8 runs a head's query blocks as CTAs of their own)."""
    return decode_attn.splits(H, G, C, D, decode_attn._sm_count(torch.device("cuda")))


def k2_split_edges(rng, D=128):
    """The edges of K2's split rule (CTA sp of n_split takes the sp-th part
    of its head's valid keys [lower, L)), each against the plain version:
    a range shorter than n_split, ``lower == L``, ``lengths == C``, a window
    ``lower`` mid-tile, all heads empty, one head at C-1 beside 63 empty
    ones; then G 3, 5, 6 and 7 (1, 2, 4 and 8 are in phase 4's other
    cases)."""
    C, H = 2113, 64
    n_split = k2_splits(H, C, D)
    lengths = rng.integers(1, C, size=H)
    lower = np.zeros(H, np.int64)
    lengths[0], lower[0] = 500, 500 - (n_split - 1)     # fewer keys than splits
    lengths[1], lower[1] = 700, 700                     # lower == L: no cache key
    lengths[2] = C                                      # full: overwrite slot C-1
    lengths[3], lower[3] = 2079, 1000 + 7               # a window edge mid-tile
    lengths[4], lower[4] = 2079, 2078                   # one key
    errs = [k2_case(rng, H, 1, C, lengths, lower, D)[8]]
    errs.append(k2_case(rng, H, 1, C, [0] * H, np.zeros(H, np.int64), D)[8])
    errs.append(k2_case(rng, H, 1, C, [C - 1] + [0] * (H - 1), np.zeros(H, np.int64), D)[8])
    # G 4 at 8 heads (33 splits a head at D 128): heads shorter than, equal
    # to and one past the split count.
    n8 = k2_splits(8, C, D)
    errs.append(k2_case(rng, 8, 4, C, [max(n8 - 13, 1), 0, n8 - 1, n8, n8 + 1, C, C - 1, 1000],
                        [0, 0, 0, 0, 1, 0, 0, 993], D)[8])
    groups = {}
    for G, Hg in ((3, 16), (5, 8), (6, 8), (7, 8)):
        lens = rng.integers(1, C, size=Hg)
        low = np.zeros(Hg, np.int64)
        low[0] = lens[0] // 3
        groups[G] = k2_case(rng, Hg, G, C, lens, low, D)[8]
    log(f"K2 split edges at D={D} (n_split {n_split} at H={H}): worst head rel L2 "
        f"{max(errs):.3e}; by G: {groups}")
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
    log(f"K2 H={H} G={q.shape[1]} D={D} timed: kernel {ms * 1e3:.2f} us (device, graph replay), wrapper "
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


def kq_inputs(rng, nbits, H, G, C, amp=(1.0, 1.0, 1.0), D=128):
    """bf16 q, k_new, v_new and a layer quantized from random bf16 K/V:
    codes [H, C, D or D/2] and scales [H, C, 4].  ``amp`` scales q, K and
    V (with k_new and v_new)."""
    q, k, v, kn, vn = ((bf16_normal(rng, s).float() * a).to(torch.bfloat16)
                       for s, a in (((H, G, D), amp[0]), ((H, C, D), amp[1]),
                                    ((H, C, D), amp[2]), ((H, D), amp[1]), ((H, D), amp[2])))
    kc, ks, kz = quant_cache.encode_per_token(k, nbits)
    vc, vs, vz = quant_cache.encode_per_token(v, nbits)
    return q, kc, vc, torch.stack([ks, kz, vs, vz], dim=-1).contiguous(), kn, vn


def kq_case(rng, nbits, H, G, C, lengths, lower, amp=(1.0, 1.0, 1.0), D=128, tail=False):
    """K3 or K4 against its plain version: ``out``, and the whole cache after
    the in-place quantized append, which must be identical byte for byte
    (both sides quantize the new token with the same IEEE operations); with
    ``tail`` the kernel's inputs lie in ``nan_tailed`` buffers."""
    kid, kernel, plain, _ = QUANT[nbits]
    q, kc, vc, sc, kn, vn = kq_inputs(rng, nbits, H, G, C, amp, D)
    if tail:
        q, kn, vn = (nan_tailed(x) for x in (q, kn, vn))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    lo = torch.tensor(lower, dtype=torch.int32, device="cuda")
    copy = nan_tailed if tail else torch.clone
    mine = [copy(kc), copy(vc), copy(sc)]
    theirs = [kc.clone(), vc.clone(), sc.clone()]
    out = kernel(q, *mine, lens, kn, vn, lo)
    ref = plain(q, *theirs, lens, kn, vn, lo)
    sync()
    err, abs_err = rel_l2(out.reshape(H, -1), ref.reshape(H, -1))
    apart = [int((a != b).sum().item()) for a, b in zip(mine, theirs)]
    log(f"{kid} H={H} G={G} C={C} D={D}: out worst head rel L2 {err:.3e} (max abs {abs_err:.3e}) "
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
    log(f"{QUANT[nbits][0]} H={H} G={G} D={D} timed: kernel {ms * 1e3:.2f} us (device, graph replay), "
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
    n_split = decode_attn_quant.splits(H, G, C, D, decode_attn._sm_count(q.device))
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


def kq_split_edges(rng, nbits, C, D=128):
    """The edges of K3's or K4's split rule and tiles, each against the plain
    version with the append byte for byte: a range shorter than n_split,
    ``lower == L``, ``lengths == C``, a window ``lower`` mid-tile, one key,
    all heads empty, one head at C-1 beside 63 empty ones, 8 heads of G 4
    around their split count; one split a head (H = 2 CTAs an SM x SMs) with
    ranges at the edges of a 16-key tile, a warp's stage and a CTA's stage;
    then G 3, 5, 6 and 7 (1, 2, 4 and 8 are in phase 4b's other cases)."""
    H, sm = 64, decode_attn._sm_count(torch.device("cuda"))
    n_split = decode_attn_quant.splits(H, 1, C, D, sm)
    lengths = rng.integers(1, C, size=H)
    lower = np.zeros(H, np.int64)
    lengths[0], lower[0] = 500, 500 - (n_split - 1)     # fewer keys than splits
    lengths[1], lower[1] = 700, 700                     # lower == L: no cache key
    lengths[2] = C                                      # full: overwrite slot C-1
    lengths[3], lower[3] = 2079, 1000 + 7               # a window edge mid-tile
    lengths[4], lower[4] = 2079, 2078                   # one key
    kw = dict(D=D)
    errs = [kq_case(rng, nbits, H, 1, C, lengths, lower, **kw)[8]]
    errs.append(kq_case(rng, nbits, H, 1, C, [0] * H, np.zeros(H, np.int64), **kw)[8])
    errs.append(kq_case(rng, nbits, H, 1, C, [C - 1] + [0] * (H - 1), np.zeros(H, np.int64),
                        **kw)[8])
    n8 = decode_attn_quant.splits(8, 4, C, D, sm)
    errs.append(kq_case(rng, nbits, 8, 4, C, [max(n8 - 13, 1), 0, n8 - 1, n8, n8 + 1, C, C - 1,
                                              1000],
                        [0, 0, 0, 0, 1, 0, 0, 993], **kw)[8])
    # One CTA a head and column slice: the whole range is one CTA's.
    ctas = decode_attn_quant.CTAS_PER_SM_AT[decode_attn.WIDE if D > 512 else D]
    Hs = ctas * sm // flash_prefill.slices(D)
    edges = [1, 15, 16, 17, 63, 64, 65, 255, 256, 257, 511, 512, 513, 767, 768, 769]
    lens = np.asarray((edges * (Hs // len(edges) + 1))[:Hs])
    low = np.zeros(Hs, np.int64)
    low[len(edges):2 * len(edges)] = 3                  # the same edges, shifted by a lower bound
    lens[len(edges):2 * len(edges)] += 3
    errs.append(kq_case(rng, nbits, Hs, 1, 1024, lens, low, **kw)[8])
    groups = {}
    for G, Hg in ((3, 16), (5, 8), (6, 8), (7, 8)):
        lens = rng.integers(1, C, size=Hg)
        low = np.zeros(Hg, np.int64)
        low[0] = lens[0] // 3
        groups[G] = kq_case(rng, nbits, Hg, G, C, lens, low, **kw)[8]
    log(f"{QUANT[nbits][0]} split edges at D={D} (n_split {n_split} at H={H}): worst head rel L2 "
        f"{max(errs):.3e}; "
        f"by G: {groups}")
    return {"n_split": n_split, "edges_rel_l2": max(errs), "groups_rel_l2": groups}


def kq_bitwise_repeat(nbits, q, kc, vc, sc, kn, vn, lens):
    """Whether two launches of K3 or K4 give bitwise-equal outputs and
    appended caches."""
    kernel = QUANT[nbits][1]

    def call():
        c = [kc.clone(), vc.clone(), sc.clone()]
        return (kernel(q, *c, lens, kn, vn), *c)

    same = bitwise_repeat(call)
    if not same:
        raise SystemExit(f"{QUANT[nbits][0]} at D={q.shape[-1]} is not deterministic")
    return same


def kq_dropped_slice_error(nbits, q, kc, vc, sc, kn, vn, lens, ref):
    """What K3's check sees from a cluster whose logit sum drops one slice's
    partial: the plain math with slice 0's channels (the first ``SLICE``)
    left out of each cached key's logit (the new token's logit, taken over
    all of D apart, kept), as the worst head rel L2."""
    H, G, D = q.shape
    C = kc.shape[1]
    L = lens.long().clamp(max=C - 1)
    k = quant_cache.dequantize(kc, sc[..., 0], sc[..., 1], nbits)
    v = quant_cache.dequantize(vc, sc[..., 2], sc[..., 3], nbits)
    k[..., :flash_prefill.SLICE] = 0
    keep = torch.arange(C, device=q.device)[None] < L[:, None]
    qs = q.float() * D ** -0.5
    logits = torch.where(keep[:, None], torch.einsum("hgd,hcd->hgc", qs, k), NEG_INF)
    s_new = torch.einsum("hgd,hd->hg", qs, kn.float())[..., None]
    probs = torch.softmax(torch.cat([logits, s_new], dim=-1), dim=-1)
    out = (torch.einsum("hgc,hcd->hgd", probs[..., :C], v)
           + probs[..., C:] * vn.float()[:, None]).to(q.dtype)
    return rel_l2(out.reshape(H, -1), ref.reshape(H, -1))[0]


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
# Phases 3e, 4c and 4d: K1-K4 at head_dim 64 and 256
# ---------------------------------------------------------------------------

# Each head_dim's K1 case: (Hq, Hkv) at B 2, S 4096, window 8, true_len
# (4096, 3000): Llama-3.2-1B-Instruct's heads at 64, phase 16b's at 256.
K1_HEAD_DIM_HEADS = {64: (32, 8), 256: (16, 4)}


def head_dim_of(fn):
    """The head_dim template argument of a mangled kernel name (its first
    ``ILi<n>E``), or None."""
    m = re.search(r"ILi(\d+)E", fn)
    return int(m.group(1)) if m else None


def registers_by_head_dim(reports, lib, name):
    """{D: (registers, spill line) of each instantiation} of the kernels of
    ``lib`` whose names hold ``name``, from this run's ptxas report; empty
    when the library was cached."""
    out = {}
    for fn, regs, spill in ptxas_entries(reports.get(lib, ""), name):
        out.setdefault(head_dim_of(fn), []).append((regs, spill))
    return out


def phase_k1_head_dims(rng, reports):
    """K1 at head_dim 64 and 256 against its plain version (the CTA's
    length edges, a 64-row observation window across a tile edge, two
    launches bitwise equal, a skipped key tile's error) and timed beside
    its plain version, SDPA and its bound; at 64 also a sliding-window case,
    a chunk case and a ring hop (K1-ml), at 256 two a-shape cases (the
    sparse tile list under 64-key tiles)."""
    regs = registers_by_head_dim(reports, "flash_prefill", "flash_fwd_kernel")
    out = {}
    for D, (Hq, Hkv) in K1_HEAD_DIM_HEADS.items():
        B, S, W, tls = 2, 4096, 8, [4096, 3000]
        q, k, v, tl, sc, out_ref, err, absd, err_sc = k1_case(rng, B, Hq, Hkv, S, W, tls, D)
        edges = [k1_case(rng, 4, 8, 2, 1024, W, [1, 127, 129, 1024], D)[6:9],
                 k1_case(rng, 2, 8, 2, 2048, 64, [1056, 2000], D)[6:9]]
        call = lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, W)  # noqa: E731
        same = bitwise_repeat(call)
        skip_err = k1_skipped_tile_error(q, k, v, tls, out_ref)
        log(f"K1 D={D}: two launches bitwise equal {same}; a skipped key tile [64, 128) would "
            f"show row rel L2 {skip_err:.3e} ({skip_err / K1_OUT_TOL:.1f} x tol); ptxas "
            f"(registers, spill) {regs.get(D, 'cached: no report')}")
        if not same or skip_err <= K1_OUT_TOL:
            raise SystemExit(f"K1 at D={D} is not deterministic, or its tolerance would let a "
                             "skipped tile pass")
        del out_ref
        t = time_k1(q, k, v, tl, W, tls, sc)
        passes = k1_pass_ms(call)
        log(f"K1 D={D} main pass {passes['flash_fwd_kernel']} ms, window-score pass "
            f"{score_pass_ms(passes)} ms (profiled)")
        del q, k, v, sc
        entry = {"name": f"flash_prefill_d{D}", "route": "cuda", "source": flash_prefill.SOURCE,
                 "replaces": flash_prefill.REPLACES,
                 "shape": f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} w={W} true_len={tls}",
                 "max_abs_err": absd, "rel_l2": err, "tol": K1_OUT_TOL,
                 "scores_max_abs_err": err_sc, "skipped_tile_rel_l2": skip_err, **t,
                 "bound_fraction": t["bound_ms"] / t["ms"],
                 "main_pass_ms": passes["flash_fwd_kernel"],
                 "score_pass_ms": score_pass_ms(passes), "deterministic": same,
                 "edge_cases": [{"rel_l2": e, "max_abs_err": a, "scores_max_abs_err": s}
                                for e, a, s in edges],
                 "ptxas": regs.get(D)}
        if D == 64:
            # Sliding window (Mistral-7B-v0.1's 4096 over 8192 rows at these
            # heads), a chunk pool of phase 16's drain (2048-row chunks over
            # 4096-row buffers, one inert), a ring hop of sp=2 over 8000 tokens.
            sw = k1v_case(rng, 1, Hq, Hkv, 8192, 8192, [8192], 4096, None, D)
            del sw["ref"]
            entry["sliding_window"] = {"rel_l2": sw["err"], "max_abs_err": sw["absd"],
                                       "shape": f"B=1 Hq={Hq} S=8192 D=64 sw=4096",
                                       **time_k1v(sw, 4096, None)}
            del sw
            offsets = [0, 2048, 2048, 0]
            ch = k1v_case(rng, 4, Hq, Hkv, 2048, 4096, [4096, 4096, 3000, 0], None, offsets, D)
            del ch["ref"]
            out["chunk"] = {
                "name": "flash_prefill_chunk_d64", "route": "cuda",
                "source": flash_prefill.SOURCE,
                "replaces": flash_prefill.REPLACES_VARIANT["chunk"],
                "shape": f"P=4 Hq={Hq} Hkv={Hkv} S_q=2048 S_k=4096 D=64 row_offset={offsets} "
                         "true_len=[4096, 4096, 3000, 0]",
                "max_abs_err": ch["absd"], "rel_l2": ch["err"], "tol": K1_OUT_TOL,
                "deterministic": bitwise_repeat(lambda: flash_prefill.flash_prefill_attention(
                    ch["q"], ch["k"], ch["v"], ch["tl"], 0, row_offset=ch["off"])),
                **time_k1v(ch, None, offsets)}
            del ch
            qh, kh, vh = (bf16_normal(rng, (1, h, 4000, 64)) for h in (Hq, Hkv, Hkv))
            hop = k1ml_case(qh, kh, vh, 8000, 4000)
            entry["ring_hop"] = {"rel_l2": hop["err"], "max_abs_err": hop["absd"],
                                 "m_max_abs_err": hop["m_err"], "l_max_rel_err": hop["l_err"],
                                 "shape": "B=1 Hq=32 S_loc=4000 D=64, rank 1 over shard 0, "
                                          "true_len 8000",
                                 **time_k1v(hop, None, [4000], ml=True)}
            del qh, kh, vh, hop
        else:
            # A-shape at this head_dim: 1024-row blocks at the check shape,
            # and 64-row blocks at S 1000, where each 64-key tile is one
            # half and the two warpgroups select apart; then timed at B 1.
            q, k, v = k1s_inputs(rng, 2, Hq, Hkv, S, D=D)
            a = k1s_case(q, k, v, tls, ASHAPE)
            dense_err, shift_err = k1s_mask_errors(a)
            del q, k, v, a["ref"]
            q, k, v = k1s_inputs(rng, 2, 8, 2, 1000, D=D)
            a64 = k1s_case(q, k, v, [1000, 777], ("ashape", 1, 3, 4), window=8, q_block=64)
            del q, k, v, a64["ref"]
            log(f"K1-A D={D}: an ignored mask would show {dense_err:.3e}, a shifted one "
                f"{shift_err:.3e} (tol {K1_OUT_TOL})")
            if min(dense_err, shift_err) <= 2 * K1_OUT_TOL:
                raise SystemExit("K1-A's tolerance would let an ignored or shifted mask pass")
            q, k, v = k1s_inputs(rng, 1, Hq, Hkv, 8192, D=D)
            t_a = time_k1s(q, k, v, [8000], ASHAPE)
            del q, k, v
            entry["ashape"] = {"rel_l2": max(a["err"], a64["err"], t_a["path_shape_rel_l2"]),
                               "max_abs_err": max(a["absd"], a64["absd"]),
                               "density": a["density"], "ignored_mask_rel_l2": dense_err,
                               "shifted_mask_rel_l2": shift_err, "block64_rel_l2": a64["err"],
                               "shape": f"B=1 Hq={Hq} Hkv={Hkv} S=8192 D={D} true_len=[8000], "
                                        f"{ASHAPE}, block 1024", **t_a}
        out[D] = entry
        torch.cuda.empty_cache()
    return out


def phase_k2_head_dims(rng, reports):
    """K2 at head_dim 64 and 256, G 1 and G 4, against its plain version
    (off-by-one and dropped-split sensitivity, bitwise repeats and graph
    replays, the split-rule edges) and timed beside its plain version, SDPA
    and its bound: at G 1 the snapkv decode of phases 16 / 16b (B 2 x the
    query heads at 2079 / 1531 keys), at G 4 phase 16's fullkv decode (B 2
    x 8 KV heads at 4159 / 1563 keys, C 4161)."""
    regs = registers_by_head_dim(reports, "decode_attn", "decode_attn_kernel")
    out = {}
    for D, Hq, Hkv in ((64, 32, 8), (256, 16, 4)):
        C = 2113
        H = 2 * Hq
        lens = [2048 + 31] * Hq + [1500 + 31] * Hq
        q, kc, vc, kn, vn, lt, _, ref, err, absd = k2_case(rng, H, 1, C, lens,
                                                            np.zeros(H, np.int64), D)
        off_err = k2_one_key_off_error(q, kc, vc, kn, vn, lt, ref)
        drop_err, n_split = k2_dropped_split_error(q, kc, vc, kn, vn, lt, ref)
        log(f"K2 D={D}: a key range off by one would show {off_err:.3e}, a dropped split "
            f"(1 of {n_split}) {drop_err:.3e} (tol {K2_OUT_TOL}); ptxas (registers, spill) "
            f"{sorted(set(regs.get(D, [])))}")
        if min(off_err, drop_err) <= K2_OUT_TOL:
            raise SystemExit(f"K2's tolerance at D={D} would let an off-by-one or dropped split "
                             "pass")
        checks = {**k2_repeat_and_replay(q, kc, vc, kn, vn, lt), **k2_split_edges(rng, D)}
        main = time_k2(q, kc, vc, kn, vn, lt)
        del q, kc, vc, ref
        C4 = 4096 + 64 + 1
        H4 = 2 * Hkv
        q, kc, vc, kn, vn, lt, _, ref, err4, abs4 = k2_case(
            rng, H4, Hq // Hkv, C4, [4096 + 63] * Hkv + [1500 + 63] * Hkv,
            np.zeros(H4, np.int64), D)
        drop4, n4 = k2_dropped_split_error(q, kc, vc, kn, vn, lt, ref)
        if drop4 <= K2_OUT_TOL:
            raise SystemExit(f"K2's tolerance at D={D}, G 4 would let a dropped split pass")
        g4 = time_k2(q, kc, vc, kn, vn, lt)
        del q, kc, vc, ref
        out[D] = {"name": f"decode_attn_append_d{D}", "route": "cuda",
                  "source": decode_attn.SOURCE, "replaces": decode_attn.REPLACES,
                  "shape": f"H={H} (B=2 x {Hq}) G=1 C={C} D={D}, lengths 2079 and 1531",
                  "max_abs_err": max(absd, abs4), "rel_l2": max(err, err4),
                  "tol": K2_OUT_TOL, "off_by_one_rel_l2": off_err,
                  "dropped_split_rel_l2": drop_err, "n_split": n_split, **checks, **main,
                  "g4": {"shape": f"H={H4} (B=2 x {Hkv}) G={Hq // Hkv} C={C4} D={D}, lengths "
                                  "4159 and 1563", "rel_l2": err4, "max_abs_err": abs4,
                         "dropped_split_rel_l2": drop4, "n_split": n4, **g4},
                  "ptxas": regs.get(D)}
        torch.cuda.empty_cache()
    return out


def phase_kq_head_dims(rng, reports):
    """K3 and K4 at head_dim 256, G 1 and G 4, against their plain versions
    with the append byte for byte (off-by-one and dropped-split
    sensitivity, bitwise repeats and graph replays, the split and tile
    edges, the range case ``KQ_RANGE``) and timed beside the plain version
    and the dequantize + SDPA composite at phase 16b's decode shape (B 2 x
    16 heads at 2079 / 1531 keys)."""
    D, Hq, Hkv = 256, 16, 4
    out = {}
    for nbits in (8, 4):
        kid, _, _, C = QUANT[nbits]
        regs = registers_by_head_dim(reports, "decode_attn_quant", QUANT_KERNELS[kid])
        H = 2 * Hq
        lens = [2048 + 31] * Hq + [1500 + 31] * Hq
        q, kc, vc, sc, kn, vn, lt, ref, err, absd = kq_case(
            rng, nbits, H, 1, C, lens, np.zeros(H, np.int64), D=D)
        off_err = kq_one_key_off_error(nbits, q, kc, vc, sc, kn, vn, lt, ref)
        drop_err, n_split = kq_dropped_split_error(nbits, q, kc, vc, sc, kn, vn, lt, ref)
        log(f"{kid} D={D}: a key range off by one would show {off_err:.3e}, a dropped split "
            f"(1 of {n_split}) {drop_err:.3e} (tol {KQ_OUT_TOL}); ptxas (registers, spill) "
            f"{sorted(set(regs.get(D, [])))}")
        if min(off_err, drop_err) <= KQ_OUT_TOL:
            raise SystemExit(f"{kid}'s tolerance at D={D} would let an off-by-one or dropped "
                             "split pass")
        checks = {**kq_repeat_and_replay(nbits, q, kc, vc, sc, kn, vn, lt),
                  **kq_split_edges(rng, nbits, C, D)}
        checks["range_rel_l2"] = kq_case(rng, nbits, H, 1, C, lens, np.zeros(H, np.int64),
                                         KQ_RANGE, D)[8]
        err4 = kq_case(rng, nbits, 2 * Hkv, Hq // Hkv, C, [2048 + 31] * Hkv + [1500 + 31] * Hkv,
                       np.zeros(2 * Hkv, np.int64), D=D)[8]
        main = time_kq(nbits, q, kc, vc, sc, kn, vn, lt)
        del q, kc, vc, sc, ref
        out[nbits] = {"name": f"quant{nbits}_decode_attn_append_d{D}", "route": "cuda",
                      "source": decode_attn_quant.SOURCE,
                      "replaces": decode_attn_quant.REPLACES[nbits],
                      "shape": f"H={H} (B=2 x {Hq}) G=1 C={C} D={D} int{nbits}, lengths 2079 "
                               "and 1531", "max_abs_err": absd, "rel_l2": err,
                      "tol": KQ_OUT_TOL, "g4_rel_l2": err4, "off_by_one_rel_l2": off_err,
                      "dropped_split_rel_l2": drop_err, "n_split": n_split,
                      "append_bit_identical": True, **checks, **main, "ptxas": regs.get(D)}
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 3g, 4f and 4g: K1-K4 at every head_dim up to 512
# ---------------------------------------------------------------------------

# The head_dims K1 and K2 are held at, each running on the narrowest
# instantiation at least as wide (flash_prefill.instance: 64, 128, 256, 384,
# 512) with its own 1/sqrt(D); the heads (Hq, Hkv) of the models that run
# 80 (phase 19, h2o-danube2-1.8b) and 384 / 512 (phase 19b); 16 / 4 heads at
# the others, whose checks attach to their instantiation's entry.
NEW_HEAD_DIMS = (16, 32, 80, 96, 120, 160, 192, 384, 512)
MODEL_HEAD_DIM_HEADS = {80: (32, 8), 384: (8, 2), 512: (8, 2)}
WIDE_HEAD_DIMS = (384, 512)  # K3 / K4's new head_dims (the per-token cache's)
VS_NARROW = ("vertical_slash", 64, 16, 64)  # 64 columns, 16 diagonals, 64 estimation rows


@contextlib.contextmanager
def instantiation_scale(lib_name, scale=None):
    """The kernels of ``lib_name`` handed 1/sqrt(instantiation width), or
    ``scale``, in place of the 1/sqrt(D) its wrapper passes: what a wrapper
    that took the scale from the instantiation it runs (or from another
    width) would compute."""
    real_load = _build.load
    real = real_load(lib_name)

    class Lib:
        def __getattr__(self, entry):
            fn = getattr(real, entry)
            s = int(entry.rsplit("_d", 1)[1]) ** -0.5 if scale is None else scale
            return lambda *args: fn(*args[:-2], s, args[-1])

    _build.load = lambda name: Lib() if name == lib_name else real_load(name)
    try:
        yield
    finally:
        _build.load = real_load


def sdpa_backend(call):
    """Which backend ``scaled_dot_product_attention`` ran in ``call``, read
    from the kernel names of one profiled call: "flash" (``flash_fwd``),
    "memory-efficient" (``fmha``), "cuDNN" or, with none of those, "math"
    (plain products and a softmax).  The window opens with the
    ``PROFILE_BURST`` spin kernels, which take the profiler's loss of a
    session's first device records (without them, late in the script the
    call's few records were lost and every call read as "math"); a window
    with no record of the call is "not measured"."""
    call()
    sync()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        profile_burst()
        call()
        sync()
    keys = [evt.key for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA and BURST_KERNEL not in evt.key]
    if not keys:
        return "not measured"
    names = " ".join(keys).lower()
    for tag, backend in (("flash_fwd", "flash"), ("fmha", "memory-efficient"),
                         ("cudnn", "cuDNN")):
        if tag in names:
            return backend
    return "math"


def k1_head_dim_variants(rng, D, Hq, Hkv):
    """K1's sliding-window, chunk, a-shape, vertical-slash and ring-hop
    variants at head_dim D against their plain versions, on inputs whose
    buffers end in NaN, with what an off-by-one window or row offset, an
    ignored or shifted block mask and a dropped key tile would show; the
    chunk pool timed (phase 19's drain runs it at 80)."""
    sw = k1v_case(rng, 1, Hq, Hkv, 4096, 4096, [4096], 1000, None, D, tail=True)
    sw_off, sw_err = k1v_off_by_one(sw, 1000, None, "window"), sw["err"]
    del sw
    offsets = [0, 2048, 2048, 0]
    ch = k1v_case(rng, 4, Hq, Hkv, 2048, 4096, [4096, 4096, 3000, 0], None, offsets, D,
                  tail=True)
    ch_off = k1v_off_by_one(ch, None, offsets, "offset")
    ch_sw = k1v_case(rng, 2, Hq, Hkv, 1024, 4096, [4096, 2500], 700, [3072, 1000], D,
                     tail=True)
    del ch_sw["ref"]
    q, k, v = k1s_inputs(rng, 2, 8, 2, 1000, D=D)
    a64 = k1s_case(*(nan_tailed(x) for x in (q, k, v)), [1000, 777], ("ashape", 1, 3, 4),
                   window=8, q_block=64)
    a_dense, a_shift = k1s_mask_errors(a64)
    del q, k, v, a64["ref"]
    # At 4096 rows the default pattern (1024 columns, 1024-row blocks) keeps
    # every block: a narrow one on 64-row blocks is sparse on planted inputs.
    q, k, v = k1s_inputs(rng, 1, Hq, Hkv, 4096, heavy=(1000, 1100), D=D)
    vs = k1s_case(*(nan_tailed(x) for x in (q, k, v)), [4000], VS_NARROW, q_block=64)
    vs_dense, _ = k1s_mask_errors(vs)
    del q, k, v, vs["ref"]
    qh, kh, vh = (nan_tailed(bf16_normal(rng, (1, h, 2000, D))) for h in (Hq, Hkv, Hkv))
    hop = k1ml_case(qh, kh, vh, 4000, 2000)
    hop_sw = k1ml_case(qh, kh, vh, 4000, 2000, sw=700)
    hop_drop = max(k1ml_dropped_tile(hop))
    del qh, kh, vh
    worst = min(sw_off, ch_off, a_dense, a_shift, vs_dense, hop_drop)
    log(f"K1 variants D={D}: an off-by-one window would show {sw_off:.3e}, an off-by-one row "
        f"offset {ch_off:.3e}, an ignored a-shape mask {a_dense:.3e} (shifted {a_shift:.3e}), an "
        f"ignored vertical-slash mask {vs_dense:.3e}, a dropped K1-ml key tile {hop_drop:.3e} "
        f"(tol {K1_OUT_TOL})")
    if worst <= K1_OUT_TOL:
        raise SystemExit(f"K1's tolerance at D={D} would let a variant's fault pass")
    timed_chunk = time_k1v(ch, None, offsets)
    ch_err, ch_abs = ch["err"], ch["absd"]
    del ch
    return {"sliding_window_rel_l2": sw_err, "chunk": {
                "shape": f"P=4 Hq={Hq} Hkv={Hkv} S_q=2048 S_k=4096 D={D} row_offset={offsets} "
                         "true_len=[4096, 4096, 3000, 0]", "rel_l2": ch_err,
                "max_abs_err": ch_abs, **timed_chunk},
            "chunk_sw_rel_l2": ch_sw["err"], "ashape_block64_rel_l2": a64["err"],
            "vertical_slash_rel_l2": vs["err"], "vertical_slash_density": vs["density"],
            "ring_hop_rel_l2": max(hop["err"], hop_sw["err"]),
            "ring_hop_m_err": max(hop["m_err"], hop_sw["m_err"]),
            "sensitivity_rel_l2": {"window_off_by_one": sw_off, "offset_off_by_one": ch_off,
                                   "ashape_ignored": a_dense, "ashape_shifted": a_shift,
                                   "vertical_slash_ignored": vs_dense,
                                   "ring_dropped_tile": hop_drop}}


def phase_k1_new_head_dims(rng, reports):
    """Phase 3g: K1 at each of ``NEW_HEAD_DIMS`` against its plain version
    on inputs whose buffers end in NaN: dense with window scores (B 2, S
    4096 at the models' heads for 80, 384 and 512; S 2048, 16 / 4 heads
    elsewhere), the CTA's length edges (true_len 1, 63, 129 and 1000 under
    a 64-row window), two launches bitwise equal, what a skipped key tile
    and, where D runs on a wider instantiation, that instantiation's
    1/sqrt(width) in place of 1/sqrt(D) would show (both must fail the
    limit); timed beside its plain version, SDPA and its bound.  At 80, 384
    and 512 also the variants (``k1_head_dim_variants``)."""
    regs = registers_by_head_dim(reports, "flash_prefill", "flash_fwd_kernel")
    out = {}
    for D in NEW_HEAD_DIMS:
        width = flash_prefill.instance(D)
        Hq, Hkv = MODEL_HEAD_DIM_HEADS.get(D, (16, 4))
        B, W = 2, 8
        S = 4096 if D in MODEL_HEAD_DIM_HEADS else 2048
        tls = [S, S * 3 // 4]
        q, k, v, tl, sc, out_ref, err, absd, err_sc = k1_case(rng, B, Hq, Hkv, S, W, tls, D,
                                                              tail=True)
        edge = k1_case(rng, 4, 8, 2, 1024, 64, [1, 63, 129, 1000], D, tail=True)[6:9]
        call = lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, W)  # noqa: E731
        same = bitwise_repeat(call)
        skip_err = k1_skipped_tile_error(q, k, v, tls, out_ref, r0=S // 2)
        scale_err = None
        if width != D:
            with instantiation_scale("flash_prefill"):
                wrong = call()[0]
            sync()
            scale_err = max(rel_l2(wrong[b, :, :t], out_ref[b, :, :t])[0]
                            for b, t in enumerate(tls))
            del wrong
        log(f"K1 D={D} (instantiation {width}): two launches bitwise equal {same}; a skipped key "
            f"tile [64, 128) would show {skip_err:.3e}, the instantiation's scale "
            f"{width}^-0.5 {scale_err if scale_err is None else f'{scale_err:.3e}'} (tol "
            f"{K1_OUT_TOL}); ptxas (registers, spill) {regs.get(width, 'cached: no report')}")
        if not same or skip_err <= K1_OUT_TOL or (scale_err is not None
                                                  and scale_err <= K1_OUT_TOL):
            raise SystemExit(f"K1 at D={D} is not deterministic, or its tolerance would let a "
                             "skipped tile or the instantiation's scale pass")
        del out_ref
        t = time_k1(q, k, v, tl, W, tls, sc)
        backend = sdpa_backend(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        log(f"K1 D={D}: the library yardstick ran SDPA's {backend} backend")
        del q, k, v, sc
        entry = {"name": f"flash_prefill_d{D}", "route": "cuda", "source": flash_prefill.SOURCE,
                 "replaces": flash_prefill.REPLACES, "instantiation": width,
                 "library": f"scaled_dot_product_attention, causal GQA ({backend} backend)",
                 "shape": f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} w={W} true_len={tls}",
                 "max_abs_err": absd, "rel_l2": err, "tol": K1_OUT_TOL,
                 "scores_max_abs_err": err_sc, "skipped_tile_rel_l2": skip_err,
                 "instantiation_scale_rel_l2": scale_err, **t,
                 "bound_fraction": t["bound_ms"] / t["ms"], "deterministic": same,
                 "edge_case": {"rel_l2": edge[0], "max_abs_err": edge[1],
                               "scores_max_abs_err": edge[2]},
                 "nan_tailed_inputs": True, "ptxas": regs.get(width)}
        if D in MODEL_HEAD_DIM_HEADS:
            entry["variants"] = k1_head_dim_variants(rng, D, Hq, Hkv)
        out[D] = entry
        torch.cuda.empty_cache()
    return out


def k2_edge_cases(rng, D, G):
    """K2 on the edge shapes at head_dim D and G query rows a head, inputs
    in NaN-tailed buffers: a one-slot cache, 17 slots (a full one, an empty
    one, a lower bound past the length), a full 2113-slot cache; the worst
    head rel L2."""
    return max(k2_case(rng, 3, G, 1, [0, 1, 0], [0, 0, 0], D, tail=True)[8],
               k2_case(rng, 4, G, 17, [17, 0, 9, 5], [0, 0, 3, 9], D, tail=True)[8],
               k2_case(rng, 4, G, 2113, [2113, 2112, 1, 2000], [0, 5, 0, 2001], D, tail=True)[8])


def phase_k2_new_head_dims(rng, reports):
    """Phase 4f: K2 at each of ``NEW_HEAD_DIMS``, G 1, 4 and 12, against its
    plain version (inputs in NaN-tailed buffers; the cache after the append
    identical) on a decode layer (B 2 at 2079 / 1531 keys, C 2113: the
    models' query heads at 80, 384 and 512, 16 elsewhere; G 4 and 12 over
    4159 / 1563 keys, C 4161) and the edge shapes (``k2_edge_cases``), with
    what an off-by-one key range, a dropped split and, on a wider
    instantiation, its 1/sqrt(width) would show; at 80, 384 and 512 also
    bitwise repeats and graph replays, at 384 and 512 the split-rule edges;
    the G 1 decode (and at 80 the G 4 one) timed beside its plain version,
    SDPA and its bound."""
    regs = registers_by_head_dim(reports, "decode_attn", "decode_attn_kernel")
    out = {}
    for D in NEW_HEAD_DIMS:
        width = flash_prefill.instance(D)
        model = D in MODEL_HEAD_DIM_HEADS
        Hq, Hkv = MODEL_HEAD_DIM_HEADS.get(D, (16, 4))
        C, H = 2113, 2 * Hq
        lens = [2048 + 31] * Hq + [1500 + 31] * Hq
        q, kc, vc, kn, vn, lt, _, ref, err, absd = k2_case(rng, H, 1, C, lens,
                                                            np.zeros(H, np.int64), D, tail=True)
        off_err = k2_one_key_off_error(q, kc, vc, kn, vn, lt, ref)
        drop_err, n_split = k2_dropped_split_error(q, kc, vc, kn, vn, lt, ref)
        scale_err = None
        if width != D:
            with instantiation_scale("decode_attn"):
                wrong = decode_attn.decode_attention_append(q, kc.clone(), vc.clone(), lt, kn, vn)
            sync()
            scale_err = rel_l2(wrong.reshape(H, -1), ref.reshape(H, -1))[0]
        C4 = 4096 + 64 + 1
        by_g = {}
        for G in (4, 12):
            Hg = 2 * Hkv if G == Hq // Hkv else 16
            by_g[G] = k2_case(rng, Hg, G, C4, [4096 + 63] * (Hg // 2) + [1500 + 63] * (Hg // 2),
                              np.zeros(Hg, np.int64), D, tail=True)[8]
        edges = {G: k2_edge_cases(rng, D, G) for G in (1, 4, 12)}
        log(f"K2 D={D} (instantiation {width}): G 4 / 12 head rel L2 {by_g[4]:.3e} / "
            f"{by_g[12]:.3e}, edge shapes {max(edges.values()):.3e}; a key range off by one would "
            f"show {off_err:.3e}, a dropped split (1 of {n_split}) {drop_err:.3e}, the "
            f"instantiation's scale {scale_err if scale_err is None else f'{scale_err:.3e}'} "
            f"(tol {K2_OUT_TOL}); ptxas (registers, spill) {sorted(set(regs.get(width, [])))}")
        if min(off_err, drop_err, scale_err or 1.0) <= K2_OUT_TOL:
            raise SystemExit(f"K2's tolerance at D={D} would let an off-by-one, a dropped split or "
                             "the instantiation's scale pass")
        entry = {"name": f"decode_attn_append_d{D}", "route": "cuda",
                 "source": decode_attn.SOURCE, "replaces": decode_attn.REPLACES,
                 "instantiation": width,
                 "shape": f"H={H} (B=2 x {Hq}) G=1 C={C} D={D}, lengths 2079 and 1531",
                 "max_abs_err": absd, "rel_l2": err, "tol": K2_OUT_TOL,
                 "g4_rel_l2": by_g[4], "g12_rel_l2": by_g[12], "edges_rel_l2": edges,
                 "off_by_one_rel_l2": off_err, "dropped_split_rel_l2": drop_err,
                 "instantiation_scale_rel_l2": scale_err, "n_split": n_split,
                 "nan_tailed_inputs": True, "ptxas": regs.get(width)}
        if model:
            entry.update(k2_repeat_and_replay(q, kc, vc, kn, vn, lt))
        if D in WIDE_HEAD_DIMS:  # the 2-warp CTAs' split rule (80 runs phase 4's 128)
            entry.update(k2_split_edges(rng, D))
        entry.update(time_k2(q, kc, vc, kn, vn, lt))
        mask = (torch.arange(C, device="cuda")[None] <= lt[:, None].long())[None, :, None]
        backend = sdpa_backend(lambda: F.scaled_dot_product_attention(
            q[None], kc[None], vc[None], attn_mask=mask))
        log(f"K2 D={D}: the library yardstick ran SDPA's {backend} backend")
        entry["library"] = f"scaled_dot_product_attention with a boolean cache mask ({backend} backend)"
        del q, kc, vc, ref
        if D == 80:  # phase 19's fullkv decode: G 4 over the 8 KV heads
            H4 = 2 * Hkv
            q, kc, vc, kn, vn, lt, _, ref, err4, abs4 = k2_case(
                rng, H4, Hq // Hkv, C4, [4096 + 63] * Hkv + [1500 + 63] * Hkv,
                np.zeros(H4, np.int64), D, tail=True)
            entry["g4"] = {"shape": f"H={H4} (B=2 x {Hkv}) G={Hq // Hkv} C={C4} D={D}, lengths "
                                    "4159 and 1563", "rel_l2": err4, "max_abs_err": abs4,
                           **time_k2(q, kc, vc, kn, vn, lt)}
            del q, kc, vc, ref
        out[D] = entry
        torch.cuda.empty_cache()
    return out


def phase_kq_wide_head_dims(rng, reports, dims=WIDE_HEAD_DIMS, bits=(8, 4)):
    """Phase 4g: K3 and K4 at head_dim 384 and 512 (phase 4j: at
    ``WIDE_KQ_DIMS``, on the wide kernels at phase 21's heads; phase 4k: K3
    at ``WIDE_MORE_DIMS``), G 1, 4 and 12, against their plain versions
    with the append byte for byte (inputs in NaN-tailed buffers) on phase
    19b's decode layer (B 2 x 8 heads at 2079 / 1531 keys), the range case
    ``KQ_RANGE`` at each G and the edge shapes (C 1, 17, a full cache, a
    lower bound past the length), with what an off-by-one key range, a
    dropped split and (K3's cluster) a dropped slice partial would show,
    bitwise repeats and graph replays.  Above 512 K4's kernel (the
    slice-recomputing one, the same at every width) takes G 12, the edge
    shapes and the replays at 1024 only; K3 takes G 12 and the edge shapes
    at every width (each cluster size lays out its shared memory and its
    fan-out apart), and the replays and the split-rule edges at 1024 and
    past the cluster limit.  Timed at 384, 512 and ``WIDE_FULL``'s widths
    beside the plain version and the dequantize + SDPA composite."""
    out = {}
    for nbits in bits:
        kid, _, _, C = QUANT[nbits]
        for D in dims:
            if D > 512:  # the wide kernels' instantiations at these bits (GB 1-8)
                regs = {D: [(r, sp) for _, r, sp in ptxas_entries(
                    reports.get(decode_attn_quant.library(D, nbits), ""),
                    "quant8_cluster_kernel" if decode_attn_quant.library(D, nbits)
                    == "decode_attn_quant_cluster" else f"decode_wide_kernelILi{nbits}E")]}
            else:
                regs = registers_by_head_dim(reports, decode_attn_quant.library(D, nbits),
                                             QUANT_KERNELS[kid])
            Hq, Hkv = MODEL_HEAD_DIM_HEADS.get(D, LLAMA3_WIDE_HEADS)
            H = 2 * Hq
            lens = [2048 + 31] * Hq + [1500 + 31] * Hq
            q, kc, vc, sc, kn, vn, lt, ref, err, absd = kq_case(
                rng, nbits, H, 1, C, lens, np.zeros(H, np.int64), D=D, tail=True)
            off_err = kq_one_key_off_error(nbits, q, kc, vc, sc, kn, vn, lt, ref)
            drop_err, n_split = kq_dropped_split_error(nbits, q, kc, vc, sc, kn, vn, lt, ref)
            cluster = decode_attn_quant.library(D, nbits) == "decode_attn_quant_cluster"
            # K3 past the cluster limit: the slice-recomputing build, held as at 1024.
            past = nbits == 8 and D > 512 and not cluster
            every_g = D <= 512 or D == 1024 or nbits == 8
            slice_err = kq_dropped_slice_error(nbits, q, kc, vc, sc, kn, vn, lt, ref) \
                if cluster else None
            if min(off_err, drop_err, *([slice_err] if cluster else [])) <= KQ_OUT_TOL:
                raise SystemExit(f"{kid}'s tolerance at D={D} would let an off-by-one, a dropped "
                                 "split or a dropped slice partial pass")
            by_g, ranges, edges = {}, {}, {}
            for G in (1, 4, 12) if every_g else (1, 4):
                Hg = H if G == 1 else 2 * Hkv if G == Hq // Hkv else 16
                lg = [2048 + 31] * (Hg // 2) + [1500 + 31] * (Hg // 2)
                if G > 1:
                    by_g[G] = kq_case(rng, nbits, Hg, G, C, lg, np.zeros(Hg, np.int64), D=D,
                                      tail=True)[8]
                ranges[G] = kq_case(rng, nbits, Hg, G, C, lg, np.zeros(Hg, np.int64), KQ_RANGE,
                                    D=D, tail=True)[8]
                if not every_g:
                    continue
                edges[G] = max(
                    kq_case(rng, nbits, 3, G, 1, [0, 1, 0], [0, 0, 0], D=D, tail=True)[8],
                    kq_case(rng, nbits, 4, G, 17, [17, 0, 9, 5], [0, 0, 3, 9], D=D,
                            tail=True)[8],
                    kq_case(rng, nbits, 4, G, C, [C, C - 1, 1, 2000], [0, 5, 0, 2001], D=D,
                            tail=True)[8])
            if D <= 512 or D == 1024 or past:
                checks = kq_repeat_and_replay(nbits, q, kc, vc, sc, kn, vn, lt)
            else:  # two launches bitwise equal at every wide width
                checks = {"bitwise_repeat": kq_bitwise_repeat(nbits, q, kc, vc, sc, kn, vn, lt)}
            if D == 1024 or past:
                checks["split_edges"] = kq_split_edges(rng, nbits, C, D)
            if cluster:
                n = flash_prefill.cluster_size(D)
                smem, clusters = cluster_info("decode_attn_quant_cluster",
                                              "kvcf_quant8_decode_cluster_info", n)
                checks.update(cluster_size=n, cluster_smem_bytes=smem, clusters_at_once=clusters,
                              dropped_slice_rel_l2=slice_err)
                log(f"{kid} D={D}: a cluster of {n} CTAs, {smem} B of shared memory a CTA, "
                    f"{clusters} clusters at once; a dropped slice partial would show "
                    f"{slice_err:.3e} (tol {KQ_OUT_TOL})")
            log(f"{kid} D={D}: G 4 / 12 head rel L2 {by_g[4]:.3e} / {by_g.get(12, 0.0):.3e}, range "
                f"case {max(ranges.values()):.3e}, edge shapes {max(edges.values(), default=0.0):.3e}"
                f" (G {sorted(edges)}); a key range "
                f"off by one would show {off_err:.3e}, a dropped split (1 of {n_split}) "
                f"{drop_err:.3e} (tol {KQ_OUT_TOL}); ptxas (registers, spill) "
                f"{sorted(set(regs.get(D, [])))}")
            main = time_kq(nbits, q, kc, vc, sc, kn, vn, lt) if D <= 512 or D in WIDE_FULL \
                else {}
            del q, kc, vc, sc, ref
            out[(nbits, D)] = {
                "name": f"quant{nbits}_decode_attn_append_d{D}", "route": "cuda",
                "source": (decode_attn_quant.CLUSTER_SOURCE if cluster else
                           decode_attn_quant.WIDE_SOURCE if D > 512 else decode_attn_quant.SOURCE),
                "replaces": decode_attn_quant.REPLACES[nbits],
                "built_as": decode_attn_quant.library(D, nbits),
                "shape": f"H={H} (B=2 x {Hq}) G=1 C={C} D={D} int{nbits}, lengths 2079 and 1531",
                "max_abs_err": absd, "rel_l2": err, "tol": KQ_OUT_TOL, "g4_rel_l2": by_g[4],
                "g12_rel_l2": by_g.get(12), "range_rel_l2": ranges, "edges_rel_l2": edges,
                "off_by_one_rel_l2": off_err, "dropped_split_rel_l2": drop_err,
                "n_split": n_split, "append_bit_identical": True, "nan_tailed_inputs": True,
                **checks, **main, "ptxas": regs.get(D)}
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 3h and 4h: K1 and K2 at head_dims that are no multiple of 8
# ---------------------------------------------------------------------------

# Every instantiation (64: 20, 42; 128: 100, 110; 256: 150; 384: 300; 512:
# 510) and D % 8 of 4 (20, 100, 300) and of 2 and 6 (42, 110, 150, 510).
# 100 is OpenLLaMA-3B v2's (phase 20), at its 32 / 32 heads.
RAGGED_HEAD_DIMS = (20, 42, 100, 110, 150, 300, 510)
OPENLLAMA_HEADS = (32, 32)
OPENLLAMA_PROMPTS = (1984, 1500)  # phase 20's requests, bucket 2048
# 1/sqrt(width) in place of 1/sqrt(D) changes every logit by the factor
# sqrt(D / width): by 0.2% at D 510 on the 512 instantiation, which moves an
# output row by less than K1's or K2's limit (measured beside them).  K1's
# check then holds the scale through K1-ml's row max m (limit K1ML_M_TOL);
# K2 returns no such statistic, so at a scale off by less than this its
# scale fault is reported and not required to fail (the wrapper's D ** -0.5
# is held by tests/test_torch_ragged_head_dims.py).
SCALE_VISIBLE = 0.01


def plain_attention_rows(q, k, v, rows, t, scale):
    """Plain fp32 causal attention of q's ``rows`` (global ids) over k / v's
    first ``t`` keys: [len(rows), v's width]."""
    s = q[rows].float() @ k.float().T * scale
    cols = torch.arange(k.shape[0], device=q.device)[None]
    keep = (cols <= rows[:, None]) & (cols < t)
    return torch.softmax(torch.where(keep, s, float("-inf")), dim=-1) @ v.float()


def wide_rows(x, width):
    """The rows of a contiguous [S, D] plane read at ``width`` > D columns
    with the row stride D: each row's channels past D are the next row's
    first ones (zeros past the plane's end)."""
    S, D = x.shape
    flat = torch.cat([x.reshape(-1), x.new_zeros(width)])
    return flat.as_strided((S, width), (D, 1))


def k1_ragged_fault_errors(q, k, v, tls, out_ref, r0, width=None):
    """What K1's check sees (example 0, head 0, rows r0 .. true_len) from a
    kernel that drops each row's last copy piece of q, k and v (zeros in
    its place) and from one that reads every row at its instantiation's
    width (or ``width``: the next row's first channels past D, its output's
    first D columns kept): each worst row rel L2 against the plain
    version."""
    t, D = tls[0], q.shape[-1]
    pc = flash_prefill.copy_bytes(D) // 2
    rows = torch.arange(r0, t, device=q.device)
    qh, kh, vh = q[0, 0], k[0, 0], v[0, 0]
    cut = [x.clone() for x in (qh, kh, vh)]
    for x in cut:
        x[:, D - pc:] = 0
    dropped = plain_attention_rows(*cut, rows, t, D ** -0.5)
    width = width or flash_prefill.instance(D)
    wide = plain_attention_rows(*(wide_rows(x, width) for x in (qh, kh, vh)), rows, t,
                                D ** -0.5)[:, :D]
    ref = out_ref[0, 0, r0:t]
    return rel_l2(dropped, ref)[0], rel_l2(wide, ref)[0]


def phase_k1_ragged(rng, reports):
    """Phase 3h: K1 at each of ``RAGGED_HEAD_DIMS`` (the libraries whose
    producer copies 8- or 4-byte pieces) against its plain version on
    inputs whose buffers end in NaN: dense with window scores (at 100
    OpenLLaMA-3B's 32 / 32 heads at phase 20's 2048 rows, true_len 1984 /
    1500; elsewhere 16 / 4 heads, S 2048), the CTA's length edges of 3g,
    two launches bitwise equal, and what a skipped key tile, 1/sqrt(width)
    in place of 1/sqrt(D), a row's tail piece dropped and a row read at the
    instantiation's width would show (each must fail the limit); timed
    beside its plain version, SDPA (with the backend it ran) and its bound.
    At 100 also the variants (``k1_head_dim_variants``: SW, chunk, a-shape,
    vertical-slash, a ring hop)."""
    out = {}
    for D in RAGGED_HEAD_DIMS:
        width, lib = flash_prefill.instance(D), flash_prefill.library(D)
        regs = registers_by_head_dim(reports, lib, "flash_fwd_kernel")
        Hq, Hkv = OPENLLAMA_HEADS if D == 100 else (16, 4)
        B, W, S = 2, 8, 2048
        tls = list(OPENLLAMA_PROMPTS) if D == 100 else [S, S * 3 // 4]
        q, k, v, tl, sc, out_ref, err, absd, err_sc = k1_case(rng, B, Hq, Hkv, S, W, tls, D,
                                                              tail=True)
        edge = k1_case(rng, 4, 8, 2, 1024, 64, [1, 63, 129, 1000], D, tail=True)[6:9]
        call = lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, W)  # noqa: E731
        same = bitwise_repeat(call)
        r0 = tls[0] // 2
        skip_err = k1_skipped_tile_error(q, k, v, tls, out_ref, r0=r0)
        with instantiation_scale(lib):
            wrong = call()[0]
        sync()
        scale_err = max(rel_l2(wrong[b, :, :t], out_ref[b, :, :t])[0] for b, t in enumerate(tls))
        del wrong
        tail_err, wide_err = k1_ragged_fault_errors(q, k, v, tls, out_ref, r0)
        # The scale again through a ring hop's row max m (K1-ml at this D).
        qh, kh, vh = (nan_tailed(bf16_normal(rng, (1, h, 1024, D))) for h in (Hq, Hkv, Hkv))
        hop = k1ml_case(qh, kh, vh, 2048, 1024)
        with instantiation_scale(lib):
            m_wrong = flash_prefill.flash_prefill_attention(
                qh, kh, vh, hop["tl"], 0, row_offset=hop["off"], return_ml=True)[2]
        sync()
        scale_m_err = (m_wrong - hop["m_ref"]).abs().max().item()
        del qh, kh, vh, hop, m_wrong
        faults = {"skipped_tile": skip_err, "instantiation_scale": scale_err,
                  "tail_piece_dropped": tail_err, "row_read_at_width": wide_err}
        log(f"K1 D={D} ({lib}, instantiation {width}, {flash_prefill.copy_bytes(D)}-byte "
            f"pieces): two launches bitwise equal {same}; a fault would show "
            f"{({n: f'{e:.3e}' for n, e in faults.items()})} (tol {K1_OUT_TOL}), the "
            f"instantiation's scale in K1-ml's m {scale_m_err:.3e} (tol {K1ML_M_TOL}); ptxas "
            f"(registers, spill) {regs.get(width, 'cached: no report')}")
        if not same or min(e for n, e in faults.items() if n != "instantiation_scale") \
                <= K1_OUT_TOL or (scale_err <= K1_OUT_TOL and scale_m_err <= K1ML_M_TOL):
            raise SystemExit(f"K1 at D={D} is not deterministic, or its tolerance would let a "
                             "fault pass")
        faults["instantiation_scale_ml_m_abs"] = scale_m_err
        del out_ref
        t = time_k1(q, k, v, tl, W, tls, sc)
        backend = sdpa_backend(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        log(f"K1 D={D}: the library yardstick ran SDPA's {backend} backend")
        del q, k, v, sc
        entry = {"name": f"flash_prefill_d{D}", "route": "cuda", "source": flash_prefill.SOURCE,
                 "replaces": flash_prefill.REPLACES, "built_as": lib, "instantiation": width,
                 "copy_bytes": flash_prefill.copy_bytes(D),
                 "library": f"scaled_dot_product_attention, causal GQA ({backend} backend)",
                 "shape": f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} w={W} true_len={tls}",
                 "max_abs_err": absd, "rel_l2": err, "tol": K1_OUT_TOL,
                 "scores_max_abs_err": err_sc, "fault_rel_l2": faults, **t,
                 "bound_fraction": t["bound_ms"] / t["ms"], "deterministic": same,
                 "edge_case": {"rel_l2": edge[0], "max_abs_err": edge[1],
                               "scores_max_abs_err": edge[2]},
                 "nan_tailed_inputs": True, "ptxas": regs.get(width)}
        if D == 100:
            entry["variants"] = k1_head_dim_variants(rng, D, Hq, Hkv)
        out[D] = entry
        torch.cuda.empty_cache()
    return out


def k2_fault_errors(q, kc, vc, kn, vn, lens, ref, width=None):
    """What K2's check sees from a kernel that drops each row's last copy
    piece (of q, the cache, k_new and v_new: zeros in its place) and from
    one that reads every row of q and the cache at its instantiation's
    width (or ``width``: the next row's first channels past D, the output's
    first D channels kept): each worst head rel L2 against the plain
    version."""
    H, G, D = q.shape
    C = kc.shape[1]
    pc = flash_prefill.copy_bytes(D) // 2
    cut = [x.clone() for x in (q, kc, vc, kn, vn)]
    for x in cut:
        x[..., D - pc:] = 0
    dropped = decode_attn.decode_attention_append_reference(*cut[:3], lens, *cut[3:])
    width = width or flash_prefill.instance(D)
    k_app, v_app = kc.clone(), vc.clone()
    L = lens.long().clamp(max=C - 1)
    heads = torch.arange(H, device=q.device)
    k_app[heads, L], v_app[heads, L] = kn, vn
    kw, vw, qw = (wide_rows(x.reshape(-1, D), width).reshape(x.shape[0], -1, width)
                  for x in (k_app, v_app, q))
    keep = torch.arange(C, device=q.device)[None] <= L[:, None]
    logits = torch.einsum("hgd,hcd->hgc", qw.float(), kw.float()) * D ** -0.5
    probs = torch.softmax(torch.where(keep[:, None], logits, NEG_INF), dim=-1)
    wide = torch.einsum("hgc,hcd->hgd", probs, vw.float())[..., :D]
    return (rel_l2(dropped.reshape(H, -1), ref.reshape(H, -1))[0],
            rel_l2(wide.reshape(H, -1), ref.reshape(H, -1))[0])


def nan_tail_bytes(x):
    """The ``NAN_TAIL`` elements after ``x``'s last one in its
    ``nan_tailed`` buffer, as 16-bit words."""
    tail = torch.empty(0, dtype=x.dtype, device=x.device)
    tail.set_(x.untyped_storage(), x.storage_offset() + x.numel(), (NAN_TAIL,))
    return tail.view(torch.int16)


def k2_append_bytes(rng, D):
    """The in-place append at head_dim D touches only the new row's 2 D
    bytes: 4 heads of C 17 whose new slots are 16 (a full cache and one a
    slot short; the last head's is the buffer's last row, with NaN after
    it), 5 and 0; every cache byte against the plain version's append, and
    the NaN words after the buffer unchanged."""
    H, C = 4, 17
    q, kc, vc, kn, vn = (bf16_normal(rng, s) for s in ((H, 1, D), (H, C, D), (H, C, D),
                                                       (H, D), (H, D)))
    lens = torch.tensor([17, 5, 0, 16], dtype=torch.int32, device="cuda")
    k1, v1 = nan_tailed(kc), nan_tailed(vc)
    tails = [nan_tail_bytes(x).clone() for x in (k1, v1)]
    k2, v2 = kc.clone(), vc.clone()
    decode_attn.decode_attention_append(q, k1, v1, lens, kn, vn)
    decode_attn.decode_attention_append_reference(q, k2, v2, lens, kn, vn)
    sync()
    same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in ((k1, k2), (v1, v2)))
    tail_same = all(torch.equal(nan_tail_bytes(x), t) for x, t in zip((k1, v1), tails))
    return same and tail_same


def phase_k2_ragged(rng, reports):
    """Phase 4h: K2 at each of ``RAGGED_HEAD_DIMS``, G 1, 4 and 12, against
    its plain version (inputs in NaN-tailed buffers; the cache after the
    append identical) on a decode layer (at 100 phase 20's fullkv decode: B
    2 x 32 heads at G 1, C 2113, 2015 / 1531 keys; elsewhere B 2 x 16 heads
    at 2079 / 1531; G 4 and 12 over 16 heads at 4159 / 1563, C 4161) and
    the edge shapes (``k2_edge_cases``), with what an off-by-one key range,
    a dropped split, 1/sqrt(width), a row's tail piece dropped and a row
    read at the instantiation's width would show (each must fail the
    limit); the append's neighbour rows and the bytes after the buffer byte
    for byte; at 100 bitwise repeats, graph replays and the split-rule
    edges; the G 1 decode timed beside its plain version, SDPA and its
    bound (at 100 also phase 20's snapkv decode, 1055 keys a head in C
    1089)."""
    out = {}
    for D in RAGGED_HEAD_DIMS:
        width, lib = flash_prefill.instance(D), decode_attn.library(D)
        regs = registers_by_head_dim(reports, lib, "decode_attn_kernel")
        Hq = OPENLLAMA_HEADS[0] if D == 100 else 16
        C, H = 2113, 2 * Hq
        first = OPENLLAMA_PROMPTS[0] + 31 if D == 100 else 2048 + 31
        lens = [first] * Hq + [1500 + 31] * Hq
        q, kc, vc, kn, vn, lt, _, ref, err, absd = k2_case(rng, H, 1, C, lens,
                                                            np.zeros(H, np.int64), D, tail=True)
        off_err = k2_one_key_off_error(q, kc, vc, kn, vn, lt, ref)
        drop_err, n_split = k2_dropped_split_error(q, kc, vc, kn, vn, lt, ref)
        with instantiation_scale(lib):
            wrong = decode_attn.decode_attention_append(q, kc.clone(), vc.clone(), lt, kn, vn)
        sync()
        scale_err = rel_l2(wrong.reshape(H, -1), ref.reshape(H, -1))[0]
        tail_err, wide_err = k2_fault_errors(q, kc, vc, kn, vn, lt, ref)
        faults = {"off_by_one": off_err, "dropped_split": drop_err,
                  "instantiation_scale": scale_err, "tail_piece_dropped": tail_err,
                  "row_read_at_width": wide_err}
        C4 = 4096 + 64 + 1
        by_g = {G: k2_case(rng, 16, G, C4, [4096 + 63] * 8 + [1500 + 63] * 8,
                           np.zeros(16, np.int64), D, tail=True)[8] for G in (4, 12)}
        edges = {G: k2_edge_cases(rng, D, G) for G in (1, 4, 12)}
        append_ok = k2_append_bytes(rng, D)
        required = dict(faults)
        if abs(1 - (D / width) ** 0.5) < SCALE_VISIBLE:
            del required["instantiation_scale"]  # below what the limit can see
        log(f"K2 D={D} ({lib}, instantiation {width}): G 4 / 12 head rel L2 {by_g[4]:.3e} / "
            f"{by_g[12]:.3e}, edge shapes {max(edges.values()):.3e}; append byte for byte "
            f"(neighbour rows, the bytes after the buffer) {append_ok}; a fault would show "
            f"{({n: f'{e:.3e}' for n, e in faults.items()})} (tol {K2_OUT_TOL}; required to "
            f"fail it: {sorted(required)}); ptxas (registers, spill) "
            f"{sorted(set(regs.get(width, [])))}")
        if min(required.values()) <= K2_OUT_TOL or not append_ok:
            raise SystemExit(f"K2 at D={D} touched bytes past its row, or its tolerance would "
                             "let a fault pass")
        entry = {"name": f"decode_attn_append_d{D}", "route": "cuda",
                 "source": decode_attn.SOURCE, "replaces": decode_attn.REPLACES,
                 "built_as": lib, "instantiation": width,
                 "copy_bytes": flash_prefill.copy_bytes(D),
                 "shape": f"H={H} (B=2 x {Hq}) G=1 C={C} D={D}, lengths {first} and 1531",
                 "max_abs_err": absd, "rel_l2": err, "tol": K2_OUT_TOL,
                 "g4_rel_l2": by_g[4], "g12_rel_l2": by_g[12], "edges_rel_l2": edges,
                 "fault_rel_l2": faults, "n_split": n_split, "append_bytes_identical": append_ok,
                 "nan_tailed_inputs": True, "ptxas": regs.get(width)}
        if D == 100:
            entry.update(k2_repeat_and_replay(q, kc, vc, kn, vn, lt))
            entry.update(k2_split_edges(rng, D))
        entry.update(time_k2(q, kc, vc, kn, vn, lt))
        mask = (torch.arange(C, device="cuda")[None] <= lt[:, None].long())[None, :, None]
        backend = sdpa_backend(lambda: F.scaled_dot_product_attention(
            q[None], kc[None], vc[None], attn_mask=mask))
        log(f"K2 D={D}: the library yardstick ran SDPA's {backend} backend")
        entry["library"] = (f"scaled_dot_product_attention with a boolean cache mask "
                            f"({backend} backend)")
        del q, kc, vc, ref
        if D == 100:  # phase 20's snapkv decode: 1024 kept + 31 new keys a head, C 1089
            Cs = 1024 + 64 + 1
            q, kc, vc, kn, vn, lt, _, ref, err_s, abs_s = k2_case(
                rng, H, 1, Cs, [1024 + 31] * H, np.zeros(H, np.int64), D, tail=True)
            entry["snapkv"] = {"shape": f"H={H} (B=2 x {Hq}) G=1 C={Cs} D={D}, lengths 1055",
                               "rel_l2": err_s, "max_abs_err": abs_s,
                               **time_k2(q, kc, vc, kn, vn, lt)}
            del q, kc, vc, ref
        out[D] = entry
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 3f and 4e: K1 at observation windows above 64, K2-K4 at G above 8
# ---------------------------------------------------------------------------

# Phase 3f's windows, and the edge cases beside them: (B, Hq, Hkv, S, W,
# true_len) with a window whose rows cross a 128-row CTA edge (rows 928-1055
# and 1872-1999), a true_len shorter than the window, and W 65 (one row past
# the first 64-row block of the score pass).
K1_WINDOWS = (96, 128)
K1_WINDOW_EDGES = ((2, 8, 2, 2048, 128, [1056, 2000]), (2, 8, 2, 1024, 96, [1000, 100]),
                   (2, 8, 2, 1024, 128, [60, 1000]), (1, 8, 2, 1024, 65, [1024]))


def k1_cut_window_error(q, k, v, tl, W, tls, sc):
    """What K1's score check sees from a window-score pass cut at 64 window
    rows (the first 64 of W): its scores lack the last W - 64 rows, which
    are the plain version's scores at window W - 64 on the columns scored."""
    _, missing = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, W - 64)
    return max(missing[b, :, :t - W].abs().max().item() for b, t in enumerate(tls) if t > W)


def phase_k1_windows(rng):
    """Phase 3f: K1 at observation windows 96 and 128 (B 2, Hq 32 / Hkv 8,
    S 4096, true_len 4096 / 3000) against its plain version, scores too,
    with the edge cases of ``K1_WINDOW_EDGES``, two launches bitwise equal,
    what a score pass cut at 64 window rows would show, and the score pass
    timed alone beside the main pass and the bound."""
    B, Hq, Hkv, S, D, tls = 2, 32, 8, 4096, 128, [4096, 3000]
    edges = [k1_case(rng, *case)[6:9] for case in K1_WINDOW_EDGES]
    out = {}
    for W in K1_WINDOWS:
        q, k, v, tl, sc, out_ref, err, absd, err_sc = k1_case(rng, B, Hq, Hkv, S, W, tls)
        del out_ref
        call = lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, W)  # noqa: E731
        same = bitwise_repeat(call)
        cut_err = k1_cut_window_error(q, k, v, tl, W, tls, sc)
        log(f"K1 W={W}: two launches bitwise equal {same}; a score pass cut at 64 window rows "
            f"would show scores max abs err {cut_err:.3e} ({cut_err / K1_SCORE_TOL:.0f} x tol)")
        if not same or cut_err <= K1_SCORE_TOL:
            raise SystemExit(f"K1 at W={W} is not deterministic, or its score tolerance would "
                             "let a cut window pass")
        t = time_k1(q, k, v, tl, W, tls, sc)
        passes = k1_pass_ms(call)
        # The score pass by CUDA events too (late in a long process the
        # profiler can miss launches): K1 at window 0 runs the main pass
        # alone.
        main_ms = event_ms(lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, 0))
        # The score pass alone recomputes the window rows' logits: 2 D FLOP
        # a visible (window row, column) pair, at the tensor cores' rate.
        pairs = sum(sum(r + 1 for r in range(max(t_ - W, 0), t_)) for t_ in tls) * Hq
        score_bound_ms = 2 * D * pairs / PEAK_BF16_FLOPS * 1e3
        # K1 at a window runs both passes: its bound is the sum of theirs.
        main_bound_ms = t["bound_ms"]
        t["bound_ms"] = main_bound_ms + score_bound_ms
        log(f"K1 W={W}: main pass {passes['flash_fwd_kernel']} ms, window-score pass "
            f"{score_pass_ms(passes)} ms (profiled); by events, K1 at window 0 (the "
            f"main pass alone) {main_ms:.4f} ms, so the score pass {t['ms'] - main_ms:.4f} ms; "
            f"the bound {t['bound_ms']:.4f} ms (operations): main pass {main_bound_ms:.4f}, "
            f"score pass {score_bound_ms:.4f}")
        del q, k, v, sc
        out[W] = {"name": f"flash_prefill_w{W}", "route": "cuda", "source": flash_prefill.SOURCE,
                  "replaces": flash_prefill.REPLACES,
                  "shape": f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} w={W} true_len={tls}",
                  "max_abs_err": absd, "rel_l2": err, "tol": K1_OUT_TOL,
                  "scores_max_abs_err": err_sc, "scores_tol": K1_SCORE_TOL,
                  "cut_at_64_rows_scores_err": cut_err, "deterministic": same, **t,
                  "main_pass_ms": passes["flash_fwd_kernel"],
                  "score_pass_ms": score_pass_ms(passes),
                  "window_0_ms": main_ms, "score_pass_by_events_ms": t["ms"] - main_ms,
                  "main_pass_bound_ms": main_bound_ms, "score_pass_bound_ms": score_bound_ms,
                  "edge_cases": [{"case": f"B={c[0]} Hq={c[1]} S={c[3]} w={c[4]} true_len={c[5]}",
                                  "rel_l2": e, "max_abs_err": a, "scores_max_abs_err": s_}
                                 for c, (e, a, s_) in zip(K1_WINDOW_EDGES, edges)]}
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 3j: K1's window-score pass (csrc/window_scores.cuh)
# ---------------------------------------------------------------------------

# Cases held to the plain version at D 128 beside phases 3 and 3f's: (name,
# B, Hq, Hkv, S, W, true_len, sparse pattern).  Windows of 1 (4 heads of one
# row in a 32-row block), 32 (4 heads of 32 rows) and 200 rows (a chunk of
# 200 rows, one head a CTA); G 12 and 16 at W 128 (one head a CTA: 12 and 16
# CTAs a KV head and tile); true_len 1 beside a window across a 64-key tile
# (rows 1020-1027); true_len below the window; an a-shape mask of 64-row
# blocks.
SCORE_CASES = (
    ("w1", 2, 32, 8, 4096, 1, [4096, 3000], None),
    ("w32", 2, 32, 8, 4096, 32, [4096, 3000], None),
    ("w200", 2, 32, 8, 4096, 200, [4096, 3000], None),
    ("g12_w128", 2, 96, 8, 2048, 128, [2048, 1500], None),
    ("g16_w128", 2, 128, 8, 2048, 128, [2048, 1500], None),
    ("tl1_and_tile_edge_w8", 2, 32, 8, 2048, 8, [1, 1028], None),
    ("tl_below_w32", 2, 32, 8, 2048, 32, [20, 2048], None),
    ("ashape_w8", 2, 32, 8, 4096, 8, [4096, 3000], ("ashape", 1, 2, 4)),
)
# The pass timed alone: (name, Hq, Hkv, D, W) at B 2, S 4096, true_len (4096,
# 3000): the main path's heads at W 8, 32 (the JAX package's default window)
# and 128, and phase 21's heads at D 1024 and at 514 (4-byte pieces).
SCORE_TIMED = (("d128_w8", 32, 8, 128, 8), ("d128_w32", 32, 8, 128, 32),
               ("d128_w128", 32, 8, 128, 128), ("d1024_w128", 4, 1, 1024, 128),
               ("d514_w128", 4, 1, 514, 128))


def score_fault_errors(q, k, v, tl, W, tls, sc_ref):
    """What the score check sees from two faulty passes, from the plain
    versions: one that drops the last window row (it lacks that row's
    probabilities: the plain scores at window 1) and one that pairs each
    query head with the next KV head (the right (m, l), the next head's
    keys)."""
    _, last = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, 1)
    _, _, m, l = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, 0, return_ml=True)
    shifted = flash_prefill.window_scores_reference(q, k.roll(-1, dims=1), tl, W, m, l)
    scored = [(b, t) for b, t in enumerate(tls) if t > W]
    return {"last_row_dropped": max(last[b, :, :t - W].abs().max().item() for b, t in scored),
            "next_kv_head": max((shifted[b, :, :t - W] - sc_ref[b, :, :t - W]).abs().max().item()
                                for b, t in scored)}


def time_score_pass(q, k, v, tl, W, tls):
    """The window-score pass alone (profiler rows), its plain version and
    the composite ``torch.matmul`` (bf16) + ``exp`` + ``sum`` (for
    information: no single call emits these scores) on the same (m, l), and
    its bound: 2 D FLOP a visible (window row, column) pair, or the bytes of
    K's causal rows once per KV head, the window's q rows, (m, l) and the
    fp32 scores, whichever takes longer."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    main = "flash_fwd_kernel" if D <= flash_prefill.INSTANCES[-1] else "flash_cluster_kernel"
    ms = score_pass_ms(k1_pass_ms(lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, W),
                                  names=(main, flash_prefill.SCORE_KERNEL)))
    _, _, m, l = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, 0, return_ml=True)
    plain_ms = event_ms(lambda: flash_prefill.window_scores_reference(q, k, tl, W, m, l),
                        iters=3, warmup=1)
    rows = tl.long()[:, None] - W + torch.arange(W, device="cuda")            # [B, W]
    at = rows.clamp(min=0)
    qw = torch.gather(q, 2, at[:, None, :, None].expand(B, Hq, W, D)).reshape(B, Hkv, -1, D)
    mw, lw = (torch.gather(x, 2, at[:, None].expand(B, Hq, W)).reshape(B, Hkv, -1, 1)
              for x in (m, l))
    keep = ((torch.arange(S, device="cuda")[None, None] <= rows[:, :, None]) & (rows >= 0)[..., None])
    keep = keep[:, None].expand(B, Hq, W, S).reshape(B, Hkv, -1, S)
    scale = D ** -0.5

    def composite():
        p = torch.exp(torch.matmul(qw, k.transpose(-1, -2)).float() * scale - mw) / lw
        return torch.where(keep, p, 0.0).reshape(B, Hq, W, S).sum(dim=2)
    composite_ms = event_ms(composite, iters=5, warmup=1)
    pairs = Hq * sum(sum(r + 1 for r in range(max(t - W, 0), t)) for t in tls)
    nbytes = sum(2 * (t * Hkv + min(W, t) * Hq) * D + 8 * Hq * W for t in tls) + 4 * B * Hq * S
    bound_ms, bound_by = max((2 * D * pairs / PEAK_BF16_FLOPS * 1e3, "operations"),
                             (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    log(f"K1 window-score pass B={B} Hq={Hq} Hkv={Hkv} D={D} w={W}: {ms:.4f} ms (profiled), "
        f"plain {plain_ms:.4f} ms, composite matmul + exp + sum {composite_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}): {bound_ms / ms:.3f} of it")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "composite_ms": composite_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_fraction": bound_ms / ms}


def phase_k1_score_pass(rng, reports):
    """Phase 3j: K1's window-score pass (``csrc/window_scores.cuh``), one
    tensor-core kernel for every head_dim and copy width.  Its registers and
    spills in each K1 library (none may spill); the cases of
    ``SCORE_CASES`` against the plain version on every column below
    true_len; what a pass that drops the last window row or pairs each query
    head with the next KV head would show (each must fail
    ``K1_SCORE_TOL``); two launches bitwise equal at D 128 / W 128, D 100 /
    W 8 and D 1024 / W 128; the pass timed alone at ``SCORE_TIMED`` beside
    its plain version, the composite and its bound."""
    regs = {}
    for lib in ("flash_prefill", "flash_prefill_p8", "flash_prefill_p4", "flash_prefill_wide"):
        rows = ptxas_entries(reports.get(lib, ""), flash_prefill.SCORE_KERNEL)
        regs[lib] = sorted({(r, sp or "no spill line") for _, r, sp in rows})
        if any("0 bytes spill stores, 0 bytes spill loads" not in (sp or "") for _, _, sp in rows):
            raise SystemExit(f"the window-score pass spills registers in {lib}")
    log(f"K1 window-score pass ptxas (registers, spill) by library: {regs}")
    cases = {}
    for name, B, Hq, Hkv, S, W, tls, pattern in SCORE_CASES:
        cases[name] = dict(zip(("rel_l2", "max_abs_err", "scores_max_abs_err"),
                               k1_case(rng, B, Hq, Hkv, S, W, tls, pattern=pattern)[6:9]))
    worst = max(c["scores_max_abs_err"] for c in cases.values())
    timed_out, same, faults = {}, {}, None
    tls = [4096, 3000]
    for name, Hq, Hkv, D, W in SCORE_TIMED:
        q, k, v, tl, sc, out_ref, _, _, err_sc = k1_case(rng, 2, Hq, Hkv, 4096, W, tls, D)
        del out_ref
        worst = max(worst, err_sc)
        if name in ("d128_w128", "d1024_w128"):
            same[name] = bitwise_repeat(lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, W))
        if name == "d128_w128":
            _, sc_plain = flash_prefill.flash_prefill_attention_reference(q, k, v, tl, W)
            faults = score_fault_errors(q, k, v, tl, W, tls, sc_plain)
            del sc_plain
        timed_out[name] = time_score_pass(q, k, v, tl, W, tls)
        del q, k, v, sc
        torch.cuda.empty_cache()
    q, k, v, tl = k1_case(rng, 2, 32, 8, 2048, 8, [2048, 1500], 100)[:4]
    same["d100_w8"] = bitwise_repeat(lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, 8))
    del q, k, v
    log(f"K1 window-score pass: two launches bitwise equal {same}; a pass that drops the last "
        f"window row / pairs each query head with the next KV head would show {faults} "
        f"(tol {K1_SCORE_TOL})")
    if not all(same.values()) or min(faults.values()) <= K1_SCORE_TOL:
        raise SystemExit("K1's window-score pass is not deterministic, or its tolerance would "
                         "let a fault pass")
    main = timed_out["d128_w8"]
    return {"name": "window_scores", "route": "cuda", "source": flash_prefill.SCORE_SOURCE,
            "replaces": flash_prefill.REPLACES_SCORES, "kernel": flash_prefill.SCORE_KERNEL,
            "shape": "B=2 Hq=32 Hkv=8 S=4096 D=128 w=8 true_len=[4096, 3000]",
            "max_abs_err": worst, "tol": K1_SCORE_TOL,
            "library": "none (no single call emits these scores)", **main,
            "timed": timed_out, "cases": cases, "faults": faults, "deterministic": same,
            "ptxas": regs}


# Phase 4e's group sizes: G 12 is Mistral-Large-Instruct-2407's (96 / 8
# heads), G 16 Llama-3.1-405B-Instruct's (128 / 8), G 9 a short second
# block.  Each at a fullkv decode of phase 5's requests over 8 KV heads:
# B 2 x 8 heads at 4159 / 1563 keys, C 4161.
BIG_GROUPS = (9, 12, 16)
BIG_G_C = 4096 + 64 + 1
BIG_G_LENS = [4096 + 63] * 8 + [1500 + 63] * 8


def big_group_edges(case, n8, C):
    """8 heads around their split count (shorter than, equal to and one
    past it), a full head and a window lower bound mid-tile."""
    return case([n8 - 13, 0, n8 - 1, n8, n8 + 1, C, C - 1, 1000], [0, 0, 0, 0, 1, 0, 0, 993])


def phase_big_groups(rng, reports):
    """Phase 4e: K2, K3 and K4 at G 9, 12 and 16 (D 128) against their plain
    versions: off-by-one and dropped-split sensitivity, split edges, two
    launches bitwise equal and 20 CUDA-graph replays with every counter back
    at 0; K3 / K4 also the range case and appends byte for byte; each timed
    beside its plain version, its bound and SDPA with a boolean cache mask
    (K2) or the dequantize + SDPA composite (K3 / K4); the ptxas registers
    and spills of every instantiation."""
    D, H, C = 128, 16, BIG_G_C
    zeros = np.zeros(H, np.int64)
    found = {"K2": registers_by_head_dim(reports, "decode_attn", "decode_attn_kernel")}
    for kid, name in QUANT_KERNELS.items():
        found[kid] = registers_by_head_dim(reports, "decode_attn_quant", name)
    # Each head_dim's registers over its GB 1-8 instantiations (GB 8 serves
    # every G above 8), and whether none spills.
    ptxas = {kid: {D: {"registers": sorted({r for r, _ in rows}),
                       "spill_free": all("0 bytes spill stores, 0 bytes spill loads" in (line or "")
                                         for _, line in rows)}
                   for D, rows in by_d.items()} for kid, by_d in found.items()}
    log(f"4e ptxas by head_dim (empty where the libraries were cached): {ptxas}")
    out = {"K2": {}, "K3": {}, "K4": {}}
    for G in BIG_GROUPS:
        q, kc, vc, kn, vn, lens, _, ref, err, absd = k2_case(rng, H, G, C, BIG_G_LENS, zeros)
        off_err = k2_one_key_off_error(q, kc, vc, kn, vn, lens, ref)
        drop_err, n_split = k2_dropped_split_error(q, kc, vc, kn, vn, lens, ref)
        n8 = k2_splits(8, C, D, G)
        edge = big_group_edges(lambda ln, lo: k2_case(rng, 8, G, C, ln, lo)[8], n8, C)
        log(f"K2 G={G}: off by one {off_err:.3e}, dropped split (1 of {n_split}) "
            f"{drop_err:.3e}, split edges {edge:.3e} (tol {K2_OUT_TOL})")
        if min(off_err, drop_err) <= K2_OUT_TOL:
            raise SystemExit(f"K2's tolerance at G={G} would let an off-by-one or dropped split "
                             "pass")
        checks = k2_repeat_and_replay(q, kc, vc, kn, vn, lens)
        out["K2"][G] = {"name": f"decode_attn_append_g{G}", "route": "cuda",
                        "source": decode_attn.SOURCE, "replaces": decode_attn.REPLACES,
                        "shape": f"H={H} (B=2 x 8) G={G} C={C} D={D}, lengths 4159 and 1563",
                        "max_abs_err": absd, "rel_l2": max(err, edge), "tol": K2_OUT_TOL,
                        "off_by_one_rel_l2": off_err, "dropped_split_rel_l2": drop_err,
                        "n_split": n_split, "query_blocks": decode_attn.query_blocks(G),
                        **checks, **time_k2(q, kc, vc, kn, vn, lens)}
        del q, kc, vc, ref
        for nbits in (8, 4):
            kid = QUANT[nbits][0]
            q, kc, vc, sc, kn, vn, lens, ref, err, absd = kq_case(rng, nbits, H, G, C, BIG_G_LENS,
                                                                  zeros)
            off_err = kq_one_key_off_error(nbits, q, kc, vc, sc, kn, vn, lens, ref)
            drop_err, n_split = kq_dropped_split_error(nbits, q, kc, vc, sc, kn, vn, lens, ref)
            n8 = decode_attn.split_count(8 * decode_attn.query_blocks(G), C,
                                         decode_attn._sm_count(q.device))
            edge = big_group_edges(lambda ln, lo: kq_case(rng, nbits, 8, G, C, ln, lo)[8], n8, C)
            rng_err = kq_case(rng, nbits, H, G, C, BIG_G_LENS, zeros, KQ_RANGE)[8]
            log(f"{kid} G={G}: off by one {off_err:.3e}, dropped split (1 of {n_split}) "
                f"{drop_err:.3e}, split edges {edge:.3e}, range case {rng_err:.3e} (tol "
                f"{KQ_OUT_TOL})")
            if min(off_err, drop_err) <= KQ_OUT_TOL:
                raise SystemExit(f"{kid}'s tolerance at G={G} would let an off-by-one or dropped "
                                 "split pass")
            checks = kq_repeat_and_replay(nbits, q, kc, vc, sc, kn, vn, lens)
            out[kid][G] = {"name": f"quant{nbits}_decode_attn_append_g{G}", "route": "cuda",
                           "source": decode_attn_quant.SOURCE,
                           "replaces": decode_attn_quant.REPLACES[nbits],
                           "shape": f"H={H} (B=2 x 8) G={G} C={C} D={D} int{nbits}, lengths "
                                    "4159 and 1563",
                           "max_abs_err": absd, "rel_l2": max(err, edge), "tol": KQ_OUT_TOL,
                           "off_by_one_rel_l2": off_err, "dropped_split_rel_l2": drop_err,
                           "range_rel_l2": rng_err, "n_split": n_split,
                           "append_bit_identical": True, **checks,
                           **time_kq(nbits, q, kc, vc, sc, kn, vn, lens)}
            del q, kc, vc, sc, ref
        torch.cuda.empty_cache()
    out["ptxas"] = ptxas
    return out


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
    cfg, dev = MISTRAL_7B_16, "cuda"
    t0 = time.perf_counter()
    params = first_layers(init_params(MISTRAL_7B, seed=0, device=dev), SHARED_LAYERS)
    sync()
    n_params = sum(t.numel() for t in [params["embed"], params["final_norm"], params["lm_head"]]
                   + list(params["layers"].values()))
    log(f"init_params: {n_params / 1e9:.3f} B parameters ({SHARED_LAYERS} of 32 layers) in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (4096, 1500)]
    return params, prompts, {label: drive_path(params, n_params, prompts, quant, log_file,
                                               cfg=cfg, model=MAIN_MODEL)
                             for label, quant in PATHS}


def drive_path(params, n_params, prompts, quant, log_file, cfg=MISTRAL_7B, comp=SNAPKV,
               model="Mistral-7B-Instruct-v0.2 widths, random weights (seed 0)",
               direct_rng=None, capacity=None):
    """One ``generate_batch`` of the two requests with the bf16 cache
    (``quant`` None) or a per-token quantized one (of ``capacity`` slots,
    phase 5's by default), checked and timed; with ``direct_rng``, K2 (K3,
    K4) is also called directly on the finished cache's first and last
    layer against its plain version, with as many query rows a cache head
    as the cache's heads give (G 1 for a cache per query head)."""
    dev = "cuda"
    L = cfg.num_hidden_layers
    label = "bf16" if quant is None else f"int{quant.nbits}"
    decode_id = "K2" if quant is None else QUANT[quant.nbits][0]
    log(f"== {model.split(',')[0]}, {comp.method}, {label} cache")
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=comp, quant=quant),
                             device=dev)
    max_new = 64

    for wrapper in COUNTED.values():
        wrapper.launches = 0
    flash_prefill.flash_prefill_attention.score_launches = 0
    ids, res = engine.generate_batch(prompts, max_new, return_result=True)
    sync()
    launches = {kid: wrapper.launches for kid, wrapper in COUNTED.items()}
    score_launches = flash_prefill.flash_prefill_attention.score_launches
    steps = max_new - 1  # the last token is emitted, never fed back
    expect = dict.fromkeys(COUNTED, 0)
    expect["K1"], expect[decode_id] = L, L * steps
    # K1's window-score pass runs with each K1 launch of a method that reuses
    # its scores (none under a sliding window: models/llama.py::attend_prefill).
    want_scores = L if comp.method in SCORE_EMITTERS and cfg.sliding_window is None else 0
    log(f"launches on the main path ({label}): {launches}, window-score passes "
        f"{score_launches}; expect K1 {L}, {decode_id} {L} x {steps} = {L * steps}, "
        f"window-score passes {want_scores}, the others 0")
    if launches != expect or score_launches != want_scores:
        raise SystemExit("the main path did not run each kernel the expected number of times")
    if quant is not None:
        cls = quant_cache.Int8KVCache if quant.nbits == 8 else quant_cache.Int4KVCache
        C = capacity or QUANT[quant.nbits][3]
        log(f"cache: {type(res.cache).__name__}, capacity {res.cache.capacity} "
            f"(expect {cls.__name__}, {C})")
        if not isinstance(res.cache, cls) or res.cache.capacity != C:
            raise SystemExit("the engine built the wrong cache")
    lens = res.cache.lengths
    keep = (lambda n: n) if comp.method == "fullkv" else \
        (lambda n: min(n, comp.max_capacity_prompt))
    want = [keep(len(p)) + steps for p in prompts]
    got = [sorted(set(lens[:, b].flatten().tolist())) for b in range(2)]
    log(f"cache lengths per request: {got} (expect {want})")
    if got != [[w] for w in want] or [len(x) for x in ids] != [max_new, max_new]:
        raise SystemExit("cache lengths or token counts are wrong")
    if not torch.isfinite(res.logits).all():
        raise SystemExit("non-finite logits")

    # Hold the path to the fp32 reference forward.  Quantization leaves
    # prefill alone, so the quantized paths check request (a)'s prefill
    # logits no further.  A policy that compresses request (b) changes what
    # its decode attends, which the reference forward does not: its decode
    # logits are held to the same steps over the same compressed cache with
    # K2's plain version in K2's place (``compressed_decode_logits``).
    decode_tol = E2E_REL_L2_TOL if quant is None else E2E_QUANT_REL_L2_TOL[quant.nbits]
    compressed_b = comp.method != "fullkv" and len(prompts[1]) > comp.max_capacity_prompt
    with torch.no_grad():
        ref_a = None if quant is not None else \
            forward_logits(params, cfg, torch.tensor([prompts[0]], device=dev))[0, -1]
        seq_b = prompts[1] + ids[1][:steps]
        ref_b = forward_logits(params, cfg, torch.tensor([seq_b], device=dev))[0, len(prompts[1]) - 1:]
        if compressed_b:
            ref_b[1:] = compressed_decode_logits(engine, params, cfg, comp, prompts, ids,
                                                 steps, max_new)[1]
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
    log(f"(b) decode logits vs {'its compressed cache with plain K2' if compressed_b else 'fp32 reference'}, "
        f"{steps} teacher-forced steps: worst rel L2 "
        f"{rel_bd:.4f}, max abs {abs_bd:.4f}, tol {decode_tol}; greedy top-1 agreement "
        f"{top1:.3f}")
    if max(rel_b0, rel_a or 0.0) > E2E_REL_L2_TOL or rel_bd > decode_tol:
        raise SystemExit("logits disagree with the fp32 reference")
    del ref_a, ref_b
    G = cfg.num_attention_heads // lens.shape[-1]  # query rows a cache head
    direct = None if direct_rng is None else \
        direct_decode_check(direct_rng, res.cache, quant, f"{comp.method} {label}", G)

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
    log(f"prefill {prefill_s:.3f} s for B=2 ({len(prompts[0])} + {len(prompts[1])} tokens); decode "
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
            lambda rows: one_kernel_a_layer(rows, L, *(
                ONE_LAUNCH_DECODE_WIDE if cfg.head_dim > 512 else ONE_LAUNCH_DECODE)[label]))
    return {"model": model, "score_launches": score_launches,
            "compression": "snapkv 2048/8/7 maxpool, group_reduce none" if comp is SNAPKV
                           else f"{comp.method} {comp.max_capacity_prompt}/{comp.window_size}, "
                                f"group_reduce {comp.group_reduce}",
            "decode_g": G,
            "cache": label if quant is None else f"{label} per token, capacity "
                                                 f"{res.cache.capacity}",
            "requests": f"B=2: {len(prompts[0])} and {len(prompts[1])} prompt tokens, "
                        f"{max_new} new tokens, bucket {engine_bucket(engine, prompts)}",
            "launches": launches, "lengths": got, "tokens": ids,
            "prefill_s": prefill_s, "prefill_device_busy_ms": pre_busy,
            "decode_ms_per_step": step_ms,
            "tok_s": 2e3 / step_ms, "bound_ms_per_step": bound_step_ms,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": None if busy_ms is None else 1 - busy_ms / step_ms,
            "prefill_rel_l2": [rel_a, rel_b0], "decode_rel_l2": rel_bd,
            "decode_reference": ("the compressed cache, K2's plain version" if compressed_b
                                 else "fp32 forward"),
            "rel_l2_tol": E2E_REL_L2_TOL, "decode_rel_l2_tol": decode_tol,
            "decode_top1_agreement": top1, "direct_rel_l2": direct,
            "weight_bytes": weight_bytes, "cache_bytes": cache_bytes}


def compressed_decode_logits(engine, params, cfg, comp, prompts, ids, steps, max_new):
    """The decode logits [B, steps, V] of the bf16 path over the cache that
    ``comp`` compressed, teacher-forced with the run's tokens ``ids``, with
    K2's plain version in place of K2: the same prefill (K1, the policy)
    and capacity as the engine's run, then ``steps`` decode steps."""
    dev = params["embed"].device
    S = engine_bucket(engine, prompts)
    toks = torch.zeros((len(prompts), S), dtype=torch.long, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, device=dev)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    cache = llama.prefill(params, cfg, engine._comp_for_bucket(S), toks, lens,
                          engine._cache_capacity(S, max_new)).cache
    real = llama.decode_attention_append
    llama.decode_attention_append = decode_attn.decode_attention_append_reference
    out = []
    try:
        for i in range(steps):
            tok = torch.tensor([x[i] for x in ids], device=dev)
            logits, cache = llama.decode_step(params, cfg, tok, cache)
            out.append(logits.float())
    finally:
        llama.decode_attention_append = real
    del cache
    return torch.stack(out, dim=1)


def engine_bucket(engine, prompts):
    """The prefill bucket ``engine`` pads ``prompts`` to."""
    return next(b for b in engine.buckets if b >= max(len(p) for p in prompts))


# The one-launch decode kernels, by cache: (id, a part of the kernel's name).
ONE_LAUNCH_DECODE = {"bf16": ("K2", "decode_attn_kernel"), "int8": ("K3", "quant8_decode_kernel"),
                     "int4": ("K4", "quant4_decode_kernel")}
# Above head_dim 512 K2 and K4 run the wide kernel, told apart by its first
# template argument (the cache's bits); K3 up to 2048 its cluster kernel
# (phase 21's 1024).
ONE_LAUNCH_DECODE_WIDE = {"bf16": ("K2", "decode_wide_kernel<16,"),
                          "int8": ("K3", "quant8_cluster_kernel<"),
                          "int4": ("K4", "decode_wide_kernel<4,")}


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


def direct_decode_check(rng, cache, quant, label, G=1):
    """K2 (K3, K4 on the int8, int4 cache) and its plain version, called
    directly on a copy of the first and last layers of a finished cache with
    a random query of ``G`` rows a cache head: the ragged per-head lengths
    of a real policy.  Returns the worst head's rel L2 and max abs
    difference."""
    dev = cache.lengths.device
    D = cache.k.shape[-1] if quant is None else cache.k_codes.shape[-1] * 8 // quant.nbits
    dtype = cache.k.dtype if quant is None else torch.bfloat16
    worst = (0.0, 0.0)
    for li in (0, cache.lengths.shape[0] - 1):
        B, H = cache.lengths.shape[1:]
        lens = cache.lengths[li].reshape(B * H).contiguous()
        q, kn, vn = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, dtype)
                     for shape in ((B * H, G, D), (B * H, D), (B * H, D)))
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
        log(f"  {label}: {kid} (G {G}) called directly on layer {li}'s cache (lengths "
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
    cfg, dev = MISTRAL_7B_16, params["embed"].device
    L, H = cfg.num_hidden_layers, cfg.num_attention_heads
    method, steps = comp.method, POLICY_NEW - 1
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=comp, quant=quant),
                             device=dev, head_capacity=head_cap if method == "headkv" else None)
    reset_counts()
    flash_prefill.flash_prefill_attention.score_launches = 0
    with score_window_hook() as windows:
        ids, res = engine.generate_batch(prompts, POLICY_NEW, return_result=True)
        sync()
    launches = path_launches()
    score_launches = flash_prefill.flash_prefill_attention.score_launches
    decode_id = "K2" if quant is None else QUANT[quant.nbits][0]
    expect = dict.fromkeys(launches, 0)
    expect["K1"], expect[decode_id] = L, L * steps
    emitted = sorted(set(windows))
    want_window = comp.window_size if method in SCORE_EMITTERS else 0
    log(f"== policy {label}: launches {launches} (expect K1 {L}, {decode_id} {L * steps}); "
        f"K1 score windows {emitted} (expect [{want_window}]); window-score passes "
        f"{score_launches} (expect {L if want_window else 0})")
    if launches != expect or score_launches != (L if want_window else 0):
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
    head_cap = headkv_file(LOG_PATH.parent / "policies" / "heads.json", MISTRAL_7B_16)
    bound = dataclasses.replace(SNAPKV, method="headkv").layer_capacity(
        MISTRAL_7B_16.num_hidden_layers, len(prompts[0])) - SNAPKV.window_size
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
    cfg, L = MISTRAL_7B_V01_16, MISTRAL_7B_V01_16.num_hidden_layers
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
    cfg = MISTRAL_7B_V01_16
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
    cfg, L = MISTRAL_7B_16, MISTRAL_7B_16.num_hidden_layers
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
    cfg = MISTRAL_7B_16
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


def sp_rank(rank, n, directory):
    """One rank of the sp run (a spawned process): the phase-5 weights from
    ``init_params`` (seed 0), then ``InferenceEngine(ShardingConfig(sp=n))``
    on the prompt in ``directory/prompt.pt`` with every launch count set to
    0 just before it and read just after; then prefill and the whole
    request timed, and one profiled prefill.  Writes its results to
    ``directory/rank{rank}.pt``."""
    prompt = torch.load(Path(directory) / "prompt.pt")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Gloo's pairs over the loopback device: the ranks share one host.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=SP_TIMEOUT_S))
    try:
        cfg = MISTRAL_7B_16
        params = first_layers(init_params(MISTRAL_7B, seed=0, device="cuda"), SHARED_LAYERS)
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
    cfg, L = MISTRAL_7B_16, MISTRAL_7B_16.num_hidden_layers
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
    # By file: an argument past the pipe's buffer would hold each spawn
    # until its child has imported this script.
    torch.save(prompt, SP_DIR / "prompt.pt")
    ctx = torch.multiprocessing.start_processes(sp_rank, args=(SP, str(SP_DIR)),
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
# Phase 12: tp, dp and (sp, tp) on the card
# ---------------------------------------------------------------------------

GRID_DIR = LOG_PATH.parent / "grid"
GRID_TIMEOUT_S = 900
# Phases 12 and 13 run Mistral-7B-Instruct-v0.2's widths at 16 of its 32
# layers since phases 17 and 18 joined the script (PERF.md §6: the
# script at 1305 s through phase 17 on a card whose common phases ran 25%
# slower than P17-4's), to keep it inside its time limit: the ranks' checks
# count launches per layer and hold the logits to the fp32 reference and
# the single-device engine at any depth.  (At 8 layers dp=2's stream parted
# from the single device's at a near-tie, which the dp check, whose
# first-token logits are bitwise, takes as a fault: PERF.md §6.)
GRID_MODEL = dataclasses.replace(MISTRAL_7B, num_hidden_layers=16)
GRID_NEW = 64
GRID_SP_PROMPT = GRID_SP_BUCKET = 8192
GRID_SP_NEW = 32
GRID_DRAIN_PROMPT, GRID_DRAIN_NEW, GRID_DRAIN_CHUNK = 4096, 32, 2048
# Run label -> ((dp, sp, tp), compression, quant, reference label, new
# tokens).  12a runs on two ranks, 12b on four, every rank sharing this card
# over gloo.  Phase 5's requests run its 64 new tokens; the sp request and
# the drain run 32.
# The compressing methods 12a runs under sp on one 8192-token request (16
# new): h2o (its scores over every query row, each rank's partial column
# sums added over the ranks), adakv (budgets over every head from the
# gathered window rows) and cam (a draw of the whole shape on every rank).
GRID_SP_METHODS, GRID_SP_METHOD_NEW = ("h2o", "adakv", "cam"), 16
GRID_RUNS = {
    "tp2_bf16": ((1, 1, 2), SNAPKV, None, "bf16", GRID_NEW),
    "tp2_int8": ((1, 1, 2), SNAPKV, QuantConfig(nbits=8), "int8", GRID_NEW),
    "tp2_int4": ((1, 1, 2), SNAPKV, QuantConfig(nbits=4), "int4", GRID_NEW),
    "dp2_bf16": ((2, 1, 1), SNAPKV, None, "bf16_alone", GRID_NEW),
    "dcn2_dp2_bf16": ((2, 1, 1), SNAPKV, None, "bf16_alone", GRID_NEW),
    "tp2_fullkv": ((1, 1, 2), CompressionConfig(method="fullkv"), None, "fullkv", GRID_NEW),
    **{f"sp2_{m}": ((1, 2, 1), dataclasses.replace(SNAPKV, method=m), None, f"sp_{m}",
                    GRID_SP_METHOD_NEW) for m in GRID_SP_METHODS},
    "dp2_tp2_bf16": ((2, 1, 2), SNAPKV, None, "bf16", GRID_NEW),
    "sp2_tp2_bf16": ((1, 2, 2), SNAPKV, None, "sp", GRID_SP_NEW),
    "drain_dp2_tp2": ((2, 1, 2), SNAPKV, None, "drain", GRID_DRAIN_NEW),
}
# ShardingConfig fields of a run beside its (dp, sp, tp): dp's two ways as
# inter-host ways, which on one host is plain dp (bitwise dp2_bf16's run).
GRID_EXTRA = {"dcn2_dp2_bf16": {"dcn_dp": 2}}
GRID_SPAWNS = (("12a", 2, ("tp2_bf16", "tp2_int8", "tp2_int4", "dp2_bf16", "dcn2_dp2_bf16",
                           "tp2_fullkv") + tuple(f"sp2_{m}" for m in GRID_SP_METHODS)),
               ("12b", 4, ("dp2_tp2_bf16", "sp2_tp2_bf16", "drain_dp2_tp2")))
# The runs whose prefill is also timed alone and whose decode step is profiled.
GRID_TIMED = ("tp2_bf16", "dp2_tp2_bf16")


def grid_references(rng, prompts):
    """Phase 12's references, on ``GRID_MODEL``'s weights (``init_params``
    seed 0, as the ranks draw them), freed after: the single-device engine
    on phase 5's two requests with each cache the ranks run (ids and every
    step's logits), and with the bf16 cache on each request alone (dp=2's
    reference), the fp32 reference forward of
    request (a)'s prompt and of request (b) along each single-device
    stream, the single-device engine on one 8192-token request (sp) and a
    single-device drain of four 4096-token requests (chunked admission);
    and K2 at one tp=2 rank's shape against its plain version, timed.  All
    kept on the host."""
    cfg, dev = GRID_MODEL, "cuda"
    params = init_params(cfg, seed=0, device=dev)
    log(f"== phase 12 references: single-device runs at {cfg.num_hidden_layers} of 32 layers")
    refs = {"checksum": weight_checksum(params), "prompts": prompts}
    for label, comp, quant in (("bf16", SNAPKV, None), ("int8", SNAPKV, QuantConfig(nbits=8)),
                               ("int4", SNAPKV, QuantConfig(nbits=4)),
                               ("fullkv", CompressionConfig(method="fullkv"), None)):
        engine = InferenceEngine(params, EngineConfig(model=cfg, compression=comp, quant=quant,
                                                      prefill_buckets=(4096,)), device=dev)
        ids, res = engine.generate_batch(prompts, GRID_NEW, return_result=True)
        seq_b = prompts[1] + ids[1][:GRID_NEW - 1]
        ref_b = forward_logits(params, cfg, torch.tensor([seq_b], device=dev))[
            0, len(prompts[1]) - 1:].cpu()
        refs[label] = {"ids": ids, "logits": res.logits.cpu(), "ref_b": ref_b}
        del engine, res
    # dp=2's reference: each request alone on the single device, as its dp
    # rank runs it.  K2's split count follows the heads of the batch (4
    # splits at 64 heads, 8 at 32 on an H100), so the batch of two decodes in
    # other bits than either request alone, and its stream may part from a
    # dp rank's at a near-tie; alone, the same kernels run the same shapes.
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=SNAPKV,
                                                  prefill_buckets=(4096,)), device=dev)
    alone = [engine.generate_batch([p], GRID_NEW, return_result=True) for p in prompts]
    ids = [got[0][0] for got in alone]
    seq_b = prompts[1] + ids[1][:GRID_NEW - 1]
    refs["bf16_alone"] = {
        "ids": ids, "logits": torch.cat([got[1].logits.cpu() for got in alone]),
        "ref_b": forward_logits(params, cfg, torch.tensor([seq_b], device=dev))[
            0, len(prompts[1]) - 1:].cpu()}
    del engine, alone
    refs["ref_a"] = forward_logits(params, cfg, torch.tensor([prompts[0]], device=dev))[0, -1].cpu()
    sp_prompt = rng.integers(0, cfg.vocab_size, size=GRID_SP_PROMPT).tolist()
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=SNAPKV,
                                                  prefill_buckets=(GRID_SP_BUCKET,)), device=dev)
    ids, res = engine.generate_batch([sp_prompt], GRID_SP_NEW, return_result=True)
    refs["sp"] = {"prompt": sp_prompt, "ids": ids, "logits": res.logits.cpu()}
    del engine, res
    # The sp methods' single-device runs and the fp32 reference of the sp
    # prompt's first token.
    for m in GRID_SP_METHODS:
        engine = InferenceEngine(params, EngineConfig(
            model=cfg, compression=dataclasses.replace(SNAPKV, method=m),
            prefill_buckets=(GRID_SP_BUCKET,)), device=dev)
        ids, res = engine.generate_batch([sp_prompt], GRID_SP_METHOD_NEW, return_result=True)
        refs[f"sp_{m}"] = {"ids": ids, "logits": res.logits.cpu(),
                           "lengths": res.cache.lengths[:, 0].cpu()}
        del engine, res
    with torch.no_grad():
        refs["ref_sp"] = forward_logits(params, cfg, torch.tensor([sp_prompt], device=dev))[
            0, -1].cpu()
    torch.cuda.empty_cache()
    drain_prompts = [rng.integers(0, cfg.vocab_size, size=GRID_DRAIN_PROMPT).tolist()
                     for _ in range(4)]
    eng = ContinuousBatchingEngine(
        params, EngineConfig(model=cfg, compression=SNAPKV, prefill_buckets=(GRID_DRAIN_PROMPT,)),
        n_slots=4, max_new_cap=GRID_DRAIN_NEW, prefill_chunk_tokens=GRID_DRAIN_CHUNK,
        device=dev, instrument=True)
    rids = [eng.submit(p, GRID_DRAIN_NEW) for p in drain_prompts]
    out = eng.run()
    refs["drain"] = {"prompts": drain_prompts, "ids": [out[r] for r in rids],
                     "logits": torch.stack([torch.stack(eng.logits[r]) for r in rids])}
    del eng, params
    torch.cuda.empty_cache()
    # K2 at one tp=2 rank's decode shape: B=2 x 16 query heads of the
    # per-query-head cache, half-way through decode.
    C, H = SNAPKV.max_capacity_prompt + GRID_NEW + 1, 2 * (cfg.num_attention_heads // 2)
    mid = [2048 + 31] * (H // 2) + [1500 + 31] * (H // 2)
    q, kc, vc, kn, vn, lens, _, _, err, abs_err = k2_case(rng, H, 1, C, mid, np.zeros(H, np.int64))
    refs["k2_tp2"] = {"shape": f"H={H} (B=2 x 16, one of tp=2) G=1 C={C} D=128, lengths "
                               f"2079 and 1531", "rel_l2": err, "max_abs_err": abs_err,
                      **time_k2(q, kc, vc, kn, vn, lens)}
    return refs


def rank_setup(rank, n, directory):
    """A spawned rank sharing this card: TF32 off, the gloo group over a
    file rendezvous in ``directory`` (pairs over the loopback device), and
    the job in ``directory/job.pt``."""
    job = torch.load(Path(directory) / "job.pt")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        raise SystemExit(f"rank {rank}: no CUDA device")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=GRID_TIMEOUT_S))
    return job


def grid_rank(rank, n, directory):
    """One rank of a phase-12 spawn (a spawned process sharing this card):
    the weights of phase 5 (``init_params`` seed 0), drawn whole by one rank
    at a time and cut to the rank's tp=2 shard (``shard_tree``), the whole
    model kept only where a run has no tp; then each run of the job in
    ``directory/job.pt``.  Writes its results to ``directory/rank{rank}.pt``."""
    job = rank_setup(rank, n, directory)
    t0 = time.perf_counter()
    try:
        cfg = GRID_MODEL
        whole = shard = checksum = None
        keep_whole = any(GRID_RUNS[label][0][2] == 1 for label in job["runs"])
        for r in range(n):
            if r == rank:
                whole = init_params(cfg, seed=0, device="cuda")
                checksum = weight_checksum(whole)
                shard = shard_tree(whole, cfg, 2, rank % 2)  # tp is the grid's last axis
                if not keep_whole:
                    whole = None
                torch.cuda.empty_cache()
            dist.barrier()
        result = {"rank": rank, "checksum": checksum, "runs": {},
                  "shard_bytes": tree_bytes(shard), "rank_s": {"weights": time.perf_counter() - t0}}
        t0 = time.perf_counter()
        for label in job["runs"]:
            result["runs"][label] = grid_run(rank, label, job, whole, shard)
            torch.cuda.empty_cache()
            dist.barrier()
        result["rank_s"]["runs"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(directory) / f"rank{rank}.pt")


def grid_run(rank, label, job, whole, shard):
    """One run of a spawn, every launch count and collective count set to 0
    just before it and read just after: ids and every step's logits (the
    whole batch's), this rank's cache lengths and head count, K2 (K3, K4)
    on the first and last layer of the rank's finished cache against the plain
    version while the other ranks do the same on the card; for
    ``GRID_TIMED`` runs also a prefill alone (wall, collectives) and
    profiled decode steps."""
    grid, comp, quant, _, new = GRID_RUNS[label]
    dp, sp, tp = grid
    params = shard if tp > 1 else whole
    sharding = ShardingConfig(dp=dp, sp=sp, tp=tp, **GRID_EXTRA.get(label, {}))
    if label.startswith("drain"):
        return grid_drain(rank, params, sharding, job["drain_prompts"])
    prompts = [job["sp_prompt"]] if sp > 1 else job["prompts"]
    bucket = GRID_SP_BUCKET if sp > 1 else 4096
    engine = InferenceEngine(params, EngineConfig(model=GRID_MODEL, compression=comp, quant=quant,
                                                  sharding=sharding, prefill_buckets=(bucket,)),
                             device="cuda")
    groups = engine.groups
    reset_counts()
    groups.reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    ids, res = engine.generate_batch(prompts, new, return_result=True)
    sync()
    run_s = time.perf_counter() - t0
    result = {"launches": path_launches(), "counts_run": groups.counts(), "run_s": run_s,
              "ids": ids, "logits": res.logits.cpu(), "cache": type(res.cache).__name__,
              "heads": res.cache.lengths.shape[2],
              "coords": (groups.dp_rank, groups.sp_rank, groups.tp_rank),
              "lengths": [sorted(set(res.cache.lengths[:, b].flatten().tolist()))
                          for b in range(res.cache.lengths.shape[1])],
              "lengths_array": res.cache.lengths[:, 0].cpu()}
    result["direct_rel_l2"] = direct_decode_check(np.random.default_rng(rank), res.cache, quant,
                                                  f"{label} rank {rank}")
    if label in GRID_TIMED:
        groups.reset_counts()
        dist.barrier()
        t0 = time.perf_counter()
        engine.generate_batch(prompts, 1)
        sync()
        prefill_s = time.perf_counter() - t0
        result.update(prefill_s=prefill_s, counts_prefill=groups.counts(),
                      decode_ms_per_step=(run_s - prefill_s) / (new - 1) * 1e3)
        lo, hi = groups.rows(-(-len(prompts) // dp) * dp)
        cur = torch.tensor([x[-1] for x in ids[lo:hi]], device="cuda")
        result["decode_busy_ms"] = grid_decode_busy(rank, engine, res.cache, cur, quant)
    return result


def grid_decode_busy(rank, engine, cache, cur, quant, steps=4):
    """Device busy time per decode step on rank 0, from ``torch.profiler``
    over ``steps`` steps that every rank runs together (they overwrite the
    cache's last slots, which nothing reads again); None elsewhere, or when
    the profiler sees no device time."""
    def step():
        llama.decode_step(engine.params, engine.model_cfg, cur, cache, quant=quant,
                          tp=engine.tp_group, ep=engine.experts)

    with torch.no_grad():
        step()
        sync()
        dist.barrier()
        if rank:
            for _ in range(steps):
                step()
            sync()
            return None
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            sync()
    busy = sum(evt.self_device_time_total for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA) / steps / 1e3
    return busy if busy > 0 else None


def grid_drain(rank, params, sharding, prompts):
    """The four requests through ``ContinuousBatchingEngine`` under
    ``sharding``, chunked admission; every count set to 0 just before
    ``run`` and read just after."""
    eng = ContinuousBatchingEngine(
        params, EngineConfig(model=GRID_MODEL, compression=SNAPKV, sharding=sharding,
                             prefill_buckets=(GRID_DRAIN_PROMPT,)),
        n_slots=4, max_new_cap=GRID_DRAIN_NEW, prefill_chunk_tokens=GRID_DRAIN_CHUNK,
        device="cuda", instrument=True)
    rids = [eng.submit(p, GRID_DRAIN_NEW) for p in prompts]
    reset_counts()
    eng.groups.reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    out = eng.run()
    sync()
    lens = eng.cache.lengths
    groups = eng.groups
    return {"launches": path_launches(), "counts_run": groups.counts(),
            "run_s": time.perf_counter() - t0, "ids": [out[r] for r in rids],
            "first_logits": {i: eng.logits[r][0] for i, r in enumerate(rids) if r in eng.logits},
            "chunk_dispatches": eng.prefill_chunk_dispatches, "steps": eng.steps_executed,
            "heads": lens.shape[2], "coords": (groups.dp_rank, groups.sp_rank, groups.tp_rank),
            "lengths": [sorted(set(lens[:, b].flatten().tolist())) for b in range(lens.shape[1])]}


def spawn_grid(name, n, job, fn=None):
    """``n`` ranks of ``fn`` (``grid_rank`` by default) on ``job``; their
    results in rank order.  A rank that fails, or a spawn past
    ``GRID_TIMEOUT_S``, ends the script."""
    fn = fn or grid_rank
    directory = GRID_DIR / name
    directory.mkdir(parents=True)
    # The prompts go by file: arguments past the pipe's buffer would hold
    # each spawn until its child has imported this script.
    torch.save(job, directory / "job.pt")
    ctx = torch.multiprocessing.start_processes(fn, args=(n, str(directory)),
                                                nprocs=n, start_method="spawn", join=False)
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > GRID_TIMEOUT_S:
                raise SystemExit(f"the {name} ranks did not finish in {GRID_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(directory / f"rank{r}.pt") for r in range(n)]
    return ranks, spawn_s, time.perf_counter() - t0 - spawn_s


def stream_parting(got, want, want_logits, margin, what):
    """Where a greedy stream ``got`` first parts from ``want`` (None where
    they agree over ``got``'s tokens); the parting must sit at a near-tie of ``want``'s logits
    (top-2 gap within ``margin``, as phase 8 holds its ranks)."""
    apart = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
    if not apart:  # a shorter run is compared over its own tokens
        return None
    j = apart[0]
    top2 = want_logits[j].topk(2).values
    gap = (top2[0] - top2[1]).item()
    if gap > margin:
        raise SystemExit(f"{what}: the stream parts from the single-device one at step {j}, "
                         f"where the top-2 gap is {gap:.4f} (margin {margin:.4f})")
    return {"step": j, "top2_gap": gap}


def grid_check(label, ranks, refs):
    """Phase 12's checks of one run over every rank: launches per rank,
    cache lengths and head counts, ranks agreeing (ids, and first-token
    logits bitwise), first-token logits against the single-device engine
    and the fp32 reference, request (b)'s decode logits against the fp32
    reference while its stream follows the single-device one, and the
    streams identical up to a near-tie.  Returns the run's summary."""
    grid, comp, quant, ref_label, new = GRID_RUNS[label]
    dp, sp, tp = grid
    L = GRID_MODEL.num_hidden_layers
    runs = [rk["runs"][label] for rk in ranks]
    ref = refs[ref_label]
    tol = E2E_REL_L2_TOL if quant is None else E2E_QUANT_REL_L2_TOL[quant.nbits]
    decode_id = "K2" if quant is None else QUANT[quant.nbits][0]
    drain = label.startswith("drain")
    for r, run in enumerate(runs):
        want = dict.fromkeys(run["launches"], 0)
        if drain:
            want["K1-chunk"], want["K2"] = L * run["chunk_dispatches"], L * run["steps"]
            if not run["chunk_dispatches"] or not run["steps"]:
                raise SystemExit(f"{label} rank {r} ran no chunk or no decode step")
        elif sp > 1:
            want["K1-ml"], want["K2"] = L * (run["coords"][1] + 1), L * (new - 1)
        else:
            want["K1"], want[decode_id] = L, L * (new - 1)
        if run["launches"] != want:
            raise SystemExit(f"{label} rank {r}: launches {run['launches']}, expect {want}")
        heads = GRID_MODEL.num_attention_heads // tp if comp.method != "fullkv" else \
            GRID_MODEL.num_key_value_heads // tp
        if comp.method in GRID_SP_METHODS:
            ok, note = sp_method_lengths(comp, run["lengths_array"] - (new - 1),
                                         ref["lengths"] - (new - 1))
            log(f"{label} rank {r}: lengths {note}")
            if not ok or run["heads"] != heads:
                raise SystemExit(f"{label} rank {r}: lengths against {comp.method}'s rule")
            continue
        if drain:
            lengths = [[GRID_DRAIN_NEW - 1 + SNAPKV.max_capacity_prompt]] * (4 // dp)
        elif sp > 1:
            lengths = [[SNAPKV.max_capacity_prompt + new - 1]]
        else:
            plen = [len(p) for p in refs["prompts"]]
            cap = [n if comp.method == "fullkv" else min(n, SNAPKV.max_capacity_prompt)
                   for n in plen]
            lengths = [[c + new - 1] for c in cap]
            lengths = lengths[run["coords"][0]::dp]
        if run["heads"] != heads or run["lengths"] != lengths:
            raise SystemExit(f"{label} rank {r}: {run['heads']} heads, lengths {run['lengths']}; "
                             f"expect {heads}, {lengths}")
    if drain:
        firsts = {}
        for run in runs:
            firsts.update(run["first_logits"])
        got_first = torch.stack([firsts[i] for i in range(len(ref["ids"]))])
        want_first = ref["logits"][:, 0]
        ids = runs[0]["ids"]
        agree = all(run["ids"] == ids for run in runs)
    else:
        ids = runs[0]["ids"]
        agree = all(run["ids"] == ids and torch.equal(run["logits"][:, 0], runs[0]["logits"][:, 0])
                    for run in runs)
        got_first, want_first = runs[0]["logits"][:, 0], ref["logits"][:, 0]
    rel, absd = rel_l2(got_first, want_first)
    log(f"{label}: ranks agree (ids{'' if drain else ', first-token logits bitwise'}) {agree}; "
        f"first-token logits against the single-device engine rel L2 {rel:.4f} (max abs "
        f"{absd:.4f}) tol {tol}")
    if not agree or rel > tol:
        raise SystemExit(f"{label}: the ranks disagree with each other or with the single device")
    summary = {"grid": {"dp": dp, "sp": sp, "tp": tp, **GRID_EXTRA.get(label, {})},
               "ranks_agree": agree,
               "first_token_rel_l2_vs_single": rel, "first_token_max_abs_vs_single": absd,
               "rel_l2_tol": tol}
    if comp.method in GRID_SP_METHODS:
        rel_fp32 = rel_l2(got_first, refs["ref_sp"][None])[0]
        log(f"{label}: first-token logits against the fp32 reference rel L2 {rel_fp32:.4f} "
            f"(tol {E2E_REL_L2_TOL})")
        if rel_fp32 > E2E_REL_L2_TOL:
            raise SystemExit(f"{label}: logits disagree with the fp32 reference")
        summary["first_token_rel_l2_vs_fp32"] = rel_fp32
    if not drain and sp == 1:
        logits = runs[0]["logits"]
        rel_a = rel_l2(logits[0, :1], refs["ref_a"][None])[0]
        rel_b0 = rel_l2(logits[1, :1], ref["ref_b"][:1])[0]
        # Request (b)'s decode logits along the steps where its stream
        # still follows the single-device one (the reference's context).
        same = next((j for j, (a, b) in enumerate(zip(ids[1], ref["ids"][1])) if a != b), new)
        rel_bd = rel_l2(logits[1, 1:same], ref["ref_b"][1:same])[0] if same > 1 else None
        log(f"{label}: against the fp32 reference: first-token (a) rel L2 {rel_a:.4f}, (b) "
            f"{rel_b0:.4f} (tol {E2E_REL_L2_TOL}); (b) decode over {max(same - 1, 0)} steps "
            f"worst rel L2 {rel_bd} (tol {tol})")
        if max(rel_a, rel_b0) > E2E_REL_L2_TOL or (rel_bd is not None and rel_bd > tol):
            raise SystemExit(f"{label}: logits disagree with the fp32 reference")
        summary.update(first_token_rel_l2_vs_fp32=[rel_a, rel_b0], decode_rel_l2_vs_fp32=rel_bd,
                       decode_steps_compared=max(same - 1, 0))
    margin = 2 * absd
    want_logits = ref["logits"]
    parted = [stream_parting(ids[i], ref["ids"][i], want_logits[i], margin,
                             f"{label} request {i}") for i in range(len(ids))]
    log(f"{label}: greedy streams against the single-device ones identical "
        f"{all(p is None for p in parted)}; parted at near-ties (margin {margin:.4f}): "
        f"{[p for p in parted if p]}")
    summary["parted"] = parted
    for r, run in enumerate(runs):
        keep = ("launches", "heads", "lengths", "coords", "run_s", "counts_run", "direct_rel_l2",
                "prefill_s", "counts_prefill", "decode_ms_per_step", "decode_busy_ms",
                "chunk_dispatches", "steps")
        summary.setdefault("ranks", []).append({k: run[k] for k in keep if k in run})
    return summary


def sp_method_lengths(comp, got, want):
    """An sp run's prefill lengths ``[L, H]`` of one request by its
    method's rule: h2o and cam keep ``max_capacity_prompt`` in every head;
    adakv keeps each head within its bound and each layer's budgets sum to
    ``H * base_capacity`` within ``H / 2`` where no head is clipped (phase
    5b's rule), beside the single device's lengths (``want``).  Returns
    whether they hold and what was seen."""
    got, want = got.numpy(), want.numpy()
    L, H = got.shape
    same = int((got == want).sum())
    if comp.method != "adakv":
        ok = (got == comp.max_capacity_prompt).all()
        return ok, (f"{sorted(set(got.flatten().tolist()))} (rule [{comp.max_capacity_prompt}]); "
                    f"equal to the single device's in {same} of {got.size}")
    bound = comp.layer_capacity(L, GRID_SP_PROMPT) - comp.window_size
    budgets = got - comp.window_size
    unclipped = (budgets < bound).all(axis=1)
    dev_sum = np.abs(budgets.sum(axis=1) - H * comp.base_capacity)
    ok = (budgets <= bound).all() and (dev_sum[unclipped] <= H / 2).all()
    return ok, (f"per head {int(got.min())}-{int(got.max())} (bound {bound + comp.window_size}); "
                f"{int(unclipped.sum())} layers without a clipped head, budget sums off "
                f"H * {comp.base_capacity} by at most "
                f"{dev_sum[unclipped].max() if unclipped.any() else None} (limit {H / 2}); "
                f"equal to the single device's in {same} of {got.size}")


def phase_grid(refs):
    """The (dp, sp, tp) layouts on this card: 12a on two ranks (tp=2 over
    the bf16, int8 and int4 caches, dp=2, tp=2 with fullkv), 12b on four
    ((dp, tp) = (2, 2), (sp, tp) = (2, 2) on one 8192-token request, a
    (2, 2) serving drain with chunked admission), every rank sharing the
    card over gloo; each run checked against the single-device references
    (``grid_references``)."""
    log(f"== phase 12: dp, tp and (sp, tp) at Mistral-7B-Instruct-v0.2 widths, ranks sharing "
        f"this card over gloo (tensors staged through pinned host memory)")
    shutil.rmtree(GRID_DIR, ignore_errors=True)
    job = {"prompts": refs["prompts"], "sp_prompt": refs["sp"]["prompt"],
           "drain_prompts": refs["drain"]["prompts"]}
    out = {"k2_tp2": refs["k2_tp2"], "runs": {}}
    for name, n, labels in GRID_SPAWNS:
        t0 = time.perf_counter()
        ranks, spawn_s, load_s = spawn_grid(name, n, dict(job, runs=labels))
        for r, rk in enumerate(ranks):
            if rk["checksum"] != refs["checksum"]:
                raise SystemExit(f"{name} rank {r} holds other weights")
        t_check = time.perf_counter()
        for label in labels:
            out["runs"][label] = grid_check(label, ranks, refs)
        if "dcn2_dp2_bf16" in labels:
            # dcn_dp on one host is plain dp: every rank bitwise dp=2's run.
            same = all(rk["runs"]["dcn2_dp2_bf16"][k] == rk["runs"]["dp2_bf16"][k]
                       for rk in ranks for k in ("ids", "coords")) and all(
                torch.equal(rk["runs"]["dcn2_dp2_bf16"][k], rk["runs"]["dp2_bf16"][k])
                for rk in ranks for k in ("logits", "lengths_array"))
            log(f"dcn2_dp2_bf16: ids, logits and lengths bitwise those of dp2_bf16 on every "
                f"rank: {same}")
            if not same:
                raise SystemExit("dcn_dp=2 on one host is not plain dp")
            out["runs"]["dcn2_dp2_bf16"]["bitwise_dp2"] = same
        check_s = time.perf_counter() - t_check
        out[name] = {"ranks": n, "spawn_to_join_s": spawn_s, "load_s": load_s,
                     "check_s": check_s, "shard_bytes": [rk["shard_bytes"] for rk in ranks],
                     "rank_s": [rk["rank_s"] for rk in ranks], "wall_s": time.perf_counter() - t0}
        log(f"{name}: {n} ranks, spawn to join {spawn_s:.1f} s (in the ranks: weights "
            f"{[round(rk['rank_s']['weights'], 1) for rk in ranks]} s, runs "
            f"{[round(rk['rank_s']['runs'], 1) for rk in ranks]} s), results loaded in "
            f"{load_s:.1f} s, checked in {check_s:.1f} s; each rank's tp=2 shard "
            f"{ranks[0]['shard_bytes'] / 1e9:.2f} GB")
    for label in GRID_TIMED:
        for r, run in enumerate(out["runs"][label]["ranks"]):
            pre, tot = run["counts_prefill"], run["counts_run"]
            steps = GRID_RUNS[label][4] - 1
            per_step = {axis: {k: (tot[axis][k] - pre[axis][k]) / steps for k in tot[axis]}
                        for axis in tot}
            run["counts_per_step"] = per_step
            busy = run["decode_busy_ms"]
            log(f"{label} rank {r}: prefill {run['prefill_s']:.3f} s wall; per prefill "
                + "; ".join(f"{a}: {c['collectives']} collectives, {c['staged_bytes'] / 1e9:.3f} GB "
                            f"staged in {c['staged_s']:.3f} s" for a, c in pre.items())
                + f"; decode {run['decode_ms_per_step']:.3f} ms/step wall, busy "
                + ("not measured" if busy is None else f"{busy:.3f} ms")
                + " (rank 0, profiled); per step "
                + "; ".join(f"{a}: {c['collectives']:.1f} collectives, {c['staged_bytes'] / 1e6:.3f} "
                            f"MB staged in {c['staged_s'] * 1e3:.2f} ms" for a, c in per_step.items()))
    return out


# ---------------------------------------------------------------------------
# Phase 13: pipeline parallelism (pp) at Mistral-7B-Instruct-v0.2 widths
# ---------------------------------------------------------------------------

PP, PP_MICRO = 2, 2
PP_BUSY_NEW = 9  # the run whose device time, less a prefill's, gives busy per step


def profiled_busy_ms(fn):
    """This process's device busy time over ``fn()`` (ms, from
    ``torch.profiler``), None when the profiler sees none."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    busy = sum(evt.self_device_time_total for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA) / 1e3
    return busy if busy > 0 else None


def pp_rank(rank, n, directory):
    """One stage of phase 13 (a spawned process sharing this card): phase
    5's weights (``init_params`` seed 0) drawn whole by one rank at a time,
    its ``L / n`` layers kept (``shard_params_pp``); then phase 5's requests
    through ``InferenceEngine(ShardingConfig(pp=n, pp_microbatches=2))``,
    every launch and collective count set to 0 just before it and read
    just after; K2 on the first and last layer of the stage's slab against
    its plain version; a prefill alone; busy time per decode step from the
    profiler (a 9-token run less a prefill, this stage's kernels)."""
    job = rank_setup(rank, n, directory)
    t0 = time.perf_counter()
    try:
        cfg = GRID_MODEL
        for r in range(n):
            if r == rank:
                whole = init_params(cfg, seed=0, device="cuda")
                checksum = weight_checksum(whole)
                stage = pipeline.shard_params_pp(whole, cfg, n, rank)
                del whole
                torch.cuda.empty_cache()
            dist.barrier()
        weights_s = time.perf_counter() - t0
        engine = InferenceEngine(stage, EngineConfig(
            model=cfg, compression=SNAPKV, prefill_buckets=(4096,),
            sharding=ShardingConfig(pp=n, pp_microbatches=PP_MICRO)), device="cuda")
        group, prompts = engine.pp_group, job["prompts"]
        reset_counts()
        group.reset_counts()
        dist.barrier()
        t0 = time.perf_counter()
        ids, res = engine.generate_batch(prompts, GRID_NEW, return_result=True)
        sync()
        run_s = time.perf_counter() - t0
        lens = res.cache.lengths
        result = {"rank": rank, "checksum": checksum, "launches": path_launches(),
                  "counts_run": group_counts(group), "run_s": run_s, "weights_s": weights_s,
                  "stage_bytes": tree_bytes(stage), "ids": ids, "logits": res.logits[:, 0].cpu(),
                  "layers": lens.shape[0], "heads": lens.shape[2],
                  "lengths": [sorted(set(lens[:, b].flatten().tolist()))
                              for b in range(lens.shape[1])]}
        result["direct_rel_l2"] = direct_decode_check(np.random.default_rng(rank), res.cache,
                                                      None, f"pp stage {rank}")
        del res
        group.reset_counts()
        dist.barrier()
        t0 = time.perf_counter()
        engine.generate_batch(prompts, 1)
        sync()
        result.update(prefill_s=time.perf_counter() - t0, counts_prefill=group_counts(group))
        result["decode_ms_per_step"] = (run_s - result["prefill_s"]) / (GRID_NEW - 1) * 1e3
        dist.barrier()
        busy_n = profiled_busy_ms(lambda: engine.generate_batch(prompts, PP_BUSY_NEW))
        dist.barrier()
        busy_1 = profiled_busy_ms(lambda: engine.generate_batch(prompts, 1))
        result["decode_busy_ms"] = (None if busy_n is None or busy_1 is None else
                                    (busy_n - busy_1) / (PP_BUSY_NEW - 1))
        result["prefill_busy_ms"] = busy_1
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(directory) / f"rank{rank}.pt")


def group_counts(group):
    return {"collectives": group.collectives, "staged_bytes": group.staged_bytes,
            "staged_s": group.staged_s}


def phase_pp(refs):
    """Phase 13: phase 5's requests (snapkv, 64 new) through the GPipe
    engine on two stages sharing this card over gloo (hidden states and
    tokens staged through pinned host memory), checked against the
    single-device references of phase 12 (``grid_references``; the streams
    against each request alone, as each microbatch runs it)."""
    cfg, L = GRID_MODEL, GRID_MODEL.num_hidden_layers
    log(f"== phase 13: pp={PP} ({PP_MICRO} microbatches) at Mistral-7B-Instruct-v0.2 widths "
        f"({L} of 32 layers), "
        f"stages sharing this card over gloo")
    ranks, spawn_s, load_s = spawn_grid("13", PP, {"prompts": refs["prompts"]}, fn=pp_rank)
    # Each microbatch is one request: its reference is that request alone on
    # the single device (K2 then runs the same heads, as for dp=2).
    ref, steps, Lp = refs["bf16_alone"], GRID_NEW - 1, L // PP
    want_launches = {"K1": Lp * PP_MICRO, "K2": Lp * steps * PP_MICRO}
    plen = [len(p) for p in refs["prompts"]]
    want_lengths = [[min(n, SNAPKV.max_capacity_prompt) + steps] for n in plen]
    for r, rk in enumerate(ranks):
        launches = {k: v for k, v in rk["launches"].items() if v}
        log(f"13 stage {r}: launches {launches} (expect {want_launches}); {rk['layers']} layers, "
            f"{rk['heads']} heads, lengths {rk['lengths']} (expect {want_lengths})")
        if rk["checksum"] != refs["checksum"]:
            raise SystemExit(f"pp stage {r} drew other weights")
        if launches != want_launches or rk["lengths"] != want_lengths or rk["layers"] != Lp:
            raise SystemExit(f"pp stage {r}: launches or cache lengths against the schedule")
    agree = all(rk["ids"] == ranks[0]["ids"] and torch.equal(rk["logits"], ranks[0]["logits"])
                for rk in ranks)
    got = ranks[0]["logits"]
    rel_single, absd = rel_l2(got, ref["logits"][:, 0])
    rel_a = rel_l2(got[:1], refs["ref_a"][None])[0]
    rel_b = rel_l2(got[1:2], ref["ref_b"][:1])[0]
    log(f"13: stages agree (ids, first-token logits bitwise) {agree}; first-token logits "
        f"against the fp32 reference (a) {rel_a:.4f}, (b) {rel_b:.4f} (tol {E2E_REL_L2_TOL}); "
        f"against the single device rel L2 {rel_single:.4f} (max abs {absd:.4f})")
    if not agree or max(rel_a, rel_b) > E2E_REL_L2_TOL:
        raise SystemExit("pp: the stages disagree, or the logits with the fp32 reference")
    parted = [stream_parting(ranks[0]["ids"][i], ref["ids"][i], ref["logits"][i], 2 * absd,
                             f"pp request {i}") for i in range(len(plen))]
    summary = {"pp": PP, "microbatches": PP_MICRO, "stages_agree": agree,
               "first_token_rel_l2_vs_fp32": [rel_a, rel_b],
               "first_token_rel_l2_vs_single": rel_single, "parted": parted,
               "spawn_to_join_s": spawn_s, "load_s": load_s, "stages": []}
    for r, rk in enumerate(ranks):
        pre, tot = rk["counts_prefill"], rk["counts_run"]
        per_step = {k: (tot[k] - pre[k]) / steps for k in tot}
        busy, pbusy = rk["decode_busy_ms"], rk["prefill_busy_ms"]
        log(f"13 stage {r}: weights {rk['weights_s']:.1f} s ({rk['stage_bytes'] / 1e9:.2f} GB "
            f"kept); prefill {rk['prefill_s']:.3f} s wall, busy "
            f"{'not measured' if pbusy is None else f'{pbusy:.1f} ms'}, "
            f"{pre['collectives']} exchanges, {pre['staged_bytes'] / 1e6:.3f} MB staged in "
            f"{pre['staged_s']:.3f} s; decode {rk['decode_ms_per_step']:.3f} ms/step wall, busy "
            f"{'not measured' if busy is None else f'{busy:.3f} ms'}; per step "
            f"{per_step['collectives']:.1f} exchanges, {per_step['staged_bytes'] / 1e3:.3f} kB "
            f"staged in {per_step['staged_s'] * 1e3:.2f} ms; K2 direct worst rel L2 "
            f"{rk['direct_rel_l2'][0]:.2e}")
        summary["stages"].append({k: rk[k] for k in (
            "launches", "lengths", "layers", "heads", "run_s", "weights_s", "stage_bytes",
            "prefill_s", "prefill_busy_ms", "decode_ms_per_step", "decode_busy_ms",
            "counts_prefill", "counts_run", "direct_rel_l2")})
        summary["stages"][-1]["counts_per_step"] = per_step
    return summary


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
# Depth cut to 7 of the 28 layers since phases 16 and 16b joined the
# script, to keep it well inside its time limit (PERF.md §6: 1140.4
# s at 28 layers here and 16 in phase 10, 1100.9 s at 14 and 8), to 4
# since phases 3g-4g and 19 did, and to 2 since phases 3h-4h and 20 did:
# the checks count launches per layer and the logits hold to the fp32
# reference at any depth.
QWEN2_7B = dataclasses.replace(ModelConfig.from_hf_config(QWEN2_7B_HF_CONFIG),
                               num_hidden_layers=2)
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


def mixtral_layer_shapes(cfg):
    """``hf_layer_shapes`` for a Mixtral layer: the attention and norms (no
    biases), the router ``block_sparse_moe.gate`` ``[E, h]`` and each
    expert's w1 / w3 ``[f, h]`` and w2 ``[h, f]``."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {n: s for n, s in hf_layer_shapes(cfg).items()
              if not n.startswith("mlp.") and not n.endswith(".bias")}
    shapes["block_sparse_moe.gate.weight"] = (cfg.num_local_experts, h)
    for e in range(cfg.num_local_experts):
        for w, shape in (("w1", (f, h)), ("w3", (f, h)), ("w2", (h, f))):
            shapes[f"block_sparse_moe.experts.{e}.{w}.weight"] = shape
    return shapes


def random_hf_state(cfg, seed, layer_shapes=hf_layer_shapes):
    """Random bf16 tensors on the card under HF names (``layer_shapes(cfg)``
    in each layer): matrices normal / sqrt(fan_in), biases 0.1 * normal,
    norms 1 + 0.1 * normal."""
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
        for name, shape in layer_shapes(cfg).items():
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
    output axis, matrices transposed to input-major, stacked over layers;
    on a Mixtral configuration the router, and w1 | w3 and w2 of each expert
    stacked over the experts."""
    lay = lambda li, n: state[f"model.layers.{li}.{n}"]  # noqa: E731

    def stack(fn):
        return torch.stack([fn(li) for li in range(cfg.num_hidden_layers)])
    layers = {
        "qkv_proj": stack(lambda li: torch.cat([lay(li, f"self_attn.{p}_proj.weight")
                                                for p in "qkv"]).T),
        "o_proj": stack(lambda li: lay(li, "self_attn.o_proj.weight").T),
        "input_norm": stack(lambda li: lay(li, "input_layernorm.weight")),
        "post_norm": stack(lambda li: lay(li, "post_attention_layernorm.weight")),
    }
    if cfg.is_moe:
        def experts(fn):
            return stack(lambda li: torch.stack([fn(li, f"block_sparse_moe.experts.{e}")
                                                 for e in range(cfg.num_local_experts)]))
        layers["router"] = stack(lambda li: lay(li, "block_sparse_moe.gate.weight").T)
        layers["gate_up_proj"] = experts(lambda li, p: torch.cat([lay(li, f"{p}.w1.weight"),
                                                                 lay(li, f"{p}.w3.weight")]).T)
        layers["down_proj"] = experts(lambda li, p: lay(li, f"{p}.w2.weight").T)
    else:
        layers["gate_up_proj"] = stack(lambda li: torch.cat([lay(li, "mlp.gate_proj.weight"),
                                                             lay(li, "mlp.up_proj.weight")]).T)
        layers["down_proj"] = stack(lambda li: lay(li, "mlp.down_proj.weight").T)
    if "model.layers.0.self_attn.q_proj.bias" in state:
        layers["qkv_bias"] = stack(lambda li: torch.cat([lay(li, f"self_attn.{p}_proj.bias")
                                                         for p in "qkv"]))
    return {"embed": state["model.embed_tokens.weight"], "layers": layers,
            "final_norm": state["model.norm.weight"], "lm_head": state["lm_head.weight"].T}


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
    SnapKV prefill bitwise equal on the two.  It is left in ``QWEN_DIR``
    for phase 18."""
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
    # The checkpoint stays for phase 18 (infer_attention and the serving
    # example read it), which deletes it.
    del state, want, loaded, pre
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
    """Device-to-host copies, host reads of a device scalar and stream /
    device synchronisations during ``fn`` and one ``sync()`` after it, from
    the profiler: DtoH memcpy events, ``aten::_local_scalar_dense`` calls
    and ``cuda*Synchronize`` calls."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    out = {"dtoh": 0, "scalar_reads": 0, "syncs": 0}
    for evt in prof.key_averages():
        if "DtoH" in evt.key or "Device -> Pageable" in evt.key or "Device -> Pinned" in evt.key:
            out["dtoh"] += evt.count
        elif evt.key == "aten::_local_scalar_dense":
            out["scalar_reads"] += evt.count
        elif evt.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                         "cudaEventSynchronize"):
            out["syncs"] += evt.count
    return out


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
    same_reads = all(reads[4][k] == reads[12][k] for k in ("dtoh", "scalar_reads"))
    log(f"  device-to-host copies and host scalar reads per generate (no EOS ids): 4 tokens "
        f"{reads[4]}, 12 tokens {reads[12]}; the 8 decode steps between add none "
        f"{same_reads}")
    if not same_reads:
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
            "host_reads_4_vs_12_tokens": [reads[4], reads[12]],
            "mask_and_draw_ms": draw_ms, "gumbel_ms": noise_ms, "sampled_request_s": sampled_s,
            "greedy_request_s": greedy_s, "wall_ms_per_step_apart": per_step}


def phase_qwen2(rng, log_file):
    """Phase 9: the checkpoint-to-score path at Qwen2-7B-Instruct widths."""
    cfg = QWEN2_7B
    loader = phase_loader(rng)
    log(f"== 9b Qwen2-7B-Instruct widths, {cfg.num_hidden_layers} of 28 layers, random bf16 "
        f"weights + q/k/v biases (seed 1), then quantize_weights (W8A16)")
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
    return {"model": f"Qwen2-7B-Instruct widths ({cfg.num_hidden_layers} of 28 layers; the "
                     "loader's checkpoint 4), random "
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
# Depth cut to 16 of the 32 layers since phases 13 and 14 joined the script
# (PERF.md §6: 1131.8 s at 32 layers), and to 4 since phases 16 and 16b did
# (1140.4 s at 16, 1100.9 s at 8), and to 2 since phases 3h-4h and 20 did,
# to keep the whole script inside its time limit: every check of phase 10
# reads layers 0 and L - 1 and counts launches per layer.
LLAMA3_8B = dataclasses.replace(ModelConfig.from_hf_config(LLAMA3_8B_HF_CONFIG),
                                num_hidden_layers=2)
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
    """The grouped cache's prefill rows of layers 0 and L - 1 against the plain
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
    records, ``cudaMemcpy*`` calls).  As in ``profile_device``, one warm-up
    call runs first and the window opens with ``PROFILE_BURST`` spin
    kernels, which take the profiler's loss of first records; a call that
    still has no device record (by correlation id) is logged."""
    fn()
    sync()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        profile_burst()
        fn()
        sync()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    path.unlink()
    events = events["traceEvents"] if isinstance(events, dict) else events
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    calls = {e["args"].get("correlation") for e in events if e.get("cat") == "cuda_runtime"
             and e.get("name", "").startswith("cudaMemcpy")}
    missing = calls - {e["args"].get("correlation") for e in copies}
    log(f"h2d profile: {len(calls)} copies, {len(missing)} without a device record")
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
    log(f"== 10 Meta-Llama-3-8B-Instruct widths ({cfg.num_hidden_layers} of 32 layers, 32 / 8 "
        f"heads, vocab 128256, "
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


# ---------------------------------------------------------------------------
# Phase 11: Mixtral-8x7B-Instruct-v0.1 widths (sparse MoE), W8A16, serving
# ---------------------------------------------------------------------------

# The fields the forward reads from the published config.json of
# mistralai/Mixtral-8x7B-Instruct-v0.1 (bf16 weights).
MIXTRAL_HF_CONFIG = {
    "model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "max_position_embeddings": 32768, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-05, "sliding_window": None, "tie_word_embeddings": False,
    "num_local_experts": 8, "num_experts_per_tok": 2, "torch_dtype": "bfloat16"}
# Depth cut to 8 of the 32 layers since phases 17 and 18 joined the script
# (PERF.md §6) and to 4 since phases 3g-4g and 19 did, for its time limit:
# every check of phases 11 and 14 counts launches and router calls per
# layer, replays the run's own routing into the fp32 reference and reads
# its middle layer, at any depth.
MIXTRAL = dataclasses.replace(ModelConfig.from_hf_config(MIXTRAL_HF_CONFIG),
                              num_hidden_layers=4)
MIXTRAL_DIR = LOG_PATH.parent / "mixtral_ckpt"
MIXTRAL_NEW = 32
# A routing decision (the set of a token's top-2 experts in a layer) may
# differ between the card's bf16 path and the fp32 reference only where
# the reference's 2nd and 3rd probabilities are close: bf16 rounding moves
# each probability by at most max |dp|, so a flip needs a margin below
# 2 max |dp|.  Measured on the CPU (tests/test_torch_moe.py::
# test_bf16_routing_near_fp32_reference, printed with -s: a Mixtral-shaped
# model cut to hidden 1024 and 4 layers, bf16 against the fp32 reference on
# the same weights, 600 tokens): max |dp| 1.1e-2, 27 of 2400 decisions
# differ, at margins up to 3.8e-3; first-token logits 0.0173 from fp32, so
# phase 9b's 0.10 stands.  The limit is twice the 2 max |dp| reach, for the
# wider, deeper model: 0.05.  A flip at a wider margin is a routing fault.
MOE_FLIP_MARGIN_TOL = 0.05
# The decode gather and the dispatch against the dense all-expert form on
# one layer: one bf16 function whose products accumulate in fp32 in
# another order and round to bf16 at the same points, so outputs differ
# where a rounding goes the other way (2^-8 relative on an element): rel
# L2 ~1e-3.  Routing one token to a wrong expert moves its row by O(1)
# (measured beside the check).
MOE_FORMS_REL_L2_TOL = 1e-2
# 11c: a 2048-token shared prefix, then six requests of it plus their own
# tokens (2560 to 8048 in all, buckets 4096 and 8192), 2048-token chunks.
PREFIX_TOKENS, PREFIX_CHUNK = 2048, 2048
PREFIX_OWN = (6000, 1800, 4500, 3000, 1000, 512)
MIXTRAL_METHODS = ("h2o", "headkv", "cam", "random")
METHOD_PROMPT, METHOD_NEW = 6000, 8


def mixtral_w8a16(cfg, seed, experts=None):
    """Full-depth W8A16 weights drawn layer by layer from a seeded
    ``torch.Generator`` on the card: each layer's bf16 matrices (normal /
    sqrt(fan_in); the experts one at a time into the layer's stack) go
    through ``quantize_weights`` before the next layer is drawn, into int8
    stacks allocated once, so no bf16 copy of more than one layer exists.
    The router, norms and embedding stay bf16; lm_head is int8, as
    ``quantize_weights`` makes it.  With ``experts = (e0, n)`` (an ep
    rank's) every expert is still drawn, so the generator runs as for the
    whole model, and only experts ``[e0, e0 + n)`` are quantized and kept:
    a per-output-channel scale is per expert, so they are bitwise the
    whole model's."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h, f, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    e0, n_e = experts or (0, E)
    width = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * cfg.head_dim
    qd = cfg.num_attention_heads * cfg.head_dim
    bf16 = torch.bfloat16

    def draw(shape, out=None):
        x = torch.randn(shape, generator=g, device="cuda") / math.sqrt(shape[-2])
        return x.to(bf16) if out is None else out.copy_(x)
    shapes = {"qkv_proj": (h, width), "o_proj": (qd, h), "gate_up_proj": (E, h, 2 * f),
              "down_proj": (E, f, h)}
    kept = {k: (n_e,) + s[1:] if len(s) == 3 else s for k, s in shapes.items()}
    layers = {k: {"q": torch.empty((L,) + s, dtype=torch.int8, device="cuda"),
                  "s": torch.empty((L,) + s[:-2] + (1, s[-1]), device="cuda")}
              for k, s in kept.items()}
    layers["router"] = torch.empty((L, h, E), dtype=bf16, device="cuda")
    for li in range(L):
        one = {}
        for k, s in shapes.items():
            if len(s) == 3:
                one[k] = torch.empty(s, dtype=bf16, device="cuda")
                for e in range(E):
                    draw(s[1:], one[k][e])
                one[k] = one[k][e0:e0 + n_e]
            else:
                one[k] = draw(s)
        for k, w in quantize_weights({"layers": one}, skip=("lm_head",))["layers"].items():
            layers[k]["q"][li], layers[k]["s"][li] = w["q"], w["s"]
        del one
        draw((h, E), layers["router"][li])
    layers["input_norm"] = torch.ones((L, h), dtype=bf16, device="cuda")
    layers["post_norm"] = torch.ones((L, h), dtype=bf16, device="cuda")
    params = {"embed": draw((V, h)), "layers": layers,
              "final_norm": torch.ones((h,), dtype=bf16, device="cuda")}
    params["lm_head"] = quantize_weights({"layers": {}, "lm_head": draw((h, V))})["lm_head"]
    return params


def tree_bytes(tree):
    return sum(t.numel() * t.element_size() for _, t in flat_leaves(tree))


@contextlib.contextmanager
def routing_record(calls):
    """Wrap ``llama.moe_router``: append each call's (topi, fp32
    probabilities) to ``calls``, on the card (no host read)."""
    real = llama.moe_router

    def hooked(x, w, k):
        out = real(x, w, k)
        calls.append((out[1], torch.softmax(x.float() @ w.float(), dim=-1)))
        return out
    llama.moe_router = hooked
    try:
        yield calls
    finally:
        llama.moe_router = real


@contextlib.contextmanager
def routing_replay(tables, report):
    """Wrap ``llama.moe_router`` for the fp32 reference: the i-th call
    routes its tokens to ``tables[i]`` ``[T, k]`` (the card's choices), with
    ``topv`` this call's fp32 probabilities at those experts, renormalized;
    ``report`` gets each call's own (topi, probabilities)."""
    real, it = llama.moe_router, iter(tables)

    def hooked(x, w, k):
        _, own, _ = real(x, w, k)
        probs = torch.softmax(x.float() @ w.float(), dim=-1)
        topi = next(it).to(x.device).reshape(own.shape)
        topv = probs.gather(-1, topi)
        topv = topv / topv.sum(dim=-1, keepdim=True)
        report.append((own, probs))
        return torch.zeros_like(probs).scatter_(-1, topi, topv), topi, topv
    llama.moe_router = hooked
    try:
        yield report
    finally:
        llama.moe_router = real


def dense_moe(x, lp, cfg, combine=None):
    """JAX's dense all-expert form (``llama.py:267-272``): every expert on
    every token, weighted by the router's ``combine`` ``[B, T, E]`` cast to
    the activation dtype; a W8A16 leaf's scale after each product."""
    if combine is None:
        combine = llama.moe_router(x, lp["router"], cfg.num_experts_per_tok)[0]

    def ein(subs, a, w):
        s = w["s"].squeeze(-2)[None, :, None, :].to(a.dtype)
        return torch.einsum(subs, a, w["q"].to(a.dtype)) * s
    F_ = lp["gate_up_proj"]["q"].shape[-1] // 2
    gu = ein("bth,ehf->betf", x, lp["gate_up_proj"])
    eo = ein("betf,efh->beth", F.silu(gu[..., :F_]) * gu[..., F_:], lp["down_proj"])
    return torch.einsum("beth,bte->bth", eo, combine.to(x.dtype))


def moe_forms_check(rng, params):
    """On the middle layer: the decode gather at B = 1 and 4 (JAX gathers at B = 1
    and computes the dense form at B = 4) and the prefill dispatch over
    1024 tokens, each against the dense all-expert form, with what routing
    every token to its next expert would show."""
    cfg = MIXTRAL
    li = cfg.num_hidden_layers // 2
    lp = llama._layer(params, li)
    out = {}
    for label, shape in (("gather_b1", (1, 1)), ("gather_b4", (4, 1)),
                         ("dispatch_t1024", (1, 1024))):
        x = bf16_normal(rng, shape + (cfg.hidden_size,))
        with torch.no_grad():
            got, want = llama.moe_ffn(x, lp, cfg), dense_moe(x, lp, cfg)
            combine = llama.moe_router(x, lp["router"], cfg.num_experts_per_tok)[0]
            wrong = dense_moe(x, lp, cfg, combine.roll(1, dims=-1))
        rel, abs_err = rel_l2(got, want)
        out[label] = {"rel_l2": rel, "max_abs_err": abs_err,
                      "next_expert_rel_l2": rel_l2(wrong, want)[0]}
    log(f"  moe_ffn against the dense all-expert form on layer {li} (tol rel L2 "
        f"{MOE_FORMS_REL_L2_TOL}): " + "; ".join(
            f"{k} {v['rel_l2']:.2e} (max abs {v['max_abs_err']:.2e}; every token routed to its "
            f"next expert would show {v['next_expert_rel_l2']:.3f})" for k, v in out.items()))
    if any(v["rel_l2"] > MOE_FORMS_REL_L2_TOL or v["next_expert_rel_l2"] < 10 *
           MOE_FORMS_REL_L2_TOL for v in out.values()):
        raise SystemExit("moe_ffn disagrees with the dense form (or the check cannot see a "
                         "wrong expert)")
    return out


def host_syncs(fn):
    """What ``fn`` adds to ``host_reads``: the counts of ``fn(); sync()``
    less those of ``sync()`` alone."""
    base, with_fn = host_reads(lambda: None), host_reads(fn)
    return {k: with_fn[k] - base[k] for k in base}


def request_b_rows(calls, part, n_prompt, steps, L):
    """Request (b)'s (row 1's) rows of each layer's recorded ``part`` (0:
    topi, 1: probabilities): its prefill rows, then each decode step's."""
    return [torch.cat([calls[li][part][1, :n_prompt]]
                      + [calls[L + s * L + li][part][1] for s in range(steps)]) for li in range(L)]


def routing_check(card_i, card_p, report):
    """The card's routing of request (b) against the fp32 reference's own:
    the decisions that differ, the reference's margin (2nd minus 3rd
    probability) at each, and the card's max |dp| against the reference."""
    flips, margins, dp = 0, [], 0.0
    for ci, cp, (own, probs) in zip(card_i, card_p, report):
        differ = (ci.sort(-1).values != own[0].sort(-1).values).any(-1)
        top = probs[0].sort(-1, descending=True).values
        flips += int(differ.sum())
        margins += (top[:, 1] - top[:, 2])[differ].tolist()
        dp = max(dp, (cp - probs[0]).abs().max().item())
    return flips, margins, dp


def phase_mixtral_loader():
    """11a: a one-layer checkpoint at Mixtral's widths in the HF layout
    (``block_sparse_moe`` router and experts), read back by
    ``load_params``: every leaf bitwise equal to the tensors fused by hand,
    every byte read by the native reader."""
    hf_cfg = {**MIXTRAL_HF_CONFIG, "num_hidden_layers": 1}
    cfg = ModelConfig.from_hf_config(hf_cfg)
    log("== 11a loader: Mixtral-8x7B-Instruct-v0.1 widths, 1 of 32 layers, bf16, 2 shards")
    state = random_hf_state(cfg, seed=4, layer_shapes=mixtral_layer_shapes)
    t0 = time.perf_counter()
    nbytes = write_checkpoint(MIXTRAL_DIR, hf_cfg, state)
    write_s = time.perf_counter() - t0
    want = fused_in_memory(cfg, state)
    native.SafetensorsFile.bytes_read.update(native=0, python=0)
    sync()
    t0 = time.perf_counter()
    loaded, loaded_cfg = load_params(str(MIXTRAL_DIR), device="cuda")
    sync()
    load_s = time.perf_counter() - t0
    read = dict(native.SafetensorsFile.bytes_read)
    tensor_bytes = sum(t.numel() * t.element_size() for t in state.values())
    got, exp = dict(flat_leaves(loaded)), dict(flat_leaves(want))
    apart = sorted(k for k in exp if k not in got or got[k].dtype != exp[k].dtype
                   or got[k].shape != exp[k].shape or not torch.equal(got[k], exp[k]))
    log(f"  wrote {nbytes / 1e9:.3f} GB ({len(state)} tensors) in {write_s:.2f} s; load_params "
        f"read {tensor_bytes / 1e9:.3f} GB in {load_s:.3f} s; bytes by reader {read}; leaves "
        f"{sorted(got)}; gate_up {tuple(got['layers.gate_up_proj'].shape)}; not bitwise equal "
        f"to the hand fusion: {apart}; config equal {loaded_cfg == cfg}")
    if apart or sorted(got) != sorted(exp) or loaded_cfg != cfg:
        raise SystemExit("load_params disagrees with the Mixtral checkpoint's tensors")
    if read != {"native": tensor_bytes, "python": 0}:
        raise SystemExit("the native safetensors reader did not serve the Mixtral load")
    del state, want, loaded, got, exp
    shutil.rmtree(MIXTRAL_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"layers": 1, "bytes_on_disk": nbytes, "tensor_bytes": tensor_bytes,
            "write_s": write_s, "load_s": load_s, "bytes_by_reader": read,
            "leaves_bitwise_equal": True}


def phase_mixtral_engine(rng, params, prompts, log_file, ep_refs):
    """11b: phase 5's two requests through ``InferenceEngine`` (SnapKV, bf16
    cache, 32 new tokens) on the W8A16 model (4 of 32 layers), checked and timed;
    its ids and first-token logits kept in ``ep_refs``."""
    cfg, L, dev = MIXTRAL, MIXTRAL.num_hidden_layers, "cuda"
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=SNAPKV), device=dev)
    calls = []
    reset_counts()
    with routing_record(calls):
        ids, res = engine.generate_batch(prompts, MIXTRAL_NEW, return_result=True)
    sync()
    launches = path_launches()
    steps = MIXTRAL_NEW - 1
    expect = dict.fromkeys(launches, 0)
    expect["K1"], expect["K2"] = L, L * steps
    got = [sorted(set(res.cache.lengths[:, b].flatten().tolist())) for b in range(2)]
    want = [[min(len(p), SNAPKV.max_capacity_prompt) + steps] for p in prompts]
    log(f"== 11b W8A16 Mixtral through InferenceEngine (snapkv, bf16 cache, B=2): launches "
        f"{launches} (expect K1 {L}, K2 {L} x {steps}); cache lengths {got} (expect {want}); "
        f"router calls {len(calls)} (expect {L * MIXTRAL_NEW})")
    if launches != expect or got != want or len(calls) != L * MIXTRAL_NEW \
            or [len(x) for x in ids] != [MIXTRAL_NEW] * 2:
        raise SystemExit("the Mixtral run did not run each kernel the expected number of times, "
                         "or left wrong lengths")
    if not torch.isfinite(res.logits).all():
        raise SystemExit("the Mixtral run gave non-finite logits")
    ep_refs.update(ids=ids, logits=res.logits[:, 0].cpu())

    # Request (b) (1500 tokens: the no-compress branch) against the fp32
    # reference with the card's routing replayed.
    n_b = len(prompts[1])
    card_i = request_b_rows(calls, 0, n_b, steps, L)
    report = []
    with torch.no_grad(), routing_replay(card_i, report):
        seq = prompts[1] + ids[1][:steps]
        ref = forward_logits(params, cfg, torch.tensor([seq], device=dev))[0, n_b - 1:]
    flips, margins, dp = routing_check(card_i, request_b_rows(calls, 1, n_b, steps, L), report)
    rel_0, _ = rel_l2(res.logits[1, :1], ref[:1])
    rel_d, abs_d = rel_l2(res.logits[1, 1:], ref[1:])
    top1 = (res.logits[1].argmax(-1) == ref.argmax(-1)).float().mean().item()
    del ref, report
    log(f"  routing of request (b), {L} layers x {n_b + steps} tokens = {L * (n_b + steps)} "
        f"decisions: {flips} differ from the fp32 reference's own, at reference margins "
        f"(2nd - 3rd probability) up to {max(margins, default=0.0):.2e} (tol "
        f"{MOE_FLIP_MARGIN_TOL}); card's probabilities within {dp:.2e} of the reference's")
    log(f"  request (b) vs the fp32 reference (dequantized weights, card's routing replayed): "
        f"first token rel L2 {rel_0:.4f} (tol {E2E_REL_L2_TOL}), {steps} decode rows worst "
        f"{rel_d:.4f} (max abs {abs_d:.4f}); top-1 agreement {top1:.3f}")
    if any(m >= MOE_FLIP_MARGIN_TOL for m in margins):
        raise SystemExit("a routing decision flipped at a wide margin")
    if max(rel_0, rel_d) > E2E_REL_L2_TOL:
        raise SystemExit("the Mixtral run's logits disagree with the fp32 reference")
    forms = moe_forms_check(rng, params)

    # Times (runs without the routing hook), the host-read check and the
    # decode bound.
    t0 = time.perf_counter()
    engine.generate_batch(prompts, 1)
    sync()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.generate_batch(prompts, MIXTRAL_NEW)
    sync()
    step_ms = (time.perf_counter() - t0 - prefill_s) / steps * 1e3
    cur = torch.tensor([x[-1] for x in ids], device=dev)
    step = lambda: llama.decode_step(params, cfg, cur, res.cache)  # noqa: E731
    x1, lp1 = bf16_normal(rng, (2, 1, cfg.hidden_size)), llama._layer(params, L // 2)
    with torch.no_grad():
        step()
        reads = host_syncs(step)
        reads_moe = host_syncs(lambda: llama.moe_ffn(x1, lp1, cfg))
        one_step = []
        with routing_record(one_step):
            step()
        distinct = [len(set(t.flatten().tolist())) for t, _ in one_step]
        busy = profile_device(step, 4, step_ms, "decode step, Mixtral W8A16", log_file)
    log(f"  device-to-host copies, host scalar reads and stream / device synchronisations "
        f"added by a decode step {reads}, by one layer's moe_ffn at B=2 {reads_moe}")
    if reads["dtoh"] or reads["scalar_reads"] or any(reads_moe.values()):
        raise SystemExit("a Mixtral decode step reads the device from the host")
    lay = params["layers"]
    attn_bytes = tree_bytes({k: lay[k] for k in ("qkv_proj", "o_proj")})
    expert_bytes = tree_bytes({k: lay[k] for k in ("gate_up_proj", "down_proj")}) / (
        L * cfg.num_local_experts)
    head_bytes = tree_bytes({"lm_head": params["lm_head"]})
    small_bytes = tree_bytes({k: lay[k] for k in ("router", "input_norm", "post_norm")})
    cache_b = 2 * 2 * cfg.head_dim * int(res.cache.lengths.sum().item())
    bound_bytes = attn_bytes + sum(distinct) * expert_bytes + head_bytes + small_bytes + cache_b
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  prefill {prefill_s:.3f} s (B=2, 4096 + 1500 tokens); decode {step_ms:.3f} ms/step "
        f"wall, device busy {'not measured' if busy is None else f'{busy:.3f} ms'}; bound "
        f"{bound_ms:.3f} ms/step: {bound_bytes / 1e9:.3f} GB = attention {attn_bytes / 1e9:.3f} "
        f"+ {sum(distinct)} distinct experts (per layer {distinct}) x "
        f"{expert_bytes / 1e6:.1f} MB + lm_head {head_bytes / 1e9:.3f} + router and norms "
        f"{small_bytes / 1e9:.4f} + cache {cache_b / 1e9:.3f}, at {HBM_BYTES_PER_S / 1e12} TB/s")
    return {"launches": launches, "lengths": got, "routing_decisions": L * (n_b + steps),
            "routing_flips": flips, "flip_margin_max": max(margins, default=0.0),
            "flips_by_margin": {f"<{b:g}": sum(m < b for m in margins)
                                for b in (1e-4, 1e-3, 1e-2, MOE_FLIP_MARGIN_TOL)},
            "flip_margin_tol": MOE_FLIP_MARGIN_TOL, "card_vs_ref_max_dp": dp,
            "first_token_rel_l2": rel_0,
            "decode_rel_l2": rel_d, "top1_agreement": top1, "forms": forms,
            "prefill_s": prefill_s, "decode_ms_per_step": step_ms,
            "device_busy_ms_per_step": busy, "host_syncs_per_step": reads,
            "host_syncs_moe_ffn": reads_moe,
            "distinct_experts_per_layer": distinct, "bound_bytes": bound_bytes,
            "bound_ms_per_step": bound_ms}


@contextlib.contextmanager
def drain_routing(eng, calls, takes):
    """During a drain: every router call (``routing_record``), and for each
    ``chunk_step`` the index of its first call and which request each pool
    row serves at which chunk offset; ``takes`` gets the request of every
    one-row pool copy (a prefix snapshot's source among them)."""
    real_step, real_take = batching.chunk_step, batching._pool_take
    chunks = []

    def group_of(state):
        return next((g for g in eng._chunk_groups.values() if g["state"] is state), None)

    def step(params, model, toks, c0, tl, state, **kw):
        g = group_of(state)
        chunks.append((len(calls), {r: (m["rid"], int(g["c0"][r])) for r, m in g["rows"].items()}))
        return real_step(params, model, toks, c0, tl, state, **kw)

    def take(state, rows):
        g = group_of(state)
        if len(rows) == 1 and g is not None and rows[0] in g["rows"]:
            takes.append(g["rows"][rows[0]]["rid"])
        return real_take(state, rows)
    batching.chunk_step, batching._pool_take = step, take
    try:
        with routing_record(calls):
            yield chunks
    finally:
        batching.chunk_step, batching._pool_take = real_step, real_take


def prompt_routing(calls, chunks, rid, n, source=None, resume_at=0):
    """Request ``rid``'s prompt routing, one ``[n, k]`` table a layer, from
    its chunks' router calls (pool row, offset); a resumed request's rows
    below ``resume_at`` from the chunks of ``source``, whose snapshot it
    copied."""
    L, Sc = MIXTRAL.num_hidden_layers, PREFIX_CHUNK
    parts = {}
    for who, below in ((rid, None), (source, resume_at)):
        for start, rows in chunks:
            for r, (req, c0) in rows.items():
                if req == who and (below is None or c0 < below) and c0 not in parts:
                    parts[c0] = [calls[start + li][0][r] for li in range(L)]
    offsets = list(range(0, n, Sc))
    if sorted(parts)[:len(offsets)] != offsets:
        raise SystemExit(f"request {rid}'s chunks {sorted(parts)} do not cover its prompt")
    return [torch.cat([parts[c0][li] for c0 in offsets])[:n].cpu() for li in range(L)]


def replayed_first_logits(params, prompt, tables):
    """The fp32 reference's logits of a prompt's first generated token
    with ``tables`` (a run's routing) replayed, and the routing's flips
    against the reference's own (count, margins)."""
    report = []
    with torch.no_grad(), routing_replay(tables, report):
        ref = forward_logits(params, MIXTRAL, torch.tensor([prompt], device="cuda"))[0, -1].cpu()
    flips, margins, _ = routing_check([t.to("cuda") for t in tables],
                                      [p[0] for _, p in report], report)
    return ref, flips, margins


def mixtral_drain(params, prompts, comp=None, prefix=None, head_cap=None, new=None,
                  routing=False):
    """One chunked-admission drain through ``ContinuousBatchingEngine`` (4
    slots, buckets 4096 / 8192, 2048-token chunks), every launch count set
    to 0 just before ``run`` and read just after; records which requests
    resumed from a prefix snapshot and the snapshot bytes after each store.
    With ``routing`` also every request's prompt routing
    (:func:`prompt_routing`)."""
    L = MIXTRAL.num_hidden_layers
    comp, new = comp or SNAPKV, new or MIXTRAL_NEW
    eng = ContinuousBatchingEngine(
        params, EngineConfig(model=MIXTRAL, compression=comp, prefill_buckets=SERVE_BUCKETS),
        n_slots=4, max_new_cap=new, chunk_size=16, prefill_chunk_tokens=PREFIX_CHUNK,
        head_capacity=head_cap, device="cuda", instrument=True)
    resumed, snap_bytes = [], []
    calls, takes, sources = [], [], {}
    admit, store = eng._admit_chunked, eng._store_prefix_snapshot

    def admit_hook(slot, rid, bucket):
        admit(slot, rid, bucket)
        g = eng._chunk_groups[bucket]
        if any(m["rid"] == rid and g["c0"][r] for r, m in g["rows"].items()):
            resumed.append(rid)
            sources[rid] = sources.get("snapshot")

    def store_hook(key, state):
        store(key, state)
        snap_bytes.append(eng._prefix_state_bytes())
        sources["snapshot"] = takes[-1] if takes else None
    eng._admit_chunked, eng._store_prefix_snapshot = admit_hook, store_hook
    if prefix is not None:
        eng.cache_prefix(prefix)
    rids = [eng.submit(p, new) for p in prompts]
    reset_counts()
    t0 = time.perf_counter()
    with drain_routing(eng, calls, takes) if routing else contextlib.nullcontext() as chunks:
        out = eng.run()
    sync()
    wall = time.perf_counter() - t0
    # The hooks hold the engine: drop them, or the cycle keeps its pools
    # and cache on the card until the garbage collector runs.
    del eng._admit_chunked, eng._store_prefix_snapshot
    launches = path_launches()
    expect = dict.fromkeys(launches, 0)
    expect["K1-chunk"], expect["K2"] = L * eng.prefill_chunk_dispatches, L * eng.steps_executed
    if launches != expect or any(len(out[r]) != new for r in rids):
        raise SystemExit(f"a Mixtral drain ran kernels {launches}, expected {expect}, or "
                         "produced the wrong token counts")
    stalls = eng.admission_stalls_s
    tables = None
    if routing:
        resume_at = PREFIX_TOKENS // PREFIX_CHUNK * PREFIX_CHUNK
        tables = [prompt_routing(calls, chunks, rid, len(p), sources.get(rid),
                                 resume_at if rid in sources else 0)
                  for rid, p in zip(rids, prompts)]
        del calls
    return {"engine": eng, "rids": rids, "tokens": [out[r] for r in rids],
            "logits": [torch.stack(eng.logits[r]) for r in rids], "routing": tables,
            "resumed": [rids.index(r) for r in resumed], "snapshot_bytes": snap_bytes,
            "summary": {"wall_s": wall, "decode_steps": eng.steps_executed,
                        "chunk_dispatches": eng.prefill_chunk_dispatches,
                        "row_chunks": eng.prefill_chunks_executed,
                        "longest_stall_s": max(stalls), "stalls_s": stalls,
                        "drain_decode_ms_per_step":
                            (wall - sum(stalls)) / eng.steps_executed * 1e3,
                        "launches": launches}}


def phase_mixtral_serving(rng, params):
    """11c: prefix caching and the newly served methods at Mixtral widths."""
    cfg, L, H = MIXTRAL, MIXTRAL.num_hidden_layers, MIXTRAL.num_attention_heads
    prefix = rng.integers(0, cfg.vocab_size, size=PREFIX_TOKENS).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size, size=n).tolist() for n in PREFIX_OWN]
    cold = mixtral_drain(params, prompts, routing=True)
    del cold["engine"]
    warm = mixtral_drain(params, prompts, prefix=prefix, routing=True)
    eng = warm.pop("engine")
    skipped = cold["summary"]["row_chunks"] - warm["summary"]["row_chunks"]
    lens = sorted(set(eng.cache.lengths.flatten().tolist()))
    budget = eng._prefix_cache_bytes
    bitwise, worst, max_abs, parted = True, 0.0, 0.0, []
    for i in warm["resumed"]:
        a, b = warm["logits"][i][:1], cold["logits"][i][:1]
        bitwise &= torch.equal(a, b)
        e, m = rel_l2(a, b)
        worst, max_abs = max(worst, e), max(max_abs, m)
    for i in warm["resumed"]:
        apart = [j for j, (x, y) in enumerate(zip(warm["tokens"][i], cold["tokens"][i]))
                 if x != y]
        if apart:
            j = apart[0]
            top2 = cold["logits"][i][j].topk(2).values
            parted.append({"request": i, "step": j, "top2_gap": (top2[0] - top2[1]).item()})
    s = warm["summary"]
    log(f"== 11c serving, prefix {PREFIX_TOKENS} tokens + own {PREFIX_OWN}, {MIXTRAL_NEW} new "
        f"each, 4 slots, buckets {SERVE_BUCKETS}, {PREFIX_CHUNK}-token chunks: requests "
        f"{warm['resumed']} resumed from a snapshot; row-chunks {s['row_chunks']} against "
        f"{cold['summary']['row_chunks']} cold ({skipped} skipped); snapshot bytes after each "
        f"store {warm['snapshot_bytes']} (budget {budget}); live snapshots "
        f"{[(b, len(k)) for b, k in eng._prefix_states]}; slot lengths {lens}")
    # Each run against the fp32 reference with its own routing replayed: a
    # resume reaches another pool's per-expert GEMM shapes, so a router
    # near-tie may go the other way and the two runs compute two functions
    # (PERF.md §6: 0.13-0.21 apart on three of eight prompt seeds, each
    # 0.015-0.016 from its own reference).
    fp32 = []
    for i in warm["resumed"]:
        for name, run in (("cold", cold), ("resumed", warm)):
            ref, flips, margins = replayed_first_logits(params, prompts[i], run["routing"][i])
            fp32.append({"request": i, "run": name,
                         "rel_l2": rel_l2(run["logits"][i][:1], ref[None])[0],
                         "flips": flips, "flip_margin_max": max(margins, default=0.0)})
    log(f"  resumed requests' first-token logits against the cold drain's (printed, not "
        f"held: each run is held to its own function below): bitwise equal {bitwise}, worst "
        f"rel L2 {worst:.2e}, max abs {max_abs:.2e}; streams parted {parted}")
    log(f"  each resumed request's cold and resumed first token against the fp32 reference "
        f"with that run's routing replayed (tol {E2E_REL_L2_TOL}; flips against the "
        f"reference's own routing at margins under {MOE_FLIP_MARGIN_TOL}): " + "; ".join(
            f"{f['request']} {f['run']} {f['rel_l2']:.4f} ({f['flips']} flips, margins up to "
            f"{f['flip_margin_max']:.2e})" for f in fp32))
    log(f"  drain {s['wall_s']:.3f} s wall (cold {cold['summary']['wall_s']:.3f} s), "
        f"{s['decode_steps']} decode steps, longest admission stall {s['longest_stall_s']:.4f} s "
        f"(cold {cold['summary']['longest_stall_s']:.4f} s), decode "
        f"{s['drain_decode_ms_per_step']:.3f} ms/step; launches {s['launches']}")
    if not warm["resumed"] or skipped != len(warm["resumed"]) * (PREFIX_TOKENS // PREFIX_CHUNK):
        raise SystemExit("no admission resumed from the prefix, or the skipped chunks do not "
                         "match the resumes")
    if max(warm["snapshot_bytes"]) > budget or eng._prefix_state_bytes() > budget:
        raise SystemExit("prefix snapshots exceeded prefix_cache_bytes")
    if any(f["rel_l2"] > E2E_REL_L2_TOL or f["flip_margin_max"] >= MOE_FLIP_MARGIN_TOL
           for f in fp32):
        raise SystemExit("a cold or resumed admission disagrees with the fp32 reference of "
                         "its own routing")
    if parted and bitwise:
        raise SystemExit("a resumed stream parted from the cold one after bitwise equal "
                         "first-token logits")
    if lens != [SNAPKV.max_capacity_prompt + MIXTRAL_NEW - 1]:
        raise SystemExit("the prefix drain left wrong cache lengths")
    out = {"prefix_tokens": PREFIX_TOKENS, "own_tokens": list(PREFIX_OWN),
           "resumed": warm["resumed"], "row_chunks_skipped": skipped,
           "snapshot_bytes": warm["snapshot_bytes"], "prefix_cache_bytes": budget,
           "resumed_first_token_bitwise": bitwise, "resumed_first_token_rel_l2": worst,
           "first_token_vs_replayed_fp32": fp32, "parted": parted, "warm": s,
           "cold": cold["summary"]}
    del eng, warm, cold
    torch.cuda.empty_cache()

    # The methods the engine now serves, one 6000-token request each
    # (bucket 8192) through chunked admission, against the one-shot engine.
    head_cap = headkv_file(LOG_PATH.parent / "policies" / "mixtral_heads.json", cfg, seed=3)
    prompt = rng.integers(0, cfg.vocab_size, size=METHOD_PROMPT).tolist()
    bucket = SERVE_BUCKETS[-1]
    out["methods"] = {}
    for method in MIXTRAL_METHODS:
        comp = dataclasses.replace(SNAPKV, method=method)
        hc = head_cap if method == "headkv" else None
        d = mixtral_drain(params, [prompt], comp=comp, head_cap=hc, new=METHOD_NEW)
        eng = d.pop("engine")
        store = eng._chunk_groups[bucket]["state"][2]
        store_bytes = store.numel() * store.element_size()
        slot = int(eng.cache.lengths[0, :, 0].argmax())
        got = eng.cache.lengths[:, slot].cpu().numpy()
        want = expected_lengths(method, comp, L, H, head_cap, bucket) + METHOD_NEW - 1
        one = InferenceEngine(params, EngineConfig(model=cfg, compression=comp,
                                                   prefill_buckets=SERVE_BUCKETS),
                              device="cuda", head_capacity=hc)
        _, res = one.generate_batch([prompt], 1, return_result=True)
        rel, _ = rel_l2(d["logits"][0][:1], res.logits[0, :1].cpu())
        rows = None
        if method == "random":
            # The selection is the draw alone, so both caches keep the same
            # rows; layer 0's keys are a function of each token alone (two
            # bf16 computations of it); rows one place apart show what a
            # wrong row would.
            n = SNAPKV.max_capacity_prompt
            rows = rel_l2(eng.cache.k[0, slot, :, :n], res.cache.k[0, 0, :, :n])[0]
            shifted = rel_l2(eng.cache.k[0, slot, :, 1:n], res.cache.k[0, 0, :, :n - 1])[0]
        log(f"  {method}: chunked admission launches {d['summary']['launches']}; lengths "
            f"{'equal to' if np.array_equal(got, want) else 'NOT equal to'} the rule (range "
            f"{int(got.min())}-{int(got.max())}); first-token logits against the one-shot "
            f"engine rel L2 {rel:.4f} (tol {CHUNKED_VS_ONESHOT_TOL})"
            f"{'' if rows is None else f'; layer 0 kept rows against the one-shot cache, worst row rel L2 {rows:.2e} (tol {PAIR_REL_L2_TOL}; rows one place apart {shifted:.3f})'}; "
            f"query store {tuple(store.shape)} {store_bytes / 1e9:.3f} GB; card memory "
            f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        if not np.array_equal(got, want) or rel > CHUNKED_VS_ONESHOT_TOL or \
                (rows is not None and (rows > PAIR_REL_L2_TOL or shifted < 10 * PAIR_REL_L2_TOL)):
            raise SystemExit(f"{method} through chunked admission disagrees with its rule or "
                             "with the one-shot engine")
        out["methods"][method] = {"launches": d["summary"]["launches"],
                                  "first_token_rel_l2": rel, "kept_rows_rel_l2": rows,
                                  "query_store_bytes": store_bytes,
                                  "wall_s": d["summary"]["wall_s"]}
        del eng, d, one, res, store
        torch.cuda.empty_cache()
    return out


def expert_checksums(params):
    """Each (layer, expert) of the stacks held: the sums of ``gate_up_proj``'s
    and ``down_proj``'s ``q`` (exact in int64) and ``s`` (fp64), ``[L, n,
    4]`` fp64 on the host."""
    lay = params["layers"]
    L, n = lay["gate_up_proj"]["q"].shape[:2]
    out = torch.empty((L, n, 4), dtype=torch.float64)
    for li in range(L):
        for e in range(n):
            out[li, e] = torch.stack([
                lay[k][part][li, e].sum(dtype=torch.int64 if part == "q" else torch.float64)
                .double() for k in ("gate_up_proj", "down_proj") for part in ("q", "s")]).cpu()
    return out


def phase_mixtral(rng, prompts, log_file, ep_refs):
    """Phase 11: Mixtral-8x7B-Instruct-v0.1 widths.  Fills ``ep_refs`` for
    phase 14: every (layer, expert)'s checksums and 11b's ids and
    first-token logits."""
    t_phase = time.perf_counter()
    out = {"model": "Mixtral-8x7B-Instruct-v0.1 widths, random W8A16 weights (seed 5)",
           "loader": phase_mixtral_loader()}
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = mixtral_w8a16(MIXTRAL, seed=5)
    sync()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_bytes = tree_bytes(params)
    log(f"== 11b {MIXTRAL.num_hidden_layers} of 32 layers: {n_bytes / 1e9:.3f} GB of W8A16 "
        f"weights built layer by layer in "
        f"{build_s:.1f} s; allocated before {before / 1e9:.2f} GB, peak during the build "
        f"{peak / 1e9:.2f} GB")
    out.update(weight_bytes=n_bytes, build_s=build_s, build_peak_bytes=peak)
    out["engine"] = phase_mixtral_engine(rng, params, prompts, log_file, ep_refs)
    ep_refs["checksums"] = expert_checksums(params)
    torch.cuda.empty_cache()
    out["serving"] = phase_mixtral_serving(rng, params)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11: {out['phase_s']:.1f} s")
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 14: expert parallelism (ep) at Mixtral-8x7B-Instruct-v0.1 widths
# ---------------------------------------------------------------------------

EP = 2


def ep_rank(rank, n, directory):
    """One ep rank of phase 14 (a spawned process sharing this card): its
    ``E / n`` experts a layer, built by replaying phase 11's generator
    (``mixtral_w8a16(..., experts=)``) one rank at a time, and their
    checksums; then phase 11b's requests through
    ``InferenceEngine(ShardingConfig(ep=n))``, every launch and collective
    count set to 0 just before it and read just after, the routing
    recorded; request (b) against the fp32 reference with that routing
    replayed (the reference's MoE block summed over the ranks, so no rank
    holds the whole model); K2 on the first and last layer of the rank's cache
    against its plain version; a prefill alone, the whole request, and
    the device busy time of decode steps that every rank runs together
    (rank 0 profiled)."""
    job = rank_setup(rank, n, directory)
    t0 = time.perf_counter()
    try:
        cfg, L, dev = MIXTRAL, MIXTRAL.num_hidden_layers, "cuda"
        n_e = cfg.num_local_experts // n
        for r in range(n):
            if r == rank:
                params = mixtral_w8a16(cfg, seed=5, experts=(rank * n_e, n_e))
                sums = expert_checksums(params)
                torch.cuda.empty_cache()
            dist.barrier()
        weights_s = time.perf_counter() - t0
        prompts = job["prompts"]
        engine = InferenceEngine(params, EngineConfig(model=cfg, compression=SNAPKV,
                                                      sharding=ShardingConfig(ep=n)), device=dev)
        group = engine.experts.group
        calls = []
        reset_counts()
        group.reset_counts()
        dist.barrier()
        t0 = time.perf_counter()
        with routing_record(calls):
            ids, res = engine.generate_batch(prompts, MIXTRAL_NEW, return_result=True)
        sync()
        run_s = time.perf_counter() - t0
        lens = res.cache.lengths
        result = {"rank": rank, "checksums": sums, "launches": path_launches(),
                  "counts_run": group_counts(group), "run_s": run_s, "weights_s": weights_s,
                  "shard_bytes": tree_bytes(params), "ids": ids, "logits": res.logits[:, 0].cpu(),
                  "heads": lens.shape[2], "router_calls": len(calls),
                  "lengths": [sorted(set(lens[:, b].flatten().tolist()))
                              for b in range(lens.shape[1])]}
        steps, n_b = MIXTRAL_NEW - 1, len(prompts[1])
        card_i = request_b_rows(calls, 0, n_b, steps, L)
        card_p = request_b_rows(calls, 1, n_b, steps, L)
        del calls
        report = []
        with torch.no_grad(), routing_replay(card_i, report):
            seq = prompts[1] + ids[1][:steps]
            ref = forward_logits(params, cfg, torch.tensor([seq], device=dev),
                                 ep=engine.experts)[0, n_b - 1:]
        flips, margins, dp = routing_check(card_i, card_p, report)
        result.update(routing_flips=flips, flip_margins=margins, card_vs_ref_max_dp=dp,
                      routing_decisions=L * (n_b + steps),
                      first_token_rel_l2=rel_l2(res.logits[1, :1], ref[:1])[0],
                      decode_rel_l2=rel_l2(res.logits[1, 1:], ref[1:])[0],
                      routing=[t.cpu() for t in card_i])
        del ref, report, card_i, card_p
        result["direct_rel_l2"] = direct_decode_check(np.random.default_rng(rank), res.cache,
                                                      None, f"ep rank {rank}")
        group.reset_counts()
        dist.barrier()
        t0 = time.perf_counter()
        engine.generate_batch(prompts, 1)
        sync()
        result.update(prefill_s=time.perf_counter() - t0, counts_prefill=group_counts(group))
        result["decode_ms_per_step"] = (run_s - result["prefill_s"]) / steps * 1e3
        cur = torch.tensor([x[-1] for x in ids], device=dev)
        result["decode_busy_ms"] = grid_decode_busy(rank, engine, res.cache, cur, None)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(directory) / f"rank{rank}.pt")


def phase_ep(prompts, ep_refs, busy_11b):
    """Phase 14: phase 11b's requests (snapkv, 32 new) at Mixtral widths
    with W8A16 experts on two ep ranks sharing this card over gloo (the
    MoE block's output staged through pinned host memory), after phase 11
    has freed its weights: each rank's experts bitwise phase 11's (the
    checksums of every (layer, expert)), launches, lengths, ranks equal,
    request (b) against the fp32 reference with the run's own routing
    replayed, flips only at near-ties, the distance from 11b's
    single-device run and the decode step beside 11b's."""
    cfg, L = MIXTRAL, MIXTRAL.num_hidden_layers
    n_e = cfg.num_local_experts // EP
    log(f"== phase 14: ep={EP} at Mixtral-8x7B-Instruct-v0.1 widths (W8A16, {n_e} experts a "
        f"layer on each rank), ranks sharing this card over gloo")
    ranks, spawn_s, load_s = spawn_grid("14", EP, {"prompts": prompts}, fn=ep_rank)
    steps = MIXTRAL_NEW - 1
    want_launches = {"K1": L, "K2": L * steps}
    want_lengths = [[min(len(p), SNAPKV.max_capacity_prompt) + steps] for p in prompts]
    for r, rk in enumerate(ranks):
        own = ep_refs["checksums"][:, r * n_e:(r + 1) * n_e]
        bitwise = torch.equal(rk["checksums"], own)
        launches = {k: v for k, v in rk["launches"].items() if v}
        log(f"14 rank {r}: experts [{r * n_e}, {(r + 1) * n_e}) a layer, {rk['shard_bytes'] / 1e9:.2f}"
            f" GB held (built in {rk['weights_s']:.1f} s); checksums of every (layer, expert) "
            f"equal to phase 11's: {bitwise}; launches {launches} (expect {want_launches}); "
            f"lengths {rk['lengths']} (expect {want_lengths}); router calls {rk['router_calls']} "
            f"(expect {L * MIXTRAL_NEW})")
        if not bitwise:
            raise SystemExit(f"ep rank {r}'s experts are not phase 11's")
        if launches != want_launches or rk["lengths"] != want_lengths or \
                rk["router_calls"] != L * MIXTRAL_NEW or rk["heads"] != cfg.num_attention_heads:
            raise SystemExit(f"ep rank {r}: launches, lengths or router calls against the run")
        margins = rk["flip_margins"]
        log(f"14 rank {r}: request (b)'s routing, {rk['routing_decisions']} decisions: "
            f"{rk['routing_flips']} differ from the fp32 reference's own, at margins up to "
            f"{max(margins, default=0.0):.2e} (tol {MOE_FLIP_MARGIN_TOL}); against the fp32 "
            f"reference with its routing replayed: first token rel L2 "
            f"{rk['first_token_rel_l2']:.4f} (tol {E2E_REL_L2_TOL}), {steps} decode rows worst "
            f"{rk['decode_rel_l2']:.4f}; K2 direct worst rel L2 {rk['direct_rel_l2'][0]:.2e}")
        if any(m >= MOE_FLIP_MARGIN_TOL for m in margins):
            raise SystemExit("ep: a routing decision flipped at a wide margin")
        if max(rk["first_token_rel_l2"], rk["decode_rel_l2"]) > E2E_REL_L2_TOL:
            raise SystemExit("ep: logits disagree with the fp32 reference")
    agree = all(rk["ids"] == ranks[0]["ids"] and torch.equal(rk["logits"], ranks[0]["logits"])
                and all(torch.equal(a, b) for a, b in zip(rk["routing"], ranks[0]["routing"]))
                for rk in ranks)
    rel_single, absd = rel_l2(ranks[0]["logits"], ep_refs["logits"])
    same_ids = ranks[0]["ids"] == ep_refs["ids"]
    log(f"14: ranks agree (ids, first-token logits and routing bitwise) {agree}; first-token "
        f"logits against 11b's single-device run rel L2 {rel_single:.4f} (max abs {absd:.4f}); "
        f"ids equal to 11b's {same_ids}")
    if not agree:
        raise SystemExit("ep: the ranks disagree")
    summary = {"ep": EP, "ranks_agree": agree, "first_token_rel_l2_vs_11b": rel_single,
               "ids_equal_11b": same_ids, "spawn_to_join_s": spawn_s, "load_s": load_s,
               "decode_busy_ms_11b": busy_11b, "ranks": []}
    for r, rk in enumerate(ranks):
        pre, tot = rk["counts_prefill"], rk["counts_run"]
        per_step = {k: (tot[k] - pre[k]) / steps for k in tot}
        busy = rk["decode_busy_ms"]
        log(f"14 rank {r}: prefill {rk['prefill_s']:.3f} s wall, {pre['collectives']} "
            f"reductions, {pre['staged_bytes'] / 1e9:.3f} GB staged in {pre['staged_s']:.3f} s; "
            f"decode {rk['decode_ms_per_step']:.3f} ms/step wall, busy "
            f"{'not measured' if busy is None else f'{busy:.3f} ms'} (11b single device "
            f"{'not measured' if busy_11b is None else f'{busy_11b:.3f} ms'}); per step "
            f"{per_step['collectives']:.1f} reductions, {per_step['staged_bytes'] / 1e3:.3f} kB "
            f"staged in {per_step['staged_s'] * 1e3:.2f} ms")
        keep = ("launches", "lengths", "run_s", "weights_s", "shard_bytes", "prefill_s",
                "decode_ms_per_step", "decode_busy_ms", "counts_prefill", "counts_run",
                "direct_rel_l2", "routing_flips", "routing_decisions", "card_vs_ref_max_dp",
                "first_token_rel_l2", "decode_rel_l2")
        summary["ranks"].append({k: rk[k] for k in keep})
        summary["ranks"][-1].update(counts_per_step=per_step,
                                    flip_margin_max=max(rk["flip_margins"], default=0.0))
    return summary


# ---------------------------------------------------------------------------
# Phase 16: Llama-3.2-1B-Instruct (head_dim 64); 16b: a head_dim 256 model
# ---------------------------------------------------------------------------

# The fields the forward reads from the published config.json of
# meta-llama/Llama-3.2-1B-Instruct (bf16 weights, tied embeddings, llama3
# rope scaling).
LLAMA32_1B_HF_CONFIG = {
    "model_type": "llama", "vocab_size": 128256, "hidden_size": 2048,
    "intermediate_size": 8192, "num_hidden_layers": 16, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64, "max_position_embeddings": 131072,
    "rope_theta": 500000.0,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "rms_norm_eps": 1e-05, "tie_word_embeddings": True, "torch_dtype": "bfloat16"}
# Depth cut to 8 of its 16 layers since phases 3g-4g and 19 joined the
# script, to 4 since phases 3h-4h and 20 did (phase 20 runs OpenLLaMA-3B at
# full depth), for its time limit: the checks count launches per layer and
# hold the logits to the fp32 reference at any depth.
LLAMA32_1B = dataclasses.replace(ModelConfig.from_hf_config(LLAMA32_1B_HF_CONFIG),
                                 num_hidden_layers=4)
# A 2-layer model (4 until phases 3h-4h and 20 joined the script) at
# head_dim 256 (hidden 4096 = 16 x 256, 4 KV heads, G 4):
# no public Llama / Mistral / Qwen2 / Mixtral model has this head_dim; it
# runs K1-K4 at 256 in the model.
D256_MODEL = ModelConfig.from_hf_config({
    "model_type": "llama", "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 2, "num_attention_heads": 16,
    "num_key_value_heads": 4, "head_dim": 256, "max_position_embeddings": 32768,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-05, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16"})
LLAMA32_DRAIN_PROMPTS = 4      # requests of 4096 tokens
LLAMA32_DRAIN_NEW = 16
LLAMA32_DRAIN_CHUNK = 2048


def count_params(params):
    return sum(t.numel() for t in [params["embed"], params["final_norm"], params["lm_head"]]
               + list(params["layers"].values()))


def chunked_drain(params, rng, cfg, label, prompt_len=4096, comp=SNAPKV,
                  chunk=LLAMA32_DRAIN_CHUNK):
    """Four requests of ``prompt_len`` tokens (4096 by default) through
    ``ContinuousBatchingEngine`` with chunked admission (2048-token chunks
    by default; K1-chunk at the model's head_dim: 64 for Llama-3.2-1B, 80
    for phase 19's h2o-danube2-1.8b, 100 for phase 20's OpenLLaMA-3B),
    every launch count set to 0 just before ``run``: launches, lengths,
    each request's first-token logits against the fp32 reference."""
    L = cfg.num_hidden_layers
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()
               for _ in range(LLAMA32_DRAIN_PROMPTS)]
    bucket = next(b for b in EngineConfig.prefill_buckets if b >= prompt_len)
    eng = ContinuousBatchingEngine(
        params, EngineConfig(model=cfg, compression=comp, prefill_buckets=(bucket,)),
        n_slots=4, max_new_cap=LLAMA32_DRAIN_NEW, chunk_size=16,
        prefill_chunk_tokens=chunk, device="cuda", instrument=True)
    rids = [eng.submit(p, LLAMA32_DRAIN_NEW) for p in prompts]
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.run()
    sync()
    wall = time.perf_counter() - t0
    launches = path_launches()
    expect = dict.fromkeys(launches, 0)
    expect["K1-chunk"] = L * eng.prefill_chunk_dispatches
    expect["K2"] = L * eng.steps_executed
    log(f"{label} drain: {len(prompts)} x {prompt_len} tokens, {LLAMA32_DRAIN_NEW} new, chunks "
        f"of {chunk}: {wall:.3f} s, {eng.steps_executed} decode steps, "
        f"{eng.prefill_chunk_dispatches} chunk dispatches; launches {launches}, expect {expect}")
    if launches != expect or expect["K1-chunk"] == 0:
        raise SystemExit(f"the {label} drain did not run each kernel the expected number of times")
    got = sorted(sorted(set(eng.cache.lengths[:, b].flatten().tolist())) for b in range(4))
    want = [[min(prompt_len, comp.max_capacity_prompt) + LLAMA32_DRAIN_NEW - 1]] * 4
    if got != want or any(len(outs[r]) != LLAMA32_DRAIN_NEW for r in rids):
        raise SystemExit(f"the {label} drain left lengths {got} (expect {want}) or wrong "
                         "token counts")
    worst = 0.0
    with torch.no_grad():
        for r, p in zip(rids, prompts):
            ref = forward_logits(params, cfg, torch.tensor([p], device="cuda"))[0, -1]
            worst = max(worst, rel_l2(eng.logits[r][0][None].cuda().float(), ref[None])[0])
            del ref
    log(f"{label} drain: cache lengths {got}; first-token logits against the fp32 reference: worst "
        f"rel L2 {worst:.4f} (tol {E2E_REL_L2_TOL})")
    if worst > E2E_REL_L2_TOL:
        raise SystemExit(f"the {label} drain's first tokens disagree with the fp32 reference")
    out = {"launches": launches, "drain_s": wall, "decode_steps": eng.steps_executed,
           "chunk_dispatches": eng.prefill_chunk_dispatches, "first_token_rel_l2": worst,
           "longest_stall_s": max(eng.admission_stalls_s), "lengths": got}
    del eng
    torch.cuda.empty_cache()
    return out


def phase_llama32(rng, prompts, log_file):
    """Phase 16: Llama-3.2-1B-Instruct at full width (4 of its 16 layers;
    random bf16 weights, seed 4, lm_head tied to the embedding), phase 5's
    requests through ``InferenceEngine`` with snapkv (K1 8 a prefill, K2 at
    G 1) and fullkv (K2 at G 4 on 8 KV heads), each checked as phase 5's
    paths are (launches, lengths, logits against the fp32 reference, K2
    called directly on its first and last layer, times, a profiled decode
    step); then a chunked drain (K1-chunk at head_dim 64)."""
    cfg = LLAMA32_1B
    t0 = time.perf_counter()
    params = init_params(cfg, seed=4, device="cuda")
    params["lm_head"] = params["embed"].T.contiguous()  # tie_word_embeddings
    sync()
    n_params = count_params(params) - params["lm_head"].numel()  # tied: one matrix
    log(f"== 16 Llama-3.2-1B-Instruct ({cfg.num_hidden_layers} of 16 layers, hidden 2048, 32 / 8 heads of 64, vocab "
        f"128256, llama3 rope scaling, tied embeddings): {n_params / 1e9:.3f} B parameters, "
        f"random bf16 (seed 4), in {time.perf_counter() - t0:.1f} s")
    model = (f"Llama-3.2-1B-Instruct widths ({cfg.num_hidden_layers} of 16 layers), random "
             "weights (seed 4), tied embeddings")
    out = {"model": model, "parameters": n_params}
    for name, comp in (("snapkv", SNAPKV), ("fullkv", CompressionConfig(method="fullkv"))):
        # drive_path counts the weight bytes a step reads: the layers' and
        # the lm_head's (the embedding is gathered by row).
        out[name] = drive_path(params, count_params(params), prompts, None, log_file, cfg=cfg,
                               comp=comp, model=model, direct_rng=rng)
        log(f"16 {name}: greedy streams (a) {out[name]['tokens'][0][:16]} ..., (b) "
            f"{out[name]['tokens'][1][:16]} ...")
    out["drain"] = chunked_drain(params, np.random.default_rng(16), LLAMA32_1B, "16")
    del params
    torch.cuda.empty_cache()
    return out


def phase_d256(rng, prompts, log_file):
    """Phase 16b: the 2-layer head_dim 256 model (random bf16 weights, seed
    6), phase 5's requests through ``InferenceEngine`` with snapkv over the
    bf16, int8 and int4 caches (K1 and K2, K3, K4 at head_dim 256), each
    checked as phase 5's paths are: limits 0.10 (bf16, int8) and 0.40
    (int4)."""
    cfg = D256_MODEL
    t0 = time.perf_counter()
    params = init_params(cfg, seed=6, device="cuda")
    sync()
    n_params = count_params(params)
    log(f"== 16b head_dim 256 model (2 layers, hidden 4096, 16 / 4 heads of 256, ffn 14336, "
        f"vocab 32000): {n_params / 1e9:.3f} B parameters, random bf16 (seed 6), in "
        f"{time.perf_counter() - t0:.1f} s")
    model = "head_dim 256 model (2 layers, 16 / 4 heads), random weights (seed 6)"
    out = {label: drive_path(params, n_params, prompts, quant, log_file, cfg=cfg, model=model,
                             direct_rng=rng)
           for label, quant in PATHS}
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 19 and 19b: head_dim 80 (h2o-danube2-1.8b), 384 and 512
# ---------------------------------------------------------------------------

# The fields the forward reads from the published config.json of
# h2oai/h2o-danube2-1.8b-chat (MistralForCausalLM; bf16 weights, untied
# lm_head, no sliding window): head_dim 2560 / 32 = 80, which the JAX
# package serves on its XLA path and K1 / K2 run on their 128 instantiation.
# Full depth: 1.832 G parameters, 3.66 GB in bf16.
DANUBE2_HF_CONFIG = {
    "model_type": "mistral", "vocab_size": 32000, "hidden_size": 2560,
    "intermediate_size": 6912, "num_hidden_layers": 24, "num_attention_heads": 32,
    "num_key_value_heads": 8, "max_position_embeddings": 8192, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-05, "sliding_window": None, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16"}
# Depth cut to 8 of its 24 layers since phases 3h-4h and 20 joined the
# script (phase 20 runs OpenLLaMA-3B at full depth), for its time limit: the
# checks count launches per layer and hold the logits to the fp32 reference
# at any depth.
DANUBE2 = dataclasses.replace(ModelConfig.from_hf_config(DANUBE2_HF_CONFIG),
                              num_hidden_layers=8)
DANUBE2_MODEL = "h2o-danube2-1.8b-chat widths (8 of 24 layers), random weights (seed 9)"
# No public Llama / Mistral / Qwen2 / Mixtral model has head_dim 384 or 512:
# two 2-layer models (4 until phases 3h-4h and 20 joined the script, for its
# time limit) at published widths with 8 / 2 heads (G 4), K1-K4 at
# the new widths on the main path.  384: Llama-3.2-3B-Instruct's hidden 3072
# and ffn 8192 (its config.json; vocab 128256, rope_theta 5e5, llama3 rope
# scaling, tied embeddings) with 8 heads of 384 in place of its 24 of 128.
# 512: Mistral-7B-Instruct-v0.2's hidden 4096 and ffn 14336 with 8 heads of
# 512 in place of its 32 of 128.
D384_MODEL = ModelConfig.from_hf_config({
    **LLAMA32_1B_HF_CONFIG, "hidden_size": 3072, "intermediate_size": 8192,
    "num_hidden_layers": 2, "num_attention_heads": 8, "num_key_value_heads": 2,
    "head_dim": 384})
D512_MODEL = ModelConfig.from_hf_config({
    **MISTRAL_7B_HF_CONFIG, "num_hidden_layers": 2, "num_attention_heads": 8,
    "num_key_value_heads": 2, "head_dim": 512})
WIDE_MODELS = {
    384: (D384_MODEL, 10, "head_dim 384 model (Llama-3.2-3B-Instruct's hidden and ffn, 2 layers, "
                          "8 / 2 heads), random weights (seed 10), tied embeddings"),
    512: (D512_MODEL, 11, "head_dim 512 model (Mistral-7B-Instruct-v0.2's hidden and ffn, 2 "
                          "layers, 8 / 2 heads), random weights (seed 11)")}


def phase_danube2(rng, prompts, log_file):
    """Phase 19: h2o-danube2-1.8b at full width (8 of its 24 layers; random
    bf16 weights, seed 9), phase 5's requests through ``InferenceEngine``
    with snapkv (K1 8 a prefill, K2 at G 1, 8 x 63 a run) and fullkv (K2 at
    G 4 on the 8 KV heads), each checked as phase 5's paths are (launches,
    lengths, logits against the fp32 reference within 0.10, K2 called
    directly on its first and last layer, times, a profiled prefill and
    decode step); then a chunked drain (K1-chunk at head_dim 80)."""
    cfg = DANUBE2
    t0 = time.perf_counter()
    params = init_params(cfg, seed=9, device="cuda")
    sync()
    n_params = count_params(params)
    log(f"== 19 h2o-danube2-1.8b ({cfg.num_hidden_layers} of 24 layers, hidden 2560, ffn 6912, "
        f"32 / 8 heads of 80, vocab "
        f"32000): {n_params / 1e9:.3f} B parameters, random bf16 (seed 9), in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"model": DANUBE2_MODEL, "parameters": n_params}
    for name, comp in (("snapkv", SNAPKV), ("fullkv", FULLKV)):
        out[name] = drive_path(params, n_params, prompts, None, log_file, cfg=cfg, comp=comp,
                               model=DANUBE2_MODEL, direct_rng=rng)
        log(f"19 {name}: greedy streams (a) {out[name]['tokens'][0][:16]} ..., (b) "
            f"{out[name]['tokens'][1][:16]} ...")
    if [out[name]["decode_g"] for name in ("snapkv", "fullkv")] != [1, 4]:
        raise SystemExit("phase 19 did not decode at G 1 (snapkv) and G 4 (fullkv)")
    out["drain"] = chunked_drain(params, np.random.default_rng(19), cfg, "19")
    del params
    torch.cuda.empty_cache()
    return out


def phase_wide_head_dims(rng, prompts, log_file):
    """Phase 19b: the head_dim 384 and 512 models of ``WIDE_MODELS``, phase
    5's requests through ``InferenceEngine`` with snapkv over the bf16, int8
    and int4 caches (K1 and K2, K3, K4 at 384 / 512, the quantized caches
    per token as the JAX rule builds them at D % 128 == 0), each checked as
    phase 5's paths are: limits 0.10 (bf16, int8) and 0.40 (int4)."""
    out = {}
    for D, (cfg, seed, model) in WIDE_MODELS.items():
        t0 = time.perf_counter()
        params = init_params(cfg, seed=seed, device="cuda")
        if cfg.tie_word_embeddings:
            params["lm_head"] = params["embed"].T.contiguous()
        sync()
        n_params = count_params(params) - (params["lm_head"].numel()
                                           if cfg.tie_word_embeddings else 0)
        log(f"== 19b {model}: hidden {cfg.hidden_size}, ffn {cfg.intermediate_size}, "
            f"{cfg.num_attention_heads} / {cfg.num_key_value_heads} heads of {cfg.head_dim}, vocab "
            f"{cfg.vocab_size}: {n_params / 1e9:.3f} B parameters in "
            f"{time.perf_counter() - t0:.1f} s")
        out[D] = {"model": model, "parameters": n_params}
        for label, quant in PATHS:
            # drive_path counts the weight bytes a step reads: the layers'
            # and the lm_head's (the embedding is gathered by row).
            out[D][label] = drive_path(params, count_params(params), prompts, quant, log_file,
                                       cfg=cfg, model=model, direct_rng=rng)
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 20: OpenLLaMA-3B v2 widths (head_dim 100)
# ---------------------------------------------------------------------------

# The fields the forward reads from the published config.json of
# openlm-research/open_llama_3b_v2 (LlamaForCausalLM, untied lm_head; it
# names neither num_key_value_heads nor rope_theta: 32 KV heads, MHA, and
# 10000 by default): head_dim 3200 / 32 = 100, a bf16 row of 200 bytes, no
# whole number of 16-byte pieces.  The JAX package serves it on its XLA
# path; K1 and K2 run it on their 128 instantiation with 8-byte row pieces.
# Full depth: 3.426 G parameters, 6.85 GB in bf16; 13 of the 26 layers since
# phases 3i-4j and 21 joined the script, for its time limit (every check
# counts launches per layer and reads the first and last layer).
OPENLLAMA_3B_HF_CONFIG = {
    "model_type": "llama", "vocab_size": 32000, "hidden_size": 3200,
    "intermediate_size": 8640, "num_hidden_layers": 26, "num_attention_heads": 32,
    "max_position_embeddings": 2048, "rms_norm_eps": 1e-06, "tie_word_embeddings": False}
OPENLLAMA_3B = dataclasses.replace(ModelConfig.from_hf_config(OPENLLAMA_3B_HF_CONFIG),
                                   num_hidden_layers=13)
OPENLLAMA_MODEL = "OpenLLaMA-3B v2 widths (13 of 26 layers), random weights (seed 12)"
# SnapKV at half the 2048-token bucket: 1024 kept, window 8, maxpool 7.
OPENLLAMA_SNAPKV = dataclasses.replace(SNAPKV, max_capacity_prompt=1024)
OPENLLAMA_DRAIN_CHUNK = 1024


def phase_openllama(rng, log_file):
    """Phase 20: OpenLLaMA-3B v2 at full width (13 of its 26 layers; random
    bf16 weights, seed 12), two requests of 1984 and 1500 tokens (bucket
    2048, inside the model's 2048 positions) through ``InferenceEngine``
    with snapkv at 1024 (K1 13 a prefill with window scores, K2 at G 1,
    13 x 63 a run) and fullkv (K2 at G 1 over all 32 KV heads), each
    checked as phase 5's paths are (launches, lengths, logits against the
    fp32 reference within 0.10, K2 called directly on its first and last
    layer, times, a profiled prefill and decode step); then a chunked drain
    (four requests of 1984 tokens in 1024-token chunks: K1-chunk at
    head_dim 100)."""
    cfg = OPENLLAMA_3B
    t0 = time.perf_counter()
    params = init_params(cfg, seed=12, device="cuda")
    sync()
    n_params = count_params(params)
    log(f"== 20 OpenLLaMA-3B v2 ({cfg.num_hidden_layers} of 26 layers, hidden 3200, ffn 8640, "
        f"32 / 32 heads of 100, vocab "
        f"32000): {n_params / 1e9:.3f} B parameters, random bf16 (seed 12), in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in OPENLLAMA_PROMPTS]
    out = {"model": OPENLLAMA_MODEL, "parameters": n_params}
    for name, comp in (("snapkv", OPENLLAMA_SNAPKV), ("fullkv", FULLKV)):
        out[name] = drive_path(params, n_params, prompts, None, log_file, cfg=cfg, comp=comp,
                               model=OPENLLAMA_MODEL, direct_rng=rng)
        log(f"20 {name}: greedy streams (a) {out[name]['tokens'][0][:16]} ..., (b) "
            f"{out[name]['tokens'][1][:16]} ...")
    if [out[name]["decode_g"] for name in ("snapkv", "fullkv")] != [1, 1]:
        raise SystemExit("phase 20 did not decode at G 1")
    out["drain"] = chunked_drain(params, np.random.default_rng(20), cfg, "20",
                                 prompt_len=OPENLLAMA_PROMPTS[0], comp=OPENLLAMA_SNAPKV,
                                 chunk=OPENLLAMA_DRAIN_CHUNK)
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 3i, 4i, 4j, 4k and 21: head_dims above 512 (the wide kernels)
# ---------------------------------------------------------------------------

# K1 and K2 at every even head_dim above 512 run the kernels of
# csrc/flash_prefill_wide.cu and csrc/decode_attn_wide.cu (O's columns in
# slices of flash_prefill.SLICE), K3 and K4 at every multiple of 128 above
# 512 the latter's quantized build; up to 2048 K1 and K3 run as one
# thread-block cluster of a CTA per slice (K3: csrc/decode_attn_quant_cluster.cu,
# flash_prefill.cluster_size).  Phase 3i / 4i's widths: 514 (4-byte
# pieces), 576, 640, 768, 1004 (8-byte pieces), 1024 and 2048; phase 4j's
# the per-token cache's 640, 768, 1024 and 2048.
WIDE_K12_DIMS = (514, 576, 640, 768, 1004, 1024, 2048)
WIDE_KQ_DIMS = (640, 768, 1024, 2048)
# K1's variants and K2's and K3 / K4's times are taken at each piece width's
# representative (514: 4 bytes, 1004: 8), the model's width and the widest
# (clusters of 3, 4 and 8 CTAs), for the script's time limit.  K3's G 12,
# range case and edge shapes run at every width: each cluster size lays out
# its shared memory and its fan-out apart.
WIDE_FULL = (514, 1004, 1024, 2048)
# Phase 21's attention: Meta-Llama-3-8B-Instruct's q (4096 wide) and k / v
# (1024 wide) regrouped as 4 query heads and 1 KV head of 1024.
LLAMA3_WIDE_HEADS = (4, 1)
# Cluster sizes the widths above leave out (5, 6 and 7 CTAs: owners of 13,
# 11 and 10 score rows, the last fewer), and one width past the cluster
# limit, where K1 and K3 run the slice-recomputing kernels, held there with
# every variant and fault case of phases 3i and 4j: held, not timed.
WIDE_MORE_DIMS = (1280, 1536, 1792, 2176)


def fault_scales(D):
    """The wrong logit scales a wrapper of the wide kernels could pass at
    head_dim D: 1/sqrt of one column slice's width, and of the slices'
    whole width (where it is not D)."""
    out = {"slice_width": flash_prefill.SLICE ** -0.5}
    whole = flash_prefill.slices(D) * flash_prefill.SLICE
    if whole != D:
        out["slices_width"] = whole ** -0.5
    return out


def cluster_info(lib, entry, n):
    """(dynamic shared memory in bytes, clusters the card holds at once) of
    a cluster kernel at ``n`` CTAs a cluster, from its library's info entry
    point (``cudaOccupancyMaxActiveClusters``)."""
    info = (ctypes.c_int * 2)()
    _build.check(getattr(_build.load(lib), entry)(n, info), entry)
    return info[0], info[1]


def k1_dropped_slice_error(q, k, v, tls, out_ref, r0):
    """What K1's check sees (example 0, head 0, rows r0 .. true_len) from a
    cluster whose score sum drops one slice's partial S: the plain math with
    slice 0's channels (the first ``SLICE``) left out of QK^T, V whole."""
    t, D = tls[0], q.shape[-1]
    rows = torch.arange(r0, t, device=q.device)
    qh = q[0, 0].clone()
    qh[:, :flash_prefill.SLICE] = 0
    dropped = plain_attention_rows(qh, k[0, 0], v[0, 0], rows, t, D ** -0.5)
    return rel_l2(dropped, out_ref[0, 0, r0:t])[0]


def wide_ptxas(reports, lib, name):
    """(registers, spill line) of each kernel of ``lib`` whose name holds
    ``name``, from this run's ptxas report (empty when cached)."""
    return sorted({(r, sp) for _, r, sp in ptxas_entries(reports.get(lib, ""), name)})


def phase_k1_wide(rng, reports, dims=WIDE_K12_DIMS, variants=WIDE_FULL, timed=True):
    """Phase 3i: K1 at each of ``dims`` (the wide kernels) against its plain
    version on inputs whose buffers end in NaN: dense with window scores at
    phase 21's heads (B 2, 4 / 1 heads, S 4096, true_len 4096 / 3000, W 8),
    the CTA's length edges, two launches bitwise equal, and what a skipped
    key tile, a row's last copy piece dropped, a row read at the slices'
    width, a cluster sum without one slice's partial S and a wrong 1/sqrt (a
    slice's width, the slices' width: through the output and through K1-ml's
    m) would show (each must fail the limit); at each of ``variants`` the
    variants (``k1_head_dim_variants``: SW, chunk, a-shape, vertical-slash,
    ring hops, with their off-by-one sensitivities); with ``timed``, at 514
    and 1024 the window scores at W 128 with a cut window pass, and each
    width timed beside its plain version, SDPA (with its backend) and its
    bound (phase 4k runs this untimed past the cluster limit)."""
    lib = "flash_prefill_wide"
    regs = {"flash_cluster_kernel": wide_ptxas(reports, lib, "flash_cluster_kernel"),
            "flash_wide_kernel": wide_ptxas(reports, lib, "flash_wide_kernel"),
            flash_prefill.SCORE_KERNEL: wide_ptxas(reports, lib, flash_prefill.SCORE_KERNEL)}
    log(f"K1 wide ptxas (registers, spill) by kernel: {regs}")
    Hq, Hkv = LLAMA3_WIDE_HEADS
    out = {}
    for D in dims:
        B, W, S = 2, 8, 4096
        tls = [S, 3000]
        q, k, v, tl, sc, out_ref, err, absd, err_sc = k1_case(rng, B, Hq, Hkv, S, W, tls, D,
                                                              tail=True)
        edge = k1_case(rng, 4, 8, 2, 1024, 64, [1, 63, 129, 1000], D, tail=True)[6:9]
        call = lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, W)  # noqa: E731
        same = bitwise_repeat(call)
        r0 = tls[0] // 2
        whole = flash_prefill.slices(D) * flash_prefill.SLICE
        tail_err, wide_err = k1_ragged_fault_errors(q, k, v, tls, out_ref, r0, width=whole)
        faults = {"skipped_tile": k1_skipped_tile_error(q, k, v, tls, out_ref, r0=r0),
                  "tail_piece_dropped": tail_err}
        if whole != D:
            faults["row_read_at_slices_width"] = wide_err
        n = flash_prefill.cluster_size(D)
        smem = clusters = None
        if n > 1:
            faults["cluster_slice_dropped"] = k1_dropped_slice_error(q, k, v, tls, out_ref, r0)
            smem, clusters = cluster_info(lib, "kvcf_flash_prefill_cluster_info", n)
        qh, kh, vh = (nan_tailed(bf16_normal(rng, (1, h, 1024, D))) for h in (Hq, Hkv, Hkv))
        hop = k1ml_case(qh, kh, vh, 2048, 1024)
        scale_faults = {}
        for name, scale in fault_scales(D).items():
            with instantiation_scale(lib, scale):
                wrong = call()[0]
                m_wrong = flash_prefill.flash_prefill_attention(
                    qh, kh, vh, hop["tl"], 0, row_offset=hop["off"], return_ml=True)[2]
            sync()
            scale_faults[name] = {
                "scale": scale,
                "out_rel_l2": max(rel_l2(wrong[b, :, :t], out_ref[b, :, :t])[0]
                                  for b, t in enumerate(tls)),
                "ml_m_abs": (m_wrong - hop["m_ref"]).abs().max().item()}
            del wrong, m_wrong
        del qh, kh, vh, hop
        shape = (f"a cluster of {n} CTAs: {smem} B of shared memory a CTA, {clusters} clusters "
                 "at once" if n > 1 else f"{flash_prefill.slices(D)} slice CTAs, no cluster")
        log(f"K1 D={D} ({lib} {flash_prefill.entry(D)}, {shape}; "
            f"{flash_prefill.copy_bytes(D)}-byte pieces, scale 1/sqrt({D}) = {D ** -0.5:.6f}): "
            f"two launches bitwise equal {same}; a fault would show "
            f"{({n: f'{e:.3e}' for n, e in faults.items()})} (tol {K1_OUT_TOL}); a wrong scale "
            f"{scale_faults} (tol {K1_OUT_TOL}, K1-ml's m {K1ML_M_TOL})")
        if not same or min(faults.values()) <= K1_OUT_TOL or any(
                f["out_rel_l2"] <= K1_OUT_TOL and f["ml_m_abs"] <= K1ML_M_TOL
                for f in scale_faults.values()):
            raise SystemExit(f"K1 at D={D} is not deterministic, or its tolerance would let a "
                             "fault pass")
        del out_ref
        t, backend = {}, "not timed"
        if timed:
            t = time_k1(q, k, v, tl, W, tls, sc)
            t["bound_fraction"] = t["bound_ms"] / t["ms"]
            backend = sdpa_backend(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            log(f"K1 D={D}: the library yardstick ran SDPA's {backend} backend")
        del q, k, v, sc
        entry = {"name": f"flash_prefill_d{D}", "route": "cuda",
                 "source": flash_prefill.WIDE_SOURCE, "replaces": flash_prefill.REPLACES,
                 "built_as": lib, "entry": flash_prefill.entry(D),
                 "column_slices": flash_prefill.slices(D), "cluster_size": n,
                 "cluster_smem_bytes": smem, "clusters_at_once": clusters,
                 "copy_bytes": flash_prefill.copy_bytes(D), "scale": D ** -0.5,
                 "library": f"scaled_dot_product_attention, causal GQA ({backend} backend)",
                 "shape": f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} w={W} true_len={tls}",
                 "max_abs_err": absd, "rel_l2": err, "tol": K1_OUT_TOL,
                 "scores_max_abs_err": err_sc, "fault_rel_l2": faults,
                 "scale_faults": scale_faults, **t, "deterministic": same,
                 "edge_case": {"rel_l2": edge[0], "max_abs_err": edge[1],
                               "scores_max_abs_err": edge[2]},
                 "nan_tailed_inputs": True, "ptxas": regs}
        if D in variants:
            entry["variants"] = k1_head_dim_variants(rng, D, Hq, Hkv)
        if timed and D in (514, 1024):  # window scores at W 128, and a pass cut at 64 rows
            qw, kw, vw, tlw, scw, _, errw, _, sc_errw = k1_case(rng, B, Hq, Hkv, S, 128, tls,
                                                                D, tail=True)
            cut = k1_cut_window_error(qw, kw, vw, tlw, 128, tls, scw)
            log(f"K1 D={D} W 128: a window pass cut at 64 rows would show {cut:.3e} "
                f"(tol {K1_SCORE_TOL})")
            if cut <= K1_SCORE_TOL:
                raise SystemExit(f"K1's score tolerance at D={D} would let a cut window pass")
            # The window-score pass timed beside the main pass from profiler rows.
            passes = k1_pass_ms(lambda: flash_prefill.flash_prefill_attention(qw, kw, vw, tlw, 128),
                                names=("flash_cluster_kernel", flash_prefill.SCORE_KERNEL))
            log(f"K1 D={D} W 128 passes (profiler, ms a launch): {passes}; window-score pass "
                f"{score_pass_ms(passes):.4f} ms")
            entry["w128"] = {"rel_l2": errw, "scores_max_abs_err": sc_errw,
                             "cut_window_max_abs": cut, "passes_ms": passes,
                             **time_k1(qw, kw, vw, tlw, 128, tls, scw)}
            del qw, kw, vw, scw
        out[D] = entry
        torch.cuda.empty_cache()
    return out


def phase_wide_more(rng, reports):
    """Phase 4k: the cluster sizes that phases 3i and 4j leave out, and the
    slice-recomputing kernels past the cluster limit, each against its plain
    version on NaN-tailed inputs.  K1 at the cluster widths of
    ``WIDE_MORE_DIMS`` dense with window scores at phase 21's shape, the
    CTA edges and two launches bitwise equal; past the limit everything
    phase 3i holds, with the variants, untimed (``phase_k1_wide``).  K3 at
    every one of ``WIDE_MORE_DIMS`` as phase 4j holds it
    (``phase_kq_wide_head_dims``: G 1, 4 and 12, the range case, the edge
    shapes and the fault cases; past the limit the replays and the
    split-rule edges too), untimed."""
    Hq, Hkv = LLAMA3_WIDE_HEADS
    out = {}
    past = tuple(D for D in WIDE_MORE_DIMS if flash_prefill.cluster_size(D) == 1)
    for D in WIDE_MORE_DIMS:
        if D in past:
            continue
        tls = [4096, 3000]
        q, k, v, tl, _, _, err, _, err_sc = k1_case(rng, 2, Hq, Hkv, 4096, 8, tls, D, tail=True)
        same = bitwise_repeat(lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, 8))
        del q, k, v
        if not same:
            raise SystemExit(f"K1 at D={D} is not deterministic")
        edge = k1_case(rng, 4, 8, 2, 1024, 64, [1, 63, 129, 1000], D, tail=True)[6]
        out[D] = {"k1": {"entry": flash_prefill.entry(D),
                         "cluster_size": flash_prefill.cluster_size(D), "rel_l2": err,
                         "scores_max_abs_err": err_sc, "edge_rel_l2": edge,
                         "bitwise_repeat": same}}
        log(f"4k K1 D={D}: {out[D]['k1']}")
        torch.cuda.empty_cache()
    for D, entry in phase_k1_wide(rng, reports, past, past, timed=False).items():
        out[D] = {"k1": entry}
    for (_, D), entry in phase_kq_wide_head_dims(rng, reports, WIDE_MORE_DIMS, (8,)).items():
        out[D]["k3"] = entry
    return out


def phase_k2_wide(rng, reports):
    """Phase 4i: K2 at each of ``WIDE_K12_DIMS`` (the wide kernel) against
    its plain version (inputs in NaN-tailed buffers; the cache after the
    append identical) on phase 21's decode layers: snapkv's cache per query
    head (G 1, B 2 x 4 heads at 2079 / 1531 keys, C 2113) and fullkv's (G 4,
    B 2 x 1 head at 4159 / 1563, C 4161), G 12 over 16 heads, the edge
    shapes (``k2_edge_cases``), the append's neighbour rows and the bytes
    after the buffer byte for byte, with what an off-by-one key range, a
    dropped split, a row's last piece dropped, a row read at the slices'
    width and a wrong 1/sqrt (a slice's width, the slices' width) would
    show: each must fail the limit wherever its factor on the logits is at
    least ``SCALE_VISIBLE`` from 1; at 1024 also bitwise repeats, graph
    replays and the split-rule edges; both decodes timed beside the plain
    version, SDPA and the bound."""
    lib = "decode_attn_wide"
    regs = wide_ptxas(reports, lib, "decode_wide_kernelILi16E")
    log(f"K2 wide ptxas (registers, spill), every (piece, GB): {regs}")
    Hq, Hkv = LLAMA3_WIDE_HEADS
    out = {}
    for D in WIDE_K12_DIMS:
        C, H = 2113, 2 * Hq
        lens = [2048 + 31] * Hq + [1500 + 31] * Hq
        q, kc, vc, kn, vn, lt, _, ref, err, absd = k2_case(rng, H, 1, C, lens,
                                                            np.zeros(H, np.int64), D, tail=True)
        off_err = k2_one_key_off_error(q, kc, vc, kn, vn, lt, ref)
        drop_err, n_split = k2_dropped_split_error(q, kc, vc, kn, vn, lt, ref)
        whole = flash_prefill.slices(D) * flash_prefill.SLICE
        tail_err, wide_err = k2_fault_errors(q, kc, vc, kn, vn, lt, ref, width=whole)
        faults = {"off_by_one": off_err, "dropped_split": drop_err,
                  "tail_piece_dropped": tail_err}
        if whole != D:
            faults["row_read_at_slices_width"] = wide_err
        required = dict(faults)
        for name, scale in fault_scales(D).items():
            with instantiation_scale(lib, scale):
                wrong = decode_attn.decode_attention_append(q, kc.clone(), vc.clone(), lt, kn, vn)
            sync()
            faults[f"scale_{name}"] = rel_l2(wrong.reshape(H, -1), ref.reshape(H, -1))[0]
            if abs(1 - scale * D ** 0.5) >= SCALE_VISIBLE:  # visible: required to fail
                required[f"scale_{name}"] = faults[f"scale_{name}"]
        C4 = 4096 + 64 + 1
        by_g = {12: k2_case(rng, 16, 12, C4, [4096 + 63] * 8 + [1500 + 63] * 8,
                            np.zeros(16, np.int64), D, tail=True)[8]}
        # The edge shapes at phase 21's G 4 everywhere, at G 1 and 12 too
        # on both piece widths' representatives (the kernel is one for all).
        edges = {G: k2_edge_cases(rng, D, G) for G in ((1, 4, 12) if D in (514, 1024) else (4,))}
        append_ok = k2_append_bytes(rng, D)
        log(f"K2 D={D} ({lib}, {flash_prefill.slices(D)} column slices, "
            f"{flash_prefill.copy_bytes(D)}-byte pieces, scale 1/sqrt({D}) = {D ** -0.5:.6f}): "
            f"G 12 head rel L2 {by_g[12]:.3e}, edge shapes {max(edges.values()):.3e}; append "
            f"byte for byte {append_ok}; a fault would show "
            f"{({n: f'{e:.3e}' for n, e in faults.items()})} (tol {K2_OUT_TOL}; required to "
            f"fail it: {sorted(required)})")
        if min(required.values()) <= K2_OUT_TOL or not append_ok:
            raise SystemExit(f"K2 at D={D} touched bytes past its row, or its tolerance would "
                             "let a fault pass")
        entry = {"name": f"decode_attn_append_d{D}", "route": "cuda",
                 "source": decode_attn.WIDE_SOURCE, "replaces": decode_attn.REPLACES,
                 "built_as": lib, "column_slices": flash_prefill.slices(D),
                 "copy_bytes": flash_prefill.copy_bytes(D), "scale": D ** -0.5,
                 "shape": f"H={H} (B=2 x {Hq}) G=1 C={C} D={D}, lengths 2079 and 1531",
                 "max_abs_err": absd, "rel_l2": err, "tol": K2_OUT_TOL,
                 "g12_rel_l2": by_g[12], "edges_rel_l2": edges, "fault_rel_l2": faults,
                 "required_to_fail": sorted(required), "n_split": n_split,
                 "append_bytes_identical": append_ok, "nan_tailed_inputs": True,
                 "ptxas": regs}
        if D == 1024:
            entry.update(k2_repeat_and_replay(q, kc, vc, kn, vn, lt))
            entry.update(k2_split_edges(rng, D))
        if D in WIDE_FULL:
            entry.update(time_k2(q, kc, vc, kn, vn, lt))
            mask = (torch.arange(C, device="cuda")[None] <= lt[:, None].long())[None, :, None]
            backend = sdpa_backend(lambda: F.scaled_dot_product_attention(
                q[None], kc[None], vc[None], attn_mask=mask))
            log(f"K2 D={D}: the library yardstick ran SDPA's {backend} backend")
            entry["library"] = (f"scaled_dot_product_attention with a boolean cache mask "
                                f"({backend} backend)")
        del q, kc, vc, ref
        # Phase 21's fullkv decode: G 4 over the 2 KV heads.
        H4 = 2 * Hkv
        q, kc, vc, kn, vn, lt, _, ref, err4, abs4 = k2_case(
            rng, H4, Hq // Hkv, C4, [4096 + 63] * Hkv + [1500 + 63] * Hkv,
            np.zeros(H4, np.int64), D, tail=True)
        entry["g4"] = {"shape": f"H={H4} (B=2 x {Hkv}) G={Hq // Hkv} C={C4} D={D}, lengths "
                                "4159 and 1563", "rel_l2": err4, "max_abs_err": abs4,
                       **(time_k2(q, kc, vc, kn, vn, lt) if D == 1024 else {})}
        del q, kc, vc, ref
        out[D] = entry
        torch.cuda.empty_cache()
    return out


# Phase 21's model: Meta-Llama-3-8B-Instruct's published widths (hidden
# 4096, ffn 14336, vocab 128256, rope_theta 5e5, untied lm_head) with its
# attention regrouped as 4 query heads and 1 KV head of 1024 (q 4096 and
# k / v 1024 wide, as its 32 / 8 heads of 128: every weight keeps its shape,
# the KV bytes a token are its own).  No public Llama / Mistral / Qwen2 /
# Mixtral checkpoint has a head_dim above 512.  8 of its 32 layers: the
# script's 1200 s limit (PERF.md §4).
LLAMA3_WIDE = dataclasses.replace(ModelConfig.from_hf_config({
    **LLAMA3_8B_HF_CONFIG, "num_attention_heads": LLAMA3_WIDE_HEADS[0],
    "num_key_value_heads": LLAMA3_WIDE_HEADS[1], "head_dim": 1024}), num_hidden_layers=8)
LLAMA3_WIDE_MODEL = ("Meta-Llama-3-8B-Instruct widths with 4 / 1 heads of 1024 (8 of 32 layers), "
                     "random weights (seed 21)")


def phase_llama3_wide(rng, prompts, log_file):
    """Phase 21: ``LLAMA3_WIDE`` at full width (random bf16 weights, seed
    21), phase 5's requests through ``InferenceEngine`` with snapkv over the
    bf16, int8 and int4 caches (K1 with window scores, then K2 / K3 / K4 at
    G 1 on the cache per query head, all at head_dim 1024) and fullkv (K2 at
    G 4), each checked as phase 5's paths are (launches, lengths, logits
    against the fp32 reference within 0.10 / 0.10 / 0.40, the decode kernel
    called directly on its first and last layer, times, a profiled prefill
    and decode step); then a chunked drain (K1-chunk at 1024)."""
    cfg = LLAMA3_WIDE
    t0 = time.perf_counter()
    params = init_params(cfg, seed=21, device="cuda")
    sync()
    n_params = count_params(params)
    log(f"== 21 {LLAMA3_WIDE_MODEL}: hidden {cfg.hidden_size}, ffn {cfg.intermediate_size}, "
        f"{cfg.num_attention_heads} / {cfg.num_key_value_heads} heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}: {n_params / 1e9:.3f} B parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"model": LLAMA3_WIDE_MODEL, "parameters": n_params}
    for label, quant in PATHS:
        out[label] = drive_path(params, n_params, prompts, quant, log_file, cfg=cfg,
                                model=LLAMA3_WIDE_MODEL, direct_rng=rng)
        torch.cuda.empty_cache()
    out["fullkv"] = drive_path(params, n_params, prompts, None, log_file, cfg=cfg, comp=FULLKV,
                               model=LLAMA3_WIDE_MODEL, direct_rng=rng)
    log(f"21 fullkv: greedy streams (a) {out['fullkv']['tokens'][0][:16]} ..., (b) "
        f"{out['fullkv']['tokens'][1][:16]} ...")
    if [out[name]["decode_g"] for name in ("bf16", "fullkv")] != [1, 4]:
        raise SystemExit("phase 21 did not decode at G 1 (snapkv) and G 4 (fullkv)")
    out["drain"] = chunked_drain(params, np.random.default_rng(21), cfg, "21")
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 17: Mistral-Large-Instruct-2407 widths (G 12)
# ---------------------------------------------------------------------------

# The fields the forward reads from the published config.json of
# mistralai/Mistral-Large-Instruct-2407 (MistralForCausalLM; bf16 weights,
# untied lm_head, no sliding window).
MISTRAL_LARGE_HF_CONFIG = {
    "model_type": "mistral", "vocab_size": 32768, "hidden_size": 12288,
    "intermediate_size": 28672, "num_hidden_layers": 88, "num_attention_heads": 96,
    "num_key_value_heads": 8, "head_dim": 128, "max_position_embeddings": 131072,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-05, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
# Depth cut to 2 of the 88 layers: 1.384 G parameters a layer and 0.805 G of
# embedding and lm_head make 7.1 GB in bf16 at 2 layers, 245 GB at 88 (over
# the card's 80 GB even as W8A16, ~123 GB); 8 layers until phases 3g-4g and
# 19 joined the script, 4 until phases 3h-4h and 20 did, for its time limit.
# Every check counts launches per layer and holds the logits to the fp32
# reference at any depth.
MISTRAL_LARGE = dataclasses.replace(ModelConfig.from_hf_config(MISTRAL_LARGE_HF_CONFIG),
                                    num_hidden_layers=2)
MISTRAL_LARGE_MODEL = "Mistral-Large-Instruct-2407 widths (2 of 88 layers), random weights (seed 7)"
# Each run: (label, compression, cache, the quantized cache's capacity).  The
# fullkv runs decode over the 8 KV heads (K2 / K3 / K4 at G 12), the mean
# group reduction keeps one entry set per KV head (K2 at G 12 over a
# compressed cache), and the 128-row observation window puts K1's score
# pass at W 128 on every layer (K2 at G 1).  A fullkv cache holds bucket +
# 64 new + 1 slots, rounded up to 128 (int8) or 256 (int4) as the engine
# rounds them.
MISTRAL_LARGE_RUNS = (
    ("fullkv_bf16", FULLKV, None, None),
    ("fullkv_int8", FULLKV, QuantConfig(nbits=8), 4224),
    ("fullkv_int4", FULLKV, QuantConfig(nbits=4), 4352),
    ("snapkv_mean", dataclasses.replace(SNAPKV, group_reduce="mean"), None, None),
    ("snapkv_w128", dataclasses.replace(SNAPKV, window_size=128), None, None))


def phase_mistral_large(rng, prompts, log_file):
    """Phase 17: Mistral-Large-Instruct-2407 at full width (2 of its 88
    layers; random bf16 weights, seed 7), phase 5's requests through
    ``InferenceEngine`` for each of ``MISTRAL_LARGE_RUNS``, each checked as
    phase 5's paths are (launches K1 2 a prefill and 2 x 63 of the decode
    kernel, lengths, logits against the fp32 reference at 0.10 / 0.10 /
    0.40, the decode kernel called directly on its first and last layer, times, a
    profiled decode step, the decode bound).  Returns the results and the
    weights (phase 18 traces a run on them)."""
    cfg = MISTRAL_LARGE
    t0 = time.perf_counter()
    params = init_params(cfg, seed=7, device="cuda")
    sync()
    n_params = count_params(params)
    log(f"== 17 Mistral-Large-Instruct-2407 ({cfg.num_hidden_layers} of 88 layers, hidden "
        f"12288, ffn 28672, 96 / 8 "
        f"heads of 128, vocab 32768): {n_params / 1e9:.3f} B parameters, random bf16 (seed 7), "
        f"in {time.perf_counter() - t0:.1f} s")
    out = {"model": MISTRAL_LARGE_MODEL, "parameters": n_params}
    for label, comp, quant, capacity in MISTRAL_LARGE_RUNS:
        out[label] = drive_path(params, n_params, prompts, quant, log_file, cfg=cfg, comp=comp,
                                model=MISTRAL_LARGE_MODEL, direct_rng=rng, capacity=capacity)
        torch.cuda.empty_cache()
    if [out[label]["decode_g"] for label, *_ in MISTRAL_LARGE_RUNS] != [12, 12, 12, 12, 1]:
        raise SystemExit("phase 17 did not decode at the group sizes it is for")
    return out, params


# ---------------------------------------------------------------------------
# Phase 17b: Llama-3.1-405B-Instruct widths (G 16)
# ---------------------------------------------------------------------------

# The fields the forward reads from the published config.json of
# meta-llama/Llama-3.1-405B-Instruct (LlamaForCausalLM; bf16 weights, untied
# lm_head, llama3 rope scaling).
LLAMA31_405B_HF_CONFIG = {
    "model_type": "llama", "vocab_size": 128256, "hidden_size": 16384,
    "intermediate_size": 53248, "num_hidden_layers": 126, "num_attention_heads": 128,
    "num_key_value_heads": 8, "head_dim": 128, "max_position_embeddings": 131072,
    "rope_theta": 500000.0,
    "rope_scaling": {"factor": 8.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "rms_norm_eps": 1e-05, "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
# Depth cut to 1 of the 126 layers (2 until phases 3h-4h and 20 joined the
# script): 3.188 G parameters a layer and 4.203 G of embedding and lm_head
# make 14.8 GB in bf16 at 1 layer, 812 GB at 126.  The phase is here for G
# 16 on the main path (K2 / K3 / K4 at 128 / 8 heads): one layer gives the
# per-layer launch counts and the fp32 reference check as every depth does.
LLAMA31_405B = dataclasses.replace(ModelConfig.from_hf_config(LLAMA31_405B_HF_CONFIG),
                                   num_hidden_layers=1)
LLAMA31_405B_MODEL = "Llama-3.1-405B-Instruct widths (1 of 126 layers), random weights (seed 8)"


def phase_llama31_405b(rng, prompts, log_file):
    """Phase 17b: Llama-3.1-405B-Instruct at full width (1 of its 126
    layers; random bf16 weights, seed 8), phase 5's requests through
    ``InferenceEngine`` with fullkv over the bf16, int8 and int4 caches
    (K2 / K3 / K4 at G 16), each checked as phase 17's runs are (launches
    K1 1 a prefill and 63 of the decode kernel, lengths, logits against
    the fp32 reference at 0.10 / 0.10 / 0.40, the decode kernel called
    directly on the layer, times, a profiled decode step)."""
    cfg = LLAMA31_405B
    t0 = time.perf_counter()
    params = init_params(cfg, seed=8, device="cuda")
    sync()
    n_params = count_params(params)
    log(f"== 17b Llama-3.1-405B-Instruct ({cfg.num_hidden_layers} of 126 layers, hidden 16384, "
        f"ffn 53248, 128 / 8 "
        f"heads of 128, vocab 128256, llama3 rope scaling): {n_params / 1e9:.3f} B parameters, "
        f"random bf16 (seed 8), in {time.perf_counter() - t0:.1f} s")
    out = {"model": LLAMA31_405B_MODEL, "parameters": n_params}
    for label, comp, quant, capacity in MISTRAL_LARGE_RUNS[:3]:
        out[label] = drive_path(params, n_params, prompts, quant, log_file, cfg=cfg, comp=comp,
                                model=LLAMA31_405B_MODEL, direct_rng=rng, capacity=capacity)
        torch.cuda.empty_cache()
    if [out[label]["decode_g"] for label, *_ in MISTRAL_LARGE_RUNS[:3]] != [16, 16, 16]:
        raise SystemExit("phase 17b did not decode at G 16")
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 18: the profiling and viz utilities and the serving example
# ---------------------------------------------------------------------------

TRACE_DIR = LOG_PATH.parent / "trace_p18"
TRACE_STEPS = 16  # new tokens of the traced run: a prefill and 15 decode steps
# infer_attention on the card against the same function on the CPU: the
# same bf16 weights upcast to fp32 on both (TF32 off), so only the order of
# fp32 sums differs (~1e-6 relative per map).
VIZ_REL_L2_TOL = 1e-4
# A map's rows sum to the scale (1e4) up to fp32 rounding of 256 terms.
VIZ_ROW_SUM_REL_TOL = 1e-5
VIZ_PROMPT = 256
# A system prompt of one whole chunk: its snapshot is taken at the chunk's
# end, and later admissions in the same bucket resume from it.
SERVING_ARGS = ["--wq8", "--prefill_chunk", "128", "--system_prompt_tokens", "128"]


def annotated(fn, name, timer):
    """``fn`` run inside ``annotate(name)`` and ``timer.phase(name)``, the
    phase's clock stopped after its outputs are on the card."""
    def call(*args, **kwargs):
        held = []
        with annotate(name), timer.phase(name, outputs=held):
            result = fn(*args, **kwargs)
            held.append(result)
        return result
    return call


def trace_spans(path, names, kernels):
    """From a Chrome trace: each annotation span's device kernels by name
    part and busy ms (kernels, copies, sets), how many device events were
    placed by launch record and by device start, and each kernel's count
    over the whole trace.  A kernel belongs to the span that holds its
    launch on the host (matched by correlation id), or, where the trace
    holds no launch record for it, its own start."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = {n: [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("name") == n and e.get("cat") == "user_annotation"] for n in names}
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = {n: {"spans": len(spans[n]), "busy_ms": 0.0, **dict.fromkeys(kernels, 0)}
           for n in names}
    matched, totals = [0, 0], dict.fromkeys(kernels, 0)
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        for k in kernels:
            totals[k] += e.get("cat") == "kernel" and k in e["name"]
        ts = launches.get(e.get("args", {}).get("correlation"))
        matched[ts is None] += 1
        ts = e["ts"] if ts is None else ts
        for n in names:
            if any(a <= ts <= b for a, b in spans[n]):
                out[n]["busy_ms"] += e["dur"] / 1e3
                for k in kernels:
                    out[n][k] += e.get("cat") == "kernel" and k in e["name"]
    return out, {"by_launch": matched[0], "by_device_start": matched[1]}, totals


def phase_trace(params, prompts):
    """18a: one ``generate_batch`` of phase 5's requests on phase 17's
    weights (fullkv, bf16 cache: K1 and K2 at G 12) under ``utils.trace``,
    with ``llama.prefill`` and ``llama.decode_step`` wrapped in
    ``utils.annotate`` and a ``PhaseTimer``: the trace file must hold both
    annotations with K1 kernels inside the prefill and K2 inside the decode
    steps, and none outside them; the timer's summary beside the trace's
    busy time."""
    cfg = MISTRAL_LARGE
    engine = InferenceEngine(params, EngineConfig(model=cfg, compression=FULLKV), device="cuda")
    engine.generate_batch(prompts, 2)  # warm-up outside the trace
    sync()
    L, steps = cfg.num_hidden_layers, TRACE_STEPS - 1
    want_totals = {"flash_fwd_kernel": L, "decode_attn_kernel": L * steps}
    timer = PhaseTimer()
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    prefill, decode_step = llama.prefill, llama.decode_step
    llama.prefill = annotated(prefill, "prefill", timer)
    llama.decode_step = annotated(decode_step, "decode", timer)
    try:
        with trace(str(TRACE_DIR)):
            ids = engine.generate_batch(prompts, TRACE_STEPS)
    finally:
        llama.prefill, llama.decode_step = prefill, decode_step
    files = sorted(TRACE_DIR.glob("*.json"))
    if len(files) != 1 or [len(x) for x in ids] != [TRACE_STEPS] * 2:
        raise SystemExit(f"utils.trace wrote {files} (one Chrome trace expected), or the "
                         "traced run lost tokens")
    spans, matched, totals = trace_spans(files[0], ("prefill", "decode"),
                                         ("flash_fwd_kernel", "decode_attn_kernel"))
    summary = timer.summary()
    trace_bytes = files[0].stat().st_size
    log(f"18a trace {files[0].name} ({trace_bytes / 1e6:.1f} MB): spans {spans}; "
        f"kernels placed by launch record / by device start {matched}; kernels in the trace "
        f"{totals} (expect {want_totals}); PhaseTimer {summary}")
    # Every K1 and K2 launch in the trace, each inside its annotation where
    # it was placed by its launch record (one placed by its device start
    # may sit off its span by the clocks' skew; then at least one of each).
    k1_in, k2_in = spans["prefill"]["flash_fwd_kernel"], spans["decode"]["decode_attn_kernel"]
    exact = matched["by_device_start"] == 0
    inside = k1_in >= 1 and k2_in >= 1 and (not exact or (
        k1_in == L and k2_in == L * steps))
    want = (totals == want_totals and spans["prefill"]["spans"] == 1
            and spans["decode"]["spans"] == steps and inside
            and summary["prefill"]["count"] == 1 and summary["decode"]["count"] == steps)
    if not want:
        raise SystemExit(f"the trace does not hold every K1 in the prefill annotation and every "
                         f"K2 in the decode annotations ({L} and {L} x {steps} launched)")
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    for name in ("prefill", "decode"):
        log(f"18a {name}: PhaseTimer {summary[name]['total_s'] * 1e3:.3f} ms wall in "
            f"{summary[name]['count']} call(s), the trace's device busy "
            f"{spans[name]['busy_ms']:.3f} ms")
    return {"phase_timer": summary, "trace_spans": spans, "kernels_placed": matched,
            "kernels_in_trace": totals, "trace_bytes": trace_bytes}


def qwen_checkpoint():
    """Phase 9a's 4-layer Qwen2-7B checkpoint (written again if absent)."""
    if not (QWEN_DIR / "config.json").exists():
        hf_cfg = {**QWEN2_7B_HF_CONFIG, "num_hidden_layers": LOADER_LAYERS}
        write_checkpoint(QWEN_DIR, hf_cfg, random_hf_state(ModelConfig.from_hf_config(hf_cfg),
                                                           seed=2))
        torch.cuda.empty_cache()
    return QWEN_DIR


def phase_viz(rng):
    """18b: ``utils.infer_attention`` on the card on phase 9a's checkpoint
    with a 256-token prompt: every row of every map sums to 1e4, nothing
    above the diagonal, and the maps held to the same function on the same
    weights upcast on the CPU."""
    params, cfg = load_params(str(qwen_checkpoint()), device="cuda")
    toks = rng.integers(0, cfg.vocab_size, size=VIZ_PROMPT)
    t0 = time.perf_counter()
    maps = infer_attention(params, cfg, toks)
    card_s = time.perf_counter() - t0
    cpu = {"embed": params["embed"].float().cpu(),
           "layers": {k: v.float().cpu() for k, v in params["layers"].items()}}
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = infer_attention(cpu, cfg, toks)
    cpu_s = time.perf_counter() - t0
    upper = np.triu(np.ones((VIZ_PROMPT, VIZ_PROMPT), bool), 1)
    sums = max(float(np.abs(m.astype(np.float64).sum(-1) / 1e4 - 1).max()) for m in maps)
    above = max(float(np.abs(m[:, upper]).max()) for m in maps)
    rel = max(float(np.linalg.norm(m - r) / np.linalg.norm(r)) for m, r in zip(maps, ref))
    absd = max(float(np.abs(m - r).max()) for m, r in zip(maps, ref))
    log(f"18b infer_attention at Qwen2-7B widths ({cfg.num_hidden_layers} layers, "
        f"{cfg.num_attention_heads} heads, prompt {VIZ_PROMPT}): {len(maps)} maps of "
        f"{maps[0].shape}, {card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU; rows sum to 1e4 "
        f"within {sums:.2e} relative (tol {VIZ_ROW_SUM_REL_TOL}), largest entry above the "
        f"diagonal {above}; against the CPU: worst map rel L2 {rel:.3e} (tol {VIZ_REL_L2_TOL}), "
        f"max abs {absd:.3e} (on the 1e4 scale)")
    if (len(maps) != cfg.num_hidden_layers or maps[0].shape != (cfg.num_attention_heads,
                                                                 VIZ_PROMPT, VIZ_PROMPT)
            or sums > VIZ_ROW_SUM_REL_TOL or above != 0 or rel > VIZ_REL_L2_TOL):
        raise SystemExit("infer_attention's maps are wrong on the card")
    return {"maps": len(maps), "row_sum_rel_err": sums, "above_diagonal_max": above,
            "cpu_rel_l2": rel, "cpu_max_abs": absd, "rel_l2_tol": VIZ_REL_L2_TOL,
            "card_s": card_s, "cpu_s": cpu_s}


def phase_serving_example():
    """18c: ``examples/serving_torch.py``'s ``main`` on phase 9a's checkpoint
    with W8A16 weights, 128-token chunked admission and a 128-token system
    prompt registered as a prefix: every request finishes with its tokens,
    K1-chunk and K2 launched (counts set to 0 just before), and some
    admission resumed from the prefix's snapshot."""
    spec = importlib.util.spec_from_file_location(
        "serving_torch", Path(__file__).resolve().parent / "examples" / "serving_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--model_path", str(qwen_checkpoint()), *SERVING_ARGS]
    reset_counts()
    t0 = time.perf_counter()
    engine, outputs = example.main(argv)
    sync()
    wall = time.perf_counter() - t0
    launches = path_launches()
    _, args = example.parse_args(argv)
    counts = sorted({len(v) for v in outputs.values()})
    log(f"18c examples/serving_torch.py {' '.join(SERVING_ARGS)}: {len(outputs)} requests, "
        f"tokens each {counts} (expect {args.max_new}), {wall:.2f} s with the load; launches "
        f"{launches}; {engine.prefill_chunks_executed} row-chunks, prefix resumes "
        f"{engine.prefix_resumes}")
    if len(outputs) != args.n_requests or counts != [args.max_new] or \
            launches["K1-chunk"] == 0 or launches["K2"] == 0 or engine.prefix_resumes == 0:
        raise SystemExit("the serving example did not finish every request through K1-chunk "
                         "and K2, or no admission resumed from the system prompt's snapshot")
    out = {"requests": len(outputs), "tokens_each": args.max_new, "wall_s": wall,
           "launches": launches, "row_chunks": engine.prefill_chunks_executed,
           "prefix_resumes": engine.prefix_resumes}
    del engine
    torch.cuda.empty_cache()
    return out


def phase_utils(rng, params, prompts):
    """Phase 18: the trace on phase 17's weights (freed after it), then
    infer_attention and the serving example on phase 9a's checkpoint
    (deleted after them).  Plotting is not run on the card (no
    matplotlib there): the CPU tests cover it."""
    out = {"trace": phase_trace(params, prompts)}
    params.clear()
    torch.cuda.empty_cache()
    out["viz"] = phase_viz(rng)
    out["serving_example"] = phase_serving_example()
    shutil.rmtree(QWEN_DIR, ignore_errors=True)
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


@functools.lru_cache(maxsize=None)
def sass_text(lib):
    """``cuobjdump -sass`` of the library at path ``lib`` (each library is
    disassembled once), or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout


def sass_i2f(lib, name):
    """Int-to-float conversions (I2F, I2FP) in each function of ``lib`` whose
    name holds ``name``, from ``cuobjdump -sass``, as (conversions, integer
    divisions): an ``I2F.*.RP`` is the reciprocal step of an integer
    division by a value known only at run time (the split rule), not a
    conversion of data.  None where the toolkit has no cuobjdump."""
    sass = sass_text(str(lib))
    if sass is None:
        return None
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


# Kernels run at the start of every profiled window.  torch.profiler drops
# the first device records of each profile, more as the process ages (62 at
# phase 18, PERF.md §6; tools/trace_record_loss.py measures it), whether
# the card idles at the window's edges or not; a burst of small kernels
# first takes that loss, as utils.trace's does.  The burst is spin kernels
# (torch.cuda._sleep), which nothing else launches, so its records are
# told apart by name.
PROFILE_BURST = 1024
BURST_KERNEL = "spin_kernel"
PROFILE_LOSSES = []  # (what, device records the burst lost, launches traced) of each profile


def profile_burst():
    for _ in range(PROFILE_BURST):
        torch.cuda._sleep(1)
    sync()


def lost_records(averages):
    """(kernel launches the host traced, launches without a device record)
    of a finished profile, from its key averages."""
    launches = sum(evt.count for evt in averages
                   if evt.device_type != DeviceType.CUDA and "LaunchKernel" in evt.key)
    kernels = sum(evt.count for evt in averages
                  if evt.device_type == DeviceType.CUDA and not evt.key.startswith("ProfilerStep")
                  and not evt.key.startswith(("Memcpy", "Memset")))
    return launches, max(launches - kernels, 0)


def profile_device(fn, reps, wall_ms, what, log_file, check=None):
    """Device time per call of ``fn`` from ``torch.profiler`` (device-side
    kernel and copy events only), printed with the top kernels beside the
    unprofiled wall time ``wall_ms``; None when the profiler sees no device
    time.  ``check``, if given, gets the rows (ms, launches per call, kernel
    name) of every device kernel.  One warm-up call runs before the
    profiler starts; inside it, ``PROFILE_BURST`` spin kernels run first
    and are not counted.  Every call of ``fn`` launches the same kernels, so
    a kernel counted a number of times that ``reps`` does not divide marks
    an incomplete trace, and the run fails."""
    fn()
    sync()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        profile_burst()
        for _ in range(reps):
            fn()
        sync()
    # One pass over the trace's events: each key_averages() call walks
    # every record again, seconds a decode step's profile.
    averages = prof.key_averages()
    launches, lost = lost_records(averages)
    PROFILE_LOSSES.append((what, lost, launches))
    events = [evt for evt in averages if evt.device_type == DeviceType.CUDA
              and BURST_KERNEL not in evt.key]
    partial = [(evt.count, evt.key[:60]) for evt in events if evt.count % reps]
    log(f"profile ({what}): {launches} launches traced, {lost} without a device record "
        f"(the {PROFILE_BURST}-kernel burst first takes the profiler's loss)")
    if partial:
        raise SystemExit(f"profile ({what}): incomplete device trace, counts over {reps} "
                         f"calls {partial[:4]}")
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
    log_file.write(averages.table(sort_by="self_device_time_total", row_limit=40))
    return busy_ms


T_START = time.perf_counter()
PHASE_S = {}  # each phase's wall seconds, in the end-to-end line


def timed(name, fn, *args):
    """``fn(*args)``, its wall time logged and kept in ``PHASE_S``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    log(f"[{time.perf_counter() - T_START:.1f} s] {name}: {PHASE_S[name]:.1f} s")
    return out


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
    log(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}; nvcc seconds by "
        f"library {({k: round(v, 1) for k, v in _build.BUILD_SECONDS.items()})}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(key in line for key in ("registers", "spill", "Compiling entry",
                                           "Performance Loss")):
                log(f"  {name}: {line.strip()}")
    # Each kernel's ptxas lines by instantiation width: registers and spill
    # bytes.  The widths of earlier slices must spill nothing; a spill at
    # 384 or 512 is reported here and in its kernel's entry, beside its time.
    # The libraries of 8- and 4-byte row pieces (head_dims that are no
    # multiple of 8) are reported, not held to it.
    for lib, name, clean in (("flash_prefill", "flash_fwd_kernel", (64, 128, 256)),
                             ("decode_attn", "decode_attn_kernel", (64, 128, 256)),
                             *((f"{base}_p{w}", name, ()) for w in (8, 4) for base, name in
                               (("flash_prefill", "flash_fwd_kernel"),
                                ("decode_attn", "decode_attn_kernel")))):
        by_width = registers_by_head_dim(reports, lib, name)
        for width, rows in sorted(by_width.items()):
            log(f"{lib} {name}<{width}>: registers {sorted({r for r, _ in rows})}, spill lines "
                f"{sorted({line or 'none' for _, line in rows})}")
        if any(w in clean and "0 bytes spill stores, 0 bytes spill loads" not in (line or "")
               for w, rows in by_width.items() for _, line in rows):
            raise SystemExit(f"{name} spills registers at a width of an earlier slice")
        if not by_width:
            log(f"{name} ptxas: library cached, no ptxas report in this run")
    # K3's and K4's ptxas lines (GB 1-8 each): no spill; and no int-to-float
    # conversion in their SASS, where the toolkit has cuobjdump.
    quant_libs = [str(_build._lib_path(decode_attn_quant.library(D, 8))) for D in (128, 384, 512)]
    with ThreadPoolExecutor(len(quant_libs)) as pool:  # disassemble the three at once
        list(pool.map(sass_text, quant_libs))
    for kid, name in QUANT_KERNELS.items():
        by_width = {}
        for D in (128, 384, 512):  # the 128 library holds 256 too
            by_width.update(registers_by_head_dim(reports, decode_attn_quant.library(D, 8), name))
        for width, rows in sorted(by_width.items()):
            log(f"{kid} {name}<{width}>: registers {sorted({r for r, _ in rows})}, spill lines "
                f"{sorted({line or 'none' for _, line in rows})}")
        if any(w in (128, 256) and "0 bytes spill stores, 0 bytes spill loads" not in (line or "")
               for w, rows in by_width.items() for _, line in rows):
            raise SystemExit(f"{kid} spills registers at a head_dim of an earlier slice")
        if not by_width:
            log(f"{kid} ptxas: library cached, no ptxas report in this run")
        i2f = {}
        for D in (128, 384, 512):
            i2f.update(sass_i2f(_build._lib_path(decode_attn_quant.library(D, 8)), name) or {})
        i2f = i2f or None
        log(f"{kid} SASS: no cuobjdump in this toolkit (not measured)" if i2f is None else
            f"{kid} SASS (cuobjdump -sass), per instantiation: I2F/I2FP conversions "
            f"{sorted(c for c, _ in i2f.values())}, integer-division reciprocals (I2F.*.RP) "
            f"{sorted(r for _, r in i2f.values())}")
        if i2f is not None and (not i2f or any(c for c, _ in i2f.values())):
            raise SystemExit(f"{kid}'s SASS holds int-to-float conversions (or no {kid} kernel)")

    # The wide kernels (head_dims above 512): one build serves every width,
    # so no kernel of theirs may spill.
    for lib in ("flash_prefill_wide", "decode_attn_wide", "decode_attn_quant_wide",
                "decode_attn_quant_cluster"):
        rows = ptxas_entries(reports.get(lib, ""), "")
        if not rows:
            log(f"{lib} ptxas: library cached, no ptxas report in this run")
            continue
        log(f"{lib}: {len(rows)} kernels, registers {sorted({r for _, r, _ in rows})}, spill lines "
            f"{sorted({sp or 'none' for _, _, sp in rows})}")
        if any("0 bytes spill stores, 0 bytes spill loads" not in (sp or "") for _, _, sp in rows):
            raise SystemExit(f"a kernel of {lib} spills registers")
    # K3's cluster kernel (640-2048) turns codes into fp16 by PRMT: no
    # int-to-float conversion in its SASS either.
    i2f = sass_i2f(_build._lib_path("decode_attn_quant_cluster"), "quant8_cluster_kernel")
    log("K3 cluster SASS: no cuobjdump in this toolkit (not measured)" if i2f is None else
        f"K3 cluster SASS, per GB: I2F/I2FP conversions {sorted(c for c, _ in i2f.values())}, "
        f"integer-division reciprocals (I2F.*.RP) {sorted(r for _, r in i2f.values())}")
    if i2f is not None and (not i2f or any(c for c, _ in i2f.values())):
        raise SystemExit("K3's cluster kernel holds int-to-float conversions (or is missing)")
    log(f"[{time.perf_counter() - T_START:.1f} s] build, ptxas and SASS checks done")
    rng = np.random.default_rng(0)
    k1 = timed("3 K1", phase_k1, rng)
    k1_sw, k1_chunk = timed("3b K1 variants", phase_k1_variants, rng)
    k1_a, k1_vs, k1["minference"] = timed("3c K1 sparse", phase_k1_sparse, rng)
    k5 = timed("3d K5", phase_k5, rng)
    k1_ml = timed("8a K1-ml", phase_k1ml, rng)
    sp_fold = timed("8b ring fold", phase_sp_fold, rng)
    k2 = timed("4 K2", phase_k2, rng)
    k3 = timed("4b K3", phase_kq, rng, 8)
    k4 = timed("4b K4", phase_kq, rng, 4)
    timed("4 edges", phase_edges, rng)
    # The head_dim 64 and 256 cases draw from a generator of their own, so
    # that every other phase keeps its inputs.  This generator and the four
    # below draw their bf16 tensors on the card (``DeviceDraws``).
    rng_hd = DeviceDraws(17)
    k1_hd = timed("3e K1 head dims", phase_k1_head_dims, rng_hd, reports)
    k2_hd = timed("4c K2 head dims", phase_k2_head_dims, rng_hd, reports)
    kq_hd = timed("4d K3/K4 head dim 256", phase_kq_head_dims, rng_hd, reports)
    # Phases 3f, 4e, 17 and 18 draw from a generator of their own, as 3e-4d.
    rng18 = DeviceDraws(18)
    k1_w = timed("3f K1 windows", phase_k1_windows, rng18)
    # Phase 3j draws from a generator of its own, so that 4e, 17 and 18 keep
    # the inputs they continue rng18 with.
    k1_sp = timed("3j K1 window-score pass", phase_k1_score_pass, DeviceDraws(23), reports)
    big_g = timed("4e K2-K4 G above 8", phase_big_groups, rng18, reports)
    # Phases 3g-4g and 19-19b draw from a generator of their own, as 3e-4d.
    rng19 = DeviceDraws(19)
    k1_nd = timed("3g K1 head dims to 512", phase_k1_new_head_dims, rng19, reports)
    k2_nd = timed("4f K2 head dims to 512", phase_k2_new_head_dims, rng19, reports)
    kq_nd = timed("4g K3/K4 head dims 384, 512", phase_kq_wide_head_dims, rng19, reports)
    # Phases 3h-4h and 20 draw from a generator of their own, as 3e-4d.
    rng20 = DeviceDraws(20)
    k1_rg = timed("3h K1 ragged head dims", phase_k1_ragged, rng20, reports)
    k2_rg = timed("4h K2 ragged head dims", phase_k2_ragged, rng20, reports)
    # Phases 3i-4j and 21 draw from a generator of their own, as 3e-4d.
    rng21 = DeviceDraws(21)
    k1_wd = timed("3i K1 head dims above 512", phase_k1_wide, rng21, reports)
    k2_wd = timed("4i K2 head dims above 512", phase_k2_wide, rng21, reports)
    kq_wd = timed("4j K3/K4 head dims above 512", phase_kq_wide_head_dims, rng21, reports,
                  WIDE_KQ_DIMS)
    # Phase 4k draws from a generator of its own, so that phase 21 keeps the
    # inputs it continues rng21 with.
    wide_more = timed("4k K1/K3 at the other cluster sizes", phase_wide_more, DeviceDraws(22),
                      reports)
    LOG_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(LOG_PATH, "w") as log_file:
        params, prompts, e2e = timed("5 main path", phase_e2e, rng, log_file)
        policies = timed("5b policies", phase_policies, rng, params, prompts, log_file)
        serving = timed("6 serving", phase_serving, rng, params, log_file)
        torch.cuda.empty_cache()
        minf = timed("7 MInference", phase_minference, rng, params, log_file)
        sp = timed("8c sp", phase_sp, rng, params)
        # Phase 12 draws from a generator of its own, so that phases 9-11
        # keep the inputs they had before it joined (ROADMAP queue 3 item 3:
        # phase 11c's resumed-vs-cold limit fails on other prompts).
        grid_refs = timed("12 references", grid_references, np.random.default_rng(12), prompts)
        # The ranks draw their own weights: the parent's go first.
        del params
        torch.cuda.empty_cache()
        grid = timed("12 grid", phase_grid, grid_refs)
        pp = timed("13 pp", phase_pp, grid_refs)
        del grid_refs
        qwen = timed("9 Qwen2", phase_qwen2, rng, log_file)
        llama3 = timed("10 Llama-3", phase_llama3, rng, log_file)
        ep_refs = {}
        mixtral = timed("11 Mixtral", phase_mixtral, rng, prompts, log_file, ep_refs)
        torch.cuda.empty_cache()
        ep = timed("14 ep", phase_ep, prompts, ep_refs,
                   mixtral["engine"]["device_busy_ms_per_step"])
        del ep_refs
        torch.cuda.empty_cache()
        llama32 = timed("16 Llama-3.2-1B", phase_llama32, rng_hd, prompts, log_file)
        d256 = timed("16b head_dim 256", phase_d256, rng_hd, prompts, log_file)
        large, large_params = timed("17 Mistral-Large", phase_mistral_large, rng18, prompts,
                                    log_file)
        utils = timed("18 utils", phase_utils, rng18, large_params, prompts)
        del large_params
        llama405 = timed("17b Llama-3.1-405B", phase_llama31_405b, rng18, prompts, log_file)
        danube2 = timed("19 h2o-danube2-1.8b", phase_danube2, rng19, prompts, log_file)
        wide = timed("19b head_dim 384 / 512", phase_wide_head_dims, rng19, prompts, log_file)
        openllama = timed("20 OpenLLaMA-3B v2", phase_openllama, rng20, log_file)
        llama3_wide = timed("21 Llama-3-8B, head_dim 1024", phase_llama3_wide, rng21, prompts,
                            log_file)
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
    # Phase 11 at Mixtral-8x7B widths: K1 on the W8A16 prefill, K1-chunk on
    # the prefix drain, K2 on the 32-token run and the prefix drain.
    mx, mxs = mixtral["engine"], mixtral["serving"]["warm"]
    k1["mixtral"] = {"launches_per_prefill": mx["launches"]["K1"]}
    k1_chunk["mixtral"] = {"launches_prefix_drain": mxs["launches"]["K1-chunk"]}
    k2["mixtral"] = {"launches_32_new": mx["launches"]["K2"],
                     "launches_prefix_drain": mxs["launches"]["K2"]}
    # Phase 12: each kernel's launches per rank on the (dp, sp, tp) runs
    # that run it, and K2 at one tp=2 rank's shape.
    gr = grid["runs"]

    def per_rank(label, kid):
        return [rk["launches"][kid] for rk in gr[label]["ranks"]]

    k1["tp"] = {label: per_rank(label, "K1") for label in
                ("tp2_bf16", "tp2_int8", "tp2_int4", "dp2_bf16", "tp2_fullkv", "dp2_tp2_bf16")}
    k1_ml["tp"] = {"sp2_tp2_bf16": per_rank("sp2_tp2_bf16", "K1-ml")}
    k1_chunk["tp"] = {"drain_dp2_tp2": per_rank("drain_dp2_tp2", "K1-chunk")}
    k2["tp"] = {label: per_rank(label, "K2") for label in
                ("tp2_bf16", "dp2_bf16", "tp2_fullkv", "dp2_tp2_bf16", "sp2_tp2_bf16",
                 "drain_dp2_tp2")}
    k2["tp"]["shard_timing"] = grid["k2_tp2"]
    k3["tp"] = {"tp2_int8": per_rank("tp2_int8", "K3")}
    k4["tp"] = {"tp2_int4": per_rank("tp2_int4", "K4")}
    # The compressing methods under sp (12a), and phases 13 (each pp
    # stage's launches) and 14 (each ep rank's).
    k1_ml["tp"].update({f"sp2_{m}": per_rank(f"sp2_{m}", "K1-ml") for m in GRID_SP_METHODS})
    k2["tp"].update({f"sp2_{m}": per_rank(f"sp2_{m}", "K2") for m in GRID_SP_METHODS})
    for k, kid in ((k1, "K1"), (k2, "K2")):
        k["pp"] = {"per_stage": [st["launches"][kid] for st in pp["stages"]]}
        k["ep"] = {"per_rank": [rk["launches"][kid] for rk in ep["ranks"]]}
    # Phase 16 and 16b: each (kernel, head_dim) on the run that runs it.
    k1_hd[64].update(launches=llama32["snapkv"]["launches"]["K1"],
                     launches_fullkv=llama32["fullkv"]["launches"]["K1"])
    k1_hd["chunk"]["launches"] = llama32["drain"]["launches"]["K1-chunk"]
    k1_hd[256]["launches"] = d256["bf16"]["launches"]["K1"]
    k2_hd[64].update(launches=llama32["snapkv"]["launches"]["K2"])
    k2_hd[64]["g4"]["launches"] = llama32["fullkv"]["launches"]["K2"]
    k2_hd[256]["launches"] = d256["bf16"]["launches"]["K2"]
    kq_hd[8]["launches"] = d256["int8"]["launches"]["K3"]
    kq_hd[4]["launches"] = d256["int4"]["launches"]["K4"]
    # Phase 17: K1 at W 128 on the snapkv_w128 run; K2, K3 and K4 at G 12 on
    # its fullkv runs (K2 also on snapkv_mean); at G 16 on phase 17b's.
    k1_w[128]["launches"] = large["snapkv_w128"]["launches"]["K1"]
    # The window-score pass: one launch with each K1 launch of a scoring
    # method (snapkv here); its launches on the main path's bf16 run, and on
    # the runs of W 128 (phase 17), head_dim 100 (20) and 1024 (21).
    k1_sp["launches"] = e2e["bf16"]["score_launches"]
    k1_sp["launches_by_run"] = {
        "mistral_large_snapkv_w128": large["snapkv_w128"]["score_launches"],
        "openllama_3b_snapkv_d100": openllama["snapkv"]["score_launches"],
        "llama3_d1024_snapkv_bf16": llama3_wide["bf16"]["score_launches"]}
    for kid, run in (("K2", "fullkv_bf16"), ("K3", "fullkv_int8"), ("K4", "fullkv_int4")):
        for G, phase in ((12, large), (16, llama405)):
            big_g[kid][G]["launches"] = phase[run]["launches"][kid]
            big_g[kid][G]["launches_from"] = f"{phase['model']}, {run}"
    big_g["K2"][12]["launches_snapkv_mean"] = large["snapkv_mean"]["launches"]["K2"]
    # Phases 19 and 19b: K1 and K2 at 80 on the danube2 runs (K2 at G 4 on
    # fullkv), K1-chunk at 80 on its drain, K1-K4 at 384 and 512 on 19b's
    # runs.  The other head_dims of 3g / 4f run on the 64, 128 and 256
    # instantiations: their checks and times ride on those entries.
    k1_nd[80].update(launches=danube2["snapkv"]["launches"]["K1"],
                     launches_fullkv=danube2["fullkv"]["launches"]["K1"])
    k2_nd[80].update(launches=danube2["snapkv"]["launches"]["K2"])
    k2_nd[80]["g4"]["launches"] = danube2["fullkv"]["launches"]["K2"]
    k1_chunk80 = {"name": "flash_prefill_chunk_d80", "route": "cuda",
                  "source": flash_prefill.SOURCE,
                  "replaces": flash_prefill.REPLACES_VARIANT["chunk"], "instantiation": 128,
                  "launches": danube2["drain"]["launches"]["K1-chunk"],
                  **k1_nd[80]["variants"]["chunk"]}
    for D in WIDE_HEAD_DIMS:
        k1_nd[D]["launches"] = wide[D]["bf16"]["launches"]["K1"]
        k2_nd[D]["launches"] = wide[D]["bf16"]["launches"]["K2"]
        kq_nd[(8, D)]["launches"] = wide[D]["int8"]["launches"]["K3"]
        kq_nd[(4, D)]["launches"] = wide[D]["int4"]["launches"]["K4"]
    # Phase 20: K1 and K2 at 100 on the OpenLLaMA-3B runs (K2 at G 1 on
    # both), K1-chunk at 100 on its drain.  The other head_dims of 3h / 4h
    # run the same libraries at other instantiations: their checks and
    # times ride on the entries at 100.
    ol = openllama
    k1_rg[100].update(launches=ol["snapkv"]["launches"]["K1"],
                      launches_fullkv=ol["fullkv"]["launches"]["K1"])
    k2_rg[100].update(launches=ol["snapkv"]["launches"]["K2"],
                      launches_fullkv=ol["fullkv"]["launches"]["K2"])
    k1_chunk100 = {"name": "flash_prefill_chunk_d100", "route": "cuda",
                   "source": flash_prefill.SOURCE,
                   "replaces": flash_prefill.REPLACES_VARIANT["chunk"], "instantiation": 128,
                   "built_as": flash_prefill.library(100),
                   "launches": ol["drain"]["launches"]["K1-chunk"],
                   **k1_rg[100]["variants"]["chunk"]}
    for D in RAGGED_HEAD_DIMS:
        if D != 100:
            k1_rg[100].setdefault("head_dims_held", {})[D] = k1_rg[D]
            k2_rg[100].setdefault("head_dims_held", {})[D] = k2_rg[D]
    # Phase 21: K1, K2, K3 and K4 at 1024 on the Llama-3-8B regrouping (K2
    # at G 1 on snapkv, G 4 on fullkv), K1-chunk at 1024 on its drain.  The
    # other widths of 3i-4j run the same kernels: their checks and times
    # ride on the entries at 1024.
    lw = llama3_wide
    k1_wd[1024].update(launches=lw["bf16"]["launches"]["K1"],
                       launches_fullkv=lw["fullkv"]["launches"]["K1"])
    k2_wd[1024].update(launches=lw["bf16"]["launches"]["K2"])
    k2_wd[1024]["g4"]["launches"] = lw["fullkv"]["launches"]["K2"]
    for nbits, kid in ((8, "K3"), (4, "K4")):
        kq_wd[(nbits, 1024)]["launches"] = lw[f"int{nbits}"]["launches"][kid]
        for D in WIDE_KQ_DIMS:
            if D != 1024:
                kq_wd[(nbits, 1024)].setdefault("head_dims_held", {})[D] = kq_wd[(nbits, D)]
    k1_chunk1024 = {"name": "flash_prefill_chunk_d1024", "route": "cuda",
                    "source": flash_prefill.WIDE_SOURCE,
                    "replaces": flash_prefill.REPLACES_VARIANT["chunk"],
                    "built_as": flash_prefill.library(1024),
                    "launches": lw["drain"]["launches"]["K1-chunk"],
                    **k1_wd[1024]["variants"]["chunk"]}
    for D in WIDE_K12_DIMS:
        if D != 1024:
            k1_wd[1024].setdefault("head_dims_held", {})[D] = k1_wd[D]
            k2_wd[1024].setdefault("head_dims_held", {})[D] = k2_wd[D]
    k1_wd[1024]["head_dims_held"].update({D: held["k1"] for D, held in wide_more.items()})
    kq_wd[(8, 1024)]["head_dims_held"].update({D: held["k3"] for D, held in wide_more.items()})
    for D in NEW_HEAD_DIMS:
        if D not in MODEL_HEAD_DIM_HEADS:
            width = flash_prefill.instance(D)
            for host, held in (({64: k1_hd[64], 128: k1, 256: k1_hd[256]}[width], k1_nd[D]),
                               ({64: k2_hd[64], 128: k2, 256: k2_hd[256]}[width], k2_nd[D])):
                host.setdefault("head_dims_held", {})[D] = held
    print(json.dumps({"kernels": [k1, k1_sw, k1_chunk, k1_a, k1_vs, k1_ml, k2, k3, k4, k5,
                                  k1_hd[64], k1_hd["chunk"], k1_hd[256], k2_hd[64], k2_hd[256],
                                  kq_hd[8], kq_hd[4], k1_w[128], k1_sp,
                                  *(big_g[kid][G] for kid in ("K2", "K3", "K4")
                                    for G in (12, 16)),
                                  k1_nd[80], k1_chunk80, k1_nd[384], k1_nd[512], k2_nd[80],
                                  k2_nd[384], k2_nd[512],
                                  *(kq_nd[(nbits, D)] for nbits in (8, 4)
                                    for D in WIDE_HEAD_DIMS),
                                  k1_rg[100], k1_chunk100, k2_rg[100],
                                  k1_wd[1024], k1_chunk1024, k2_wd[1024], kq_wd[(8, 1024)],
                                  kq_wd[(4, 1024)]]}))
    print(json.dumps({"e2e": e2e["bf16"], "e2e_int8": e2e["int8"], "e2e_int4": e2e["int4"],
                      "policies": policies, "serving": serving, "minference": minf,
                      "sp": {**sp, "fold_emulated": sp_fold}, "grid": grid, "pp": pp,
                      "qwen2": qwen, "llama3": llama3, "mixtral": mixtral, "ep": ep,
                      "llama32": llama32, "d256": d256, "k1_windows": k1_w,
                      "big_groups": big_g, "mistral_large": large,
                      "llama31_405b": llama405, "utils": utils, "danube2": danube2,
                      "wide_head_dims": wide, "openllama_3b": openllama,
                      "llama3_8b_head_dim_1024": llama3_wide,
                      "profile_losses": PROFILE_LOSSES,
                      "phase_s": PHASE_S, "nvcc_s": _build.BUILD_SECONDS,
                      "script_s": time.perf_counter() - T_START, "card": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
