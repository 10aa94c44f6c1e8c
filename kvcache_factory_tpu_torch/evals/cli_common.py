"""Shared CLI plumbing for the evaluation runners (port of
``kvcache_factory_tpu/evals/cli_common.py``).

Replaces the reference's argparse + per-layer config injection
(run_longbench.py:319-368, :241-261) with a typed EngineConfig resolved once,
before any weight is loaded: a flag the port does not carry yet (``--nbits``
1/2/3 or ``--residual_length``, ``--think_packed``, ``--dp``/``--tp``/
``--ep``/``--pp``) reaches its config and raises ``NotImplementedError``
naming its ROADMAP.md item there.  The engine runs on ``--device`` (the card
unless the caller asks for the CPU), its ``torch.Generator`` seeded from
``--seed``.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import torch

from ..config import (CompressionConfig, EngineConfig, ModelConfig, QuantConfig,
                      ShardingConfig)
from ..models import llama
from ..models.weights import load_params, quantize_weights
from ..runtime.engine import InferenceEngine


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--model_path", type=str, required=True,
                    help="HF checkpoint directory (config.json + safetensors)")
    ap.add_argument("--method", type=str, default="fullkv")
    ap.add_argument("--max_capacity_prompts", type=int, default=-1,
                    help="absolute KV budget per layer; -1 defers to "
                         "--max_capacity_prompts_ratio (512 if both unset). "
                         "Absolute wins when both are set "
                         "(run_longbench.py:213-216 precedence)")
    ap.add_argument("--max_capacity_prompts_ratio", type=float, default=-1,
                    help="budget as a fraction of the prompt bucket: "
                         "cap = round(bucket * ratio) "
                         "(reference run_longbench.py:215-216)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device the engine runs on (cuda, or cpu for a "
                         "small model)")
    ap.add_argument("--merge", type=str, default=None)
    ap.add_argument("--floor", type=float, default=0.2,
                    help="AdaKV floor ratio")
    ap.add_argument("--head_path", type=str,
                    default="data/heads_score/"
                            "Meta-Llama-3-8B-Instruct_retrieval_reasoning_heads.json")
    ap.add_argument("--head_beta", type=float, default=1.01)
    ap.add_argument("--recent_size", type=int, default=32)
    ap.add_argument("--pruning_ratio", type=float, default=0.4)
    ap.add_argument("--think_packed", action="store_true",
                    help="ThinK: store keys channel-packed (real memory "
                         "saving, split pruned/dense decode like "
                         "llama_model_think.py:175-181) instead of zeroing "
                         "pruned channels in place")
    ap.add_argument("--group_reduce", type=str, default="none",
                    choices=["none", "mean", "max", "sum"])
    ap.add_argument("--quant_method", type=str, default=None,
                    choices=[None, "kvquant"])
    ap.add_argument("--nbits", type=int, default=8,
                    help="KV cache bit-width: 1/2/3/4/8 (reference HQQ range)")
    ap.add_argument("--wq8", action="store_true",
                    help="weight-only int8 quantization (W8A16): int8 "
                         "weights with a per-output-channel scale applied "
                         "after each product; composes with --quant_method "
                         "(independent subsystems).  No reference counterpart")
    ap.add_argument("--wq8_skip", type=str, nargs="*", default=[],
                    help="matrices kept fp under --wq8 (e.g. lm_head — the "
                         "standard first mitigation if a quantized "
                         "checkpoint drifts)")
    ap.add_argument("--residual_length", type=int, default=0,
                    help="recent tokens kept full-precision alongside the "
                         "quantized cache (reference sets output_max_len, "
                         "run_longbench.py:283; 0 disables)")
    ap.add_argument("--prefill_buckets", type=int, nargs="*",
                    # must reach MODEL2MAXLEN's mistral ceiling (31500) or
                    # mid-run prompts raise 'exceeds largest bucket'
                    default=[512, 1024, 2048, 4096, 8192, 16384, 32768])
    # Parallelism: the port carries sp alone (a torch.distributed group of
    # sp ranks, each running this CLI); dp, tp, ep and pp raise in
    # ShardingConfig (ROADMAP.md item 1.11).
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ways (batch sharding)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ways (heads/FFN sharding)")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel ways (MoE models only)")
    ap.add_argument("--dcn_dp", type=int, default=1,
                    help="of the dp ways, how many cross hosts over DCN")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel ways: one prompt's token axis "
                         "shards over sp devices, prefill runs ring "
                         "attention over ICI; composes with --dp/--tp in "
                         "one (dp, sp, tp) mesh (not with --ep/--pp)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel stages: layers shard over pp "
                         "devices, generation runs the GPipe schedule "
                         "(dedicated mesh; dense cache only)")
    ap.add_argument("--pp_microbatches", type=int, default=0,
                    help="GPipe microbatches (0 = pp); >= pp keeps decode "
                         "bubble-free")
    ap.add_argument("--minference_config", type=str, default=None,
                    help="MInference best-pattern JSON (the external "
                         "package's MODEL2PATH schema, minference.py:9-12): "
                         "per-layer per-head [pattern, vertical, slash, _] "
                         "lists; loaded into [L, Hq, 2] budgets for the "
                         "vertical-slash block mask. Only with "
                         "--method minference")


def resolve_capacity(args):
    """Reference precedence (run_longbench.py:213-216): absolute budget wins;
    else ratio mode; else the reference's default 512.  Returns
    (capacity_for_config, capacity_ratio_or_None)."""
    cap = args.max_capacity_prompts
    ratio = getattr(args, "max_capacity_prompts_ratio", -1)
    if cap != -1:
        return cap, None
    if ratio != -1:
        if args.method.lower() == "headkv":
            raise ValueError(
                "headkv needs an absolute --max_capacity_prompts (the "
                "reference's head-capacity pool formula uses it directly, "
                "run_longbench.py:231-232)")
        # placeholder; the engine resolves round(bucket * ratio) per bucket
        return 512, ratio
    return 512, None


def compression_from_args(args) -> CompressionConfig:
    from .longbench import method_hyperparams
    cap, _ = resolve_capacity(args)
    hp = method_hyperparams(args.method, cap)
    sparse_prefill = None
    if args.method.lower() == "minference":
        # MInference's flagship vertical-slash pattern (block-granular);
        # the reference loads per-model configs from the external package
        # (pyramidkv/minference.py:9-12) — here one robust default.
        sparse_prefill = ("vertical_slash", 1024, 128, 64)
    return CompressionConfig(
        method=args.method.lower(),
        sparse_prefill=sparse_prefill,
        max_capacity_prompt=cap,
        window_size=hp.get("window_size", 32),
        kernel_size=hp.get("kernel_size", 7),
        pooling=hp.get("pooling", "maxpool"),
        merge=args.merge,
        floor_ratio=args.floor,
        recent_size=args.recent_size,
        pruning_ratio=args.pruning_ratio,
        think_packed=getattr(args, "think_packed", False),
        group_reduce=args.group_reduce,
    )


def build_engine_from_args(args) -> Tuple[InferenceEngine, object, str]:
    """Configs first (so an unported flag raises before any load), then the
    tokenizer (``transformers``, imported here), the checkpoint onto
    ``--device`` in bf16, ``--wq8``'s quantization, and the engine."""
    model_cfg = ModelConfig.from_json(os.path.join(args.model_path, "config.json"))
    comp = compression_from_args(args)
    cap, capacity_ratio = resolve_capacity(args)
    quant = None
    if args.quant_method == "kvquant":
        quant = QuantConfig(nbits=args.nbits, residual_length=args.residual_length)
    sharding = ShardingConfig(dp=getattr(args, "dp", 1), tp=getattr(args, "tp", 1),
                              ep=getattr(args, "ep", 1), sp=getattr(args, "sp", 1),
                              pp=getattr(args, "pp", 1),
                              pp_microbatches=getattr(args, "pp_microbatches", 0),
                              dcn_dp=getattr(args, "dcn_dp", 1))
    llama._check_supported(model_cfg, comp, quant, sp=sharding.sp > 1)

    head_capacity = None
    if args.method.lower() == "headkv":
        from .longbench import headkv_capacities
        if not os.path.exists(args.head_path):
            raise FileNotFoundError(
                f"--head_path {args.head_path} not found; generate a "
                "synthetic head-score file with `python tools/fetch_data.py "
                "--heads --synthetic` (or drop in real probing scores, "
                "reference data/heads_score schema)")
        head_capacity = headkv_capacities(
            args.head_path, model_cfg.num_hidden_layers,
            model_cfg.num_attention_heads, cap, args.head_beta)

    sparse_budgets = None
    mconf = getattr(args, "minference_config", None)
    if mconf:
        if args.method.lower() != "minference":
            raise ValueError("--minference_config requires --method minference")
        from ..policies.minference import load_sparse_budgets
        _, v_topk, s_topk, _ = comp.sparse_prefill
        sparse_budgets = load_sparse_budgets(
            mconf, model_cfg.num_hidden_layers,
            model_cfg.num_attention_heads, v_topk, s_topk)

    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(args.model_path, use_fast=True,
                                              padding_side="left")
    device = getattr(args, "device", "cuda")
    params, model_cfg = load_params(args.model_path, model_cfg, device=device)
    if getattr(args, "wq8", False):
        params = quantize_weights(params, skip=tuple(getattr(args, "wq8_skip", ())))
    cfg = EngineConfig(model=model_cfg, compression=comp, quant=quant,
                       sharding=sharding, capacity_ratio=capacity_ratio,
                       prefill_buckets=tuple(args.prefill_buckets))
    engine = InferenceEngine(params, cfg, device=device, head_capacity=head_capacity,
                             sparse_budgets=sparse_budgets,
                             rng=torch.Generator(device=device).manual_seed(args.seed))
    model_name = args.model_path.rstrip("/").split("/")[-1].lower()
    return engine, tokenizer, model_name
