"""Continuous-batching serving example on the PyTorch/CUDA port
(``kvcache_factory_tpu_torch``), with the same flags as
``examples/serving.py``.

Requests of different lengths stream through a fixed pool of decode slots
backed by one batched compressed cache; finished slots are refilled from the
queue without stopping the other streams, scheduled by the native C++ FIFO
scheduler (csrc/scheduler.cpp) when it builds.

Run: python examples/serving_torch.py [--model_path HF_DIR] [--method snapkv]
     [--device cuda|cpu]
Without --model_path a small randomly initialized Llama demonstrates the
mechanics (tokens are arbitrary).  --dp / --tp run under torchrun, as the
port's eval CLI does:
  torchrun --nproc-per-node 2 examples/serving_torch.py --tp 2
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--method", default="snapkv")
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--n_slots", type=int, default=4)
    ap.add_argument("--n_requests", type=int, default=10)
    ap.add_argument("--max_new", type=int, default=24)
    ap.add_argument("--prefill_chunk", type=int, default=0,
                    help=">0: chunked admission: prefill interleaves with "
                         "decode in chunks of this many tokens, bounding "
                         "the stall a long prompt puts on running streams "
                         "(must divide the prefill buckets)")
    ap.add_argument("--system_prompt_tokens", type=int, default=0,
                    help=">0: prepend a shared synthetic system prompt of "
                         "this many tokens to every request and register "
                         "it with cache_prefix(): its chunks prefill once "
                         "and later admissions resume past it (requires "
                         "--prefill_chunk)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data parallelism: decode slots shard over dp "
                         "(n_slots must divide); under torchrun")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism: weights, cache heads and "
                         "chunk buffers shard over tp; under torchrun")
    ap.add_argument("--wq8", action="store_true",
                    help="weight-only int8 (W8A16): halves the decode "
                         "weight stream")
    ap.add_argument("--prefix_cache_gb", type=float, default=1.5,
                    help="byte budget for prefix-state snapshots; oldest "
                         "snapshots evict first when over budget")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (kernels run their plain "
                         "versions)")
    return ap, ap.parse_args(argv)


def main(argv=None):
    ap, args = parse_args(argv)

    from kvcache_factory_tpu_torch.config import (CompressionConfig, EngineConfig,
                                                  ModelConfig, ShardingConfig)
    from kvcache_factory_tpu_torch.evals.cli_common import init_distributed, writes_results
    from kvcache_factory_tpu_torch.models.weights import (init_params, load_params,
                                                          quantize_weights)
    from kvcache_factory_tpu_torch.runtime.batching import ContinuousBatchingEngine

    sharding = ShardingConfig(dp=args.dp, tp=args.tp)
    init_distributed(sharding, args.device)
    say = print if writes_results() else (lambda *a, **k: None)
    if args.model_path:
        params, model_cfg = load_params(args.model_path, device=args.device)
    else:
        model_cfg = ModelConfig(
            model_type="llama", vocab_size=512, hidden_size=256,
            intermediate_size=512, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64,
            max_position_embeddings=2048)
        params = init_params(model_cfg, seed=0, device=args.device)
    if args.wq8:
        params = quantize_weights(params)

    comp = CompressionConfig(method=args.method,
                             max_capacity_prompt=args.capacity, window_size=8)
    ecfg = EngineConfig(model=model_cfg, compression=comp,
                        prefill_buckets=(128, 256, 512), sharding=sharding)

    engine = ContinuousBatchingEngine(
        params, ecfg, n_slots=args.n_slots, max_new_cap=args.max_new,
        prefill_chunk_tokens=args.prefill_chunk,
        prefix_cache_bytes=int(args.prefix_cache_gb * 2**30), device=args.device)
    rng = np.random.default_rng(0)
    system = []
    if args.system_prompt_tokens:
        system = rng.integers(0, model_cfg.vocab_size,
                              size=args.system_prompt_tokens).tolist()
        engine.cache_prefix(system)
    t0 = time.perf_counter()
    rids = []
    # the shared system prompt eats into the largest bucket's budget
    bucket_max = max(ecfg.prefill_buckets)
    if len(system) + 30 >= bucket_max:
        ap.error(f"--system_prompt_tokens {len(system)} leaves no room in "
                 f"the largest prefill bucket ({bucket_max})")
    body_max = bucket_max - len(system) - 1
    for i in range(args.n_requests):
        n = int(rng.integers(30, min(400, body_max) + 1))
        prompt = system + rng.integers(0, model_cfg.vocab_size, size=n).tolist()
        rid = engine.submit(prompt, args.max_new)
        rids.append((rid, n))
        say(f"submitted request {rid}: prompt {n} tokens")

    outputs = engine.run()
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in outputs.values())
    for rid, n in rids:
        say(f"request {rid} (prompt {n:4d}): {len(outputs[rid])} tokens -> "
            f"{outputs[rid][:8]}...")
    extra = (f", {engine.prefill_chunks_executed} prefill chunks, "
             f"{engine.prefix_resumes} prefix resumes" if args.prefill_chunk else "")
    say(f"\n{len(outputs)} requests, {total} tokens in {dt:.2f}s "
        f"({total / dt:.1f} tok/s aggregate) with {args.n_slots} slots"
        f"{extra}; scheduler stats: {engine.scheduler.stats()}")
    return engine, outputs


if __name__ == "__main__":
    main()
