"""Spawned ranks of the port's sequence-parallel tests (CPU, gloo).

This module imports only torch, numpy and the port, never JAX or the JAX
package, and each rank reports the names of any such module it finds
loaded.  :func:`spawn` starts ``n`` ranks with the ``spawn`` method; they
meet through a ``file://`` rendezvous under the caller's directory (one
per spawn, so parallel test workers never share one), run one job and
write their results there; the caller gets each rank's results in rank
order.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.parallel.mesh import SequenceParallelGroup
from kvcache_factory_tpu_torch.parallel.ring_attention import ring_attention
from kvcache_factory_tpu_torch.runtime.engine import InferenceEngine

BANNED = ("jax", "jaxlib", "kvcache_factory_tpu")
TIMEOUT_S = 300


def spawn(n: int, directory: Path, job: str, payload) -> list:
    """Run ``job`` on ``n`` gloo ranks; returns each rank's results."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(n, str(directory), job, payload), nprocs=n,
                             start_method="spawn", join=False)
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=TIMEOUT_S)
    while not ctx.join(timeout=5):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{job} on {n} ranks did not finish in {TIMEOUT_S} s")
    out = []
    for r in range(n):
        with open(directory / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, n: int, directory: str, job: str, payload) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = JOBS[job](rank, n, payload)
        result["banned_modules"] = sorted(m for m in sys.modules
                                          if m.split(".")[0] in BANNED)
    finally:
        dist.destroy_process_group()
    tmp = os.path.join(directory, f"rank{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(directory, f"rank{rank}.pkl"))


def _ring(rank: int, n: int, cases) -> dict:
    """Each case: global fp32 q, k, v, true_len and the window; this rank's
    rows of the ring's output, and whether it handed back the global K/V."""
    group = SequenceParallelGroup()
    outs, kv_global = [], []
    for c in cases:
        q, k, v = (torch.from_numpy(c[x]) for x in "qkv")
        lo, hi = group.bounds(q.shape[2])
        out, k_all, v_all = ring_attention(
            q[:, :, lo:hi].contiguous(), k[:, :, lo:hi].contiguous(),
            v[:, :, lo:hi].contiguous(), torch.from_numpy(c["true_len"]), group, c["sw"])
        outs.append(out.numpy())
        kv_global.append(bool(torch.equal(k_all, k) and torch.equal(v_all, v)))
    return {"out": outs, "kv_global": kv_global}


def _engine_case(c, sp: int):
    """One case through ``InferenceEngine`` at ``sp`` ranks (1: the
    single-device engine): ids, cache lengths, first-token logits."""
    params = params_from_jax(c["params"], device="cpu")
    quant = None if c["nbits"] is None else tcfg.QuantConfig(nbits=c["nbits"])
    cfg = tcfg.EngineConfig(model=tcfg.ModelConfig(**c["model"]),
                            compression=tcfg.CompressionConfig(**c["comp"]), quant=quant,
                            sharding=tcfg.ShardingConfig(sp=sp), prefill_buckets=c["buckets"])
    ids, res = InferenceEngine(params, cfg, device="cpu").generate_batch(
        c["prompts"], c["max_new"], return_result=True)
    return ids, res.cache.lengths.numpy(), res.logits[:, 0].numpy()


def _engine(rank: int, n: int, cases) -> dict:
    """Each case: model, compression and weights (numpy, the JAX layout),
    an optional int8/int4 cache, prompts, new tokens and buckets; this
    rank's ids, cache lengths and first-token logits from
    ``InferenceEngine`` at ``sp = n``.  Rank 0 then runs every case on the
    single-device engine too (``single``), in this process, after its sp
    runs: the reference is computed as the ranks are, in a fresh process of
    one thread that has loaded no JAX.  Also what an engine whose ``sp`` is
    not the group's size raises."""
    results = {"ids": [], "lengths": [], "first_logits": []}
    for c in cases:
        for key, value in zip(("ids", "lengths", "first_logits"), _engine_case(c, n)):
            results[key].append(value)
    if rank == 0:
        results["single"] = [_engine_case(c, 1) for c in cases]
    try:
        InferenceEngine(params_from_jax(cases[-1]["params"], device="cpu"), tcfg.EngineConfig(
            model=tcfg.ModelConfig(**cases[-1]["model"]), sharding=tcfg.ShardingConfig(sp=2 * n),
            prefill_buckets=(2 * n,)), device="cpu")
        results["size_mismatch"] = None
    except ValueError as e:
        results["size_mismatch"] = str(e)
    return results


JOBS = {"ring": _ring, "engine": _engine}

