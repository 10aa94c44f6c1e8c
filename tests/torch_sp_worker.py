"""Spawned ranks of the port's parallel tests (CPU, gloo): sequence
parallelism (``tests/test_torch_sp_prefill.py``, ``tests/
test_torch_ring_attention.py``) and the ``(dp, sp, tp)``, ``(dp, ep, tp)``
and pipeline layouts (``tests/test_torch_sharding.py``).

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

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.models import llama
from kvcache_factory_tpu_torch.models.weights import (params_from_jax, shard_params_from_jax,
                                                      stage_params_from_jax)
from kvcache_factory_tpu_torch.parallel.mesh import SequenceParallelGroup, StagedGroup
from kvcache_factory_tpu_torch.parallel.pipeline import pipeline_forward
from kvcache_factory_tpu_torch.parallel.ring_attention import ring_attention
from kvcache_factory_tpu_torch.policies import methods
from kvcache_factory_tpu_torch.runtime.batching import ContinuousBatchingEngine
from kvcache_factory_tpu_torch.runtime.engine import InferenceEngine

BANNED = ("jax", "jaxlib", "kvcache_factory_tpu")
TIMEOUT_S = 300


def spawn(n: int, directory: Path, job: str, payload) -> list:
    """Run ``job`` on ``n`` gloo ranks; returns each rank's results."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    # The payload goes by file: arguments past the pipe's buffer would hold
    # each start until the previous rank has imported its modules.
    with open(directory / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.start_processes(_rank_main, args=(n, str(directory), job), nprocs=n,
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


def _rank_main(rank: int, n: int, directory: str, job: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(directory, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
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


def layout(sharding: dict, rank: int):
    """A case's ``ShardingConfig`` and this rank's coordinates: ``(dp, sp |
    ep, tp)`` on the grid, ``(stage,)`` under pp."""
    sh = tcfg.ShardingConfig(**sharding)
    if sh.pp > 1:
        return sh, (rank,)
    grid = (sh.dp, sh.ep if sh.ep > 1 else sh.sp, sh.tp)
    return sh, tuple(int(x) for x in np.unravel_index(rank, grid))


def _rank_params(c, sh, coords, model):
    """This rank's weights: its tp / ep shard or its pipeline stage, cut
    from the JAX tree here, or the whole tree where ``whole_params``."""
    if c.get("whole_params"):
        return params_from_jax(c["params"], device="cpu")
    if sh.pp > 1:
        return stage_params_from_jax(c["params"], model, sh.pp, coords[0], device="cpu")
    return shard_params_from_jax(c["params"], model, sh.tp, coords[2], device="cpu", ep=sh.ep,
                                 ep_rank=coords[1] if sh.ep > 1 else 0)


def _forward_case(c, rank: int, sh, coords, model) -> dict:
    """``pipeline_forward`` on this rank's stage (one device: the port's
    prefill with fullkv): the last-token logits of every prompt."""
    toks, lens = torch.from_numpy(c["tokens"]), torch.from_numpy(c["lens"])
    counts = None
    if sh.pp > 1:
        group = StagedGroup()
        logits = pipeline_forward(_rank_params(c, sh, coords, model), model, toks, lens,
                                  group, n_microbatches=sh.pp_microbatches or sh.pp)
        counts = {"pp": {"collectives": group.collectives, "staged_bytes": group.staged_bytes,
                         "staged_s": group.staged_s}}
    else:
        logits = llama.prefill(params_from_jax(c["params"], device="cpu"), model,
                               tcfg.CompressionConfig(method="fullkv"), toks, lens,
                               toks.shape[1]).logits_last
    return {"ids": [], "logits": dict(enumerate(logits.numpy())), "cache": {},
            "coords": coords, "counts": counts}


def _sharded_case(c, rank: int, sharding: dict) -> dict:
    """One case of ``tests/test_torch_sharding.py`` on this rank of the
    layout ``sharding`` (``ShardingConfig`` fields; ``{}``: the
    single-device engine).  The case holds the model, compression, an
    optional quant config, the JAX layout's weights (numpy; each rank takes
    its tp / ep shard through ``shard_params_from_jax`` or its stage
    through ``stage_params_from_jax``, or hands the engine the whole tree
    where ``whole_params``), prompts, new tokens, buckets, optional HeadKV
    capacities, JAX's uniform draws for cam and random (``draws[(layer,
    example)]``), and for a ``ContinuousBatchingEngine`` drain its slots and
    chunk size, or for a sampled run (``sample``: ``GenerationConfig``
    fields, handed to ``generate_batch``) the seed of the engine's
    generator; a ``forward`` case holds tokens and lengths for
    ``pipeline_forward``.  Returns the ids, the first-token logits of every
    prompt, this rank's cache (each field as numpy), its coordinates and
    its groups' counts."""
    model = tcfg.ModelConfig(**c["model"])
    sh, coords = layout(sharding, rank)
    if c.get("forward"):
        return _forward_case(c, rank, sh, coords, model)
    params = _rank_params(c, sh, coords, model)
    cfg = tcfg.EngineConfig(
        model=model, compression=tcfg.CompressionConfig(**c["comp"]),
        quant=None if c.get("quant") is None else tcfg.QuantConfig(**c["quant"]),
        sharding=sh, prefill_buckets=c["buckets"])
    draws = c.get("draws")
    drawn = methods.uniform_draw
    if draws is not None:
        methods.uniform_draw = lambda rng, layer, example, shape: torch.from_numpy(
            draws[(layer, example)])
    try:
        if "n_slots" in c:
            eng = ContinuousBatchingEngine(params, cfg, n_slots=c["n_slots"],
                                           max_new_cap=c["max_new"], device="cpu",
                                           prefill_chunk_tokens=c.get("chunk", 0),
                                           instrument=True)
            rids = [eng.submit(p, c["max_new"]) for p in c["prompts"]]
            out = eng.run()
            ids, cache = [out[r] for r in rids], eng.cache
            logits = {i: eng.logits[r][0].numpy() for i, r in enumerate(rids) if r in eng.logits}
        else:
            rng = torch.Generator().manual_seed(c["seed"]) if "seed" in c else None
            eng = InferenceEngine(params, cfg, device="cpu", head_capacity=c.get("hc"), rng=rng)
            gen = tcfg.GenerationConfig(**c["sample"]) if "sample" in c else None
            ids, res = eng.generate_batch(c["prompts"], c["max_new"], return_result=True,
                                          generation=gen)
            cache = res.cache
            logits = dict(enumerate(res.logits[:len(c["prompts"]), 0].numpy()))
    finally:
        methods.uniform_draw = drawn
    fields = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
              for k, v in cache._asdict().items() if v is not None}
    groups = getattr(eng, "pp_group", None)
    counts = (None if eng.groups is None and groups is None else
              eng.groups.counts() if eng.groups is not None else
              {"pp": {"collectives": groups.collectives, "staged_bytes": groups.staged_bytes,
                      "staged_s": groups.staged_s}})
    return {"ids": ids, "logits": logits, "cache": fields, "coords": coords, "counts": counts}


def _sharded(rank: int, n: int, cases) -> dict:
    """Each case at its layout of ``n`` ranks; then, on rank 0, each case
    on the single-device engine (``single``), in this process after the
    sharded runs, as :func:`_engine` computes its reference."""
    results = {"cases": [_sharded_case(c, rank, c["sharding"]) for c in cases]}
    if rank == 0:
        results["single"] = [_sharded_case(c, 0, {}) for c in cases]
    return results


JOBS = {"ring": _ring, "engine": _engine, "sharded": _sharded}

