"""High-level inference engine: prompt buckets and cache sizing (port of
``kvcache_factory_tpu/runtime/engine.py``: the single-device path and
every layout of ``cfg.sharding``).

Prompts are right-padded to the nearest bucket and masked via ``true_len``,
so each bucket gives results identical to an exact-length run.  The cache
follows the configuration (``models/llama.py::init_prefill_cache``): with
``cfg.quant`` per-token int8 / int4 or grouped, ThinK's packed cache with
``think_packed``, the evicting cache with ``decode_evict`` (its
``eviction_recent`` passed to each decode step), else dense.
``sparse_budgets`` are MInference's per-(layer, head) (vertical, slash)
budgets ``[L, Hq, 2]`` (``policies/minference.py::load_sparse_budgets``);
``head_capacity`` HeadKV's per-(layer, cache head) budgets ``[L, H]``
(``evals/longbench.py::headkv_capacities``); without them prefill feeds
zeros and every head keeps only its window, as JAX's ``InferenceEngine``
does (both batching engines refuse headkv without them).  ``rng`` is the
``torch.Generator`` cam and random draw from, on the engine's device,
seeded 0 by default; every call starts from its state at construction, as
the JAX engine hands one key to every call.

With ``cfg.sharding.world > 1`` (JAX ``:48-119, 170-236``) the engine
runs on each rank of an initialized ``torch.distributed`` group of that
many ranks (the default group); every rank calls
:meth:`InferenceEngine.generate_batch` with the same prompts and gets the
whole batch's ids (and logits) back.  A ``(dp, sp, tp)`` or ``(dp, ep,
tp)`` layout runs on the grid of ``parallel/mesh.py::ParallelGroups``:
the batch is padded to a multiple of dp by repeating its last row and
each dp rank generates its rows; each tp rank holds its shard of the
weights and of the cache, each ep rank its experts (the engine shards
full ``params`` itself, or takes the rank's shard from
``shard_params``, so that a caller at full width never holds the whole
model); sp splits each bucket's rows over the sp ranks (ring attention in
prefill, decode on every sp rank).  ``sparse_budgets`` and
``head_capacity`` are the whole model's; each rank keeps its heads' rows.
A ``pp`` layout runs the GPipe schedule (``parallel/pipeline.py``): each
rank is a stage holding its layers (cut from full ``params`` here, or
taken from ``shard_params_pp``), the batch pads to ``pp_microbatches``
(0 = pp), and the greedy ids are trimmed at EOS afterwards, as JAX's
engine does (``:170-190``).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config import CompressionConfig, EngineConfig, GenerationConfig, ModelConfig
from ..models import llama
from ..parallel import pipeline
from ..parallel.mesh import (ParallelGroups, StagedGroup, expert_slice, parallel_groups,
                             shard_model_config, shard_params)
from ..policies.methods import HeadShard
from .generate import GenerateResult, generate


def check_tp_layout(cfg: EngineConfig) -> None:
    """``ValueError`` for a layout whose widths do not split over tp
    (``parallel/mesh.py::shard_model_config``), or a cache of the KV heads
    (fullkv, minference, a grouped reduce) that tp does not divide: each
    rank of a larger tp reads a KV head that other ranks read too, and only
    a cache kept per query head splits then; or an ep that is not a
    divisor of an MoE model's experts."""
    tp, m = cfg.sharding.tp, cfg.model
    shard_model_config(m, tp)
    if cfg.sharding.ep > 1:
        expert_slice(m, cfg.sharding.ep, 0)
    heads = cfg.compression.cache_heads(m.num_attention_heads, m.num_key_value_heads)
    if heads % tp:
        raise ValueError(f"{cfg.compression.method!r} (group_reduce="
                         f"{cfg.compression.group_reduce!r}) keeps a cache of the "
                         f"{heads} KV heads, which tp={tp} does not divide")


def rank_grid(cfg: EngineConfig) -> Tuple[Optional[ParallelGroups], ModelConfig]:
    """This rank's ``(dp, sp|ep, tp)`` grid over the default group and the
    widths it computes (``None`` and the whole model on one device), after
    the layout's checks."""
    if cfg.sharding.world == 1:
        return None, cfg.model
    check_tp_layout(cfg)
    groups = parallel_groups(cfg.sharding)
    return groups, groups.local_model(cfg.model)


def rank_params(params, cfg: EngineConfig, groups: Optional[ParallelGroups]):
    """This rank's tp / ep shard of ``params``: cut from the full tree, or
    the tree itself where ``shard_params`` has cut it (its ``lm_head``
    holds ``V / tp`` columns, its expert stacks ``E / ep`` experts) or tp
    and ep are 1."""
    sh, m = cfg.sharding, cfg.model
    if groups is None or (sh.tp == 1 and sh.ep == 1):
        return params
    V, cols = m.vocab_size, llama.wshape(params["lm_head"])[-1]
    cut = []
    if sh.tp > 1:
        if cols not in (V, V // sh.tp):
            raise ValueError(f"lm_head has {cols} columns: neither the vocabulary ({V}) "
                             f"nor one tp={sh.tp} shard of it")
        cut.append(cols * sh.tp == V)
    if sh.ep > 1:
        n_e = llama.wshape(params["layers"]["gate_up_proj"])[1]
        if n_e not in (m.num_local_experts, m.num_local_experts // sh.ep):
            raise ValueError(f"gate_up_proj holds {n_e} experts: neither the model's "
                             f"({m.num_local_experts}) nor one ep={sh.ep} shard of them")
        cut.append(n_e * sh.ep == m.num_local_experts)
    if all(cut):
        return params
    if any(cut):
        raise ValueError("params are cut over some of the layout's axes and not others")
    return shard_params(params, groups, m)


def head_rows(per_head, cfg: EngineConfig, groups: Optional[ParallelGroups], device,
              cache_heads: bool = True) -> Optional[torch.Tensor]:
    """Per-head values ``[L, H, ...]`` (HeadKV's capacities over the cache
    heads; MInference's budgets over the query heads, ``cache_heads``
    False) as an int32 device tensor, this rank's heads only under tp."""
    if per_head is None:
        return None
    t = torch.as_tensor(np.asarray(per_head), dtype=torch.int32, device=device)
    tp, m = cfg.sharding.tp, cfg.model
    if tp == 1:
        return t
    n = m.num_attention_heads
    if cache_heads:
        n = cfg.compression.cache_heads(m.num_attention_heads, m.num_key_value_heads)
    h0 = (groups.tp_rank * (n // tp) if n == m.num_attention_heads
          else groups.kv_head_offset(m))
    return t[:, h0:h0 + n // tp].contiguous()


def _device_of(params) -> torch.device:
    """The device of a weight tree (a pipeline stage's holds no embedding
    past stage 0)."""
    w = params["layers"]["input_norm"]
    return w.device


class InferenceEngine:
    def __init__(self, params, cfg: EngineConfig, device="cuda",
                 sparse_budgets: Optional[np.ndarray] = None,
                 head_capacity: Optional[np.ndarray] = None,
                 rng: Optional[torch.Generator] = None):
        sh = cfg.sharding
        llama._check_supported(cfg.model, cfg.compression, cfg.quant)
        self.device = torch.device(device)
        if _device_of(params).type != self.device.type:
            raise ValueError(f"params are on {_device_of(params)}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.buckets = sorted(cfg.prefill_buckets)
        if sh.sp > 1:
            bad = [b for b in self.buckets if b % sh.sp]
            if bad:
                raise ValueError(f"prefill buckets {bad} not divisible by sp={sh.sp} "
                                 "(sequence shards must be equal)")
        self.groups, self.model_cfg = None, cfg.model
        self.sp_group = self.tp_group = self.experts = self.pp_group = None
        self.batch_multiple = sh.dp
        if sh.pp > 1:
            pipeline.check_pp(cfg)
            self.pp_group = pp_group(sh.pp)
            self.batch_multiple = sh.pp_microbatches or sh.pp
            self.params = stage_params(params, cfg.model, sh.pp, self.pp_group.rank)
        else:
            # This rank's groups (None on one device) and the widths it computes.
            self.groups, self.model_cfg = rank_grid(cfg)
            if self.groups is not None:
                self.sp_group, self.tp_group = self.groups.sp, self.groups.tp
                self.experts = self.groups.experts(cfg.model)
            self.params = rank_params(params, cfg, self.groups)
        self.sparse_budgets = head_rows(sparse_budgets, cfg, self.groups, self.device,
                                        cache_heads=False)
        self.head_capacity = head_rows(head_capacity, cfg, self.groups, self.device)
        self.rng = rng if rng is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self._rng_state = self.rng.get_state()

    def _bucket(self, n: int) -> int:
        i = bisect.bisect_left(self.buckets, n)
        if i == len(self.buckets):
            raise ValueError(f"prompt length {n} exceeds largest bucket "
                             f"{self.buckets[-1]}")
        return self.buckets[i]

    def _comp_for_bucket(self, S: int) -> CompressionConfig:
        """Resolve the ratio budget against the bucket (reference formula
        cap = round(len * ratio), run_longbench.py:215-216)."""
        comp = self.cfg.compression
        r = self.cfg.capacity_ratio
        if r is None:
            return comp
        cap = int(round(S * r))
        kw = {"max_capacity_prompt": cap}
        if comp.method == "streamingllm":
            kw["window_size"] = cap - 4  # run_longbench.py:222-223
        return dataclasses.replace(comp, **kw)

    def _cache_capacity(self, S: int, max_new_tokens: int) -> int:
        comp = self._comp_for_bucket(S)
        cap = comp.layer_capacity(self.cfg.model.num_hidden_layers, S) + max_new_tokens + 1
        if self.cfg.quant is not None:
            # The JAX engine's rounding for its TPU cache layouts; the port's
            # kernels need none, but both engines then build caches of the
            # same capacity.
            align = 256 if self.cfg.quant.nbits == 4 else 128
            cap = -(-cap // align) * align
        return cap

    def _generate(self, toks: np.ndarray, lens: np.ndarray, gen_cfg: GenerationConfig,
                  return_logits: bool = False) -> GenerateResult:
        S = toks.shape[1]
        self.rng.set_state(self._rng_state)
        if self.pp_group is not None:
            return self._generate_pp(toks, lens, gen_cfg, return_logits)
        B = toks.shape[0]
        lo, hi, shard = 0, B, None
        sh, m = self.cfg.sharding, self.cfg.model
        if sh.dp * sh.tp > 1:
            lo, hi = self.groups.rows(B)
            shard = HeadShard(lo, B, self.groups.q_head_offset(m), m.num_attention_heads,
                              m.num_key_value_heads,
                              None if self.tp_group is None else self.tp_group.all_gather)
        res = generate(self.params, self.model_cfg, self._comp_for_bucket(S),
                       gen_cfg, toks[lo:hi], lens[lo:hi],
                       self._cache_capacity(S, gen_cfg.max_new_tokens), quant_cfg=self.cfg.quant,
                       device=self.device, return_logits=return_logits,
                       sparse_budgets=self.sparse_budgets, sp_group=self.sp_group,
                       rng=self.rng, head_capacity=self.head_capacity, tp=self.tp_group,
                       shard=shard, ep=self.experts)
        if sh.dp == 1:
            return res
        gather = self.groups.gather_dp
        return GenerateResult(gather(res.tokens), gather(res.num_tokens), res.cache,
                              None if res.logits is None else gather(res.logits))

    def _generate_pp(self, toks: np.ndarray, lens: np.ndarray, gen_cfg: GenerationConfig,
                     return_logits: bool) -> GenerateResult:
        """The pp branch (JAX ``:170-190``): ``pp_generate``'s fixed-length
        greedy ids, trimmed at EOS afterwards; a token up to and including
        the first EOS is the one ``generate`` emits, and the EOS counts."""
        if gen_cfg.do_sample:
            raise ValueError("pp decodes greedily (JAX's pp_generate); sampling runs on "
                             "one device or the (dp, sp|ep, tp) grid")
        S, N = toks.shape[1], gen_cfg.max_new_tokens
        res = pipeline.pp_generate(
            self.params, self.cfg.model, self._comp_for_bucket(S),
            torch.as_tensor(toks, device=self.device), torch.as_tensor(lens, device=self.device),
            self.pp_group, n_microbatches=self.batch_multiple, max_new_tokens=N,
            cache_capacity=self._cache_capacity(S, N), head_capacity=self.head_capacity,
            rng=self.rng, return_logits=return_logits)
        out = res.tokens
        num = torch.full((out.shape[0],), N, dtype=torch.int32, device=out.device)
        if gen_cfg.eos_token_ids:
            hit = torch.isin(out, torch.tensor(gen_cfg.eos_token_ids, device=out.device))
            num = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1, num).to(torch.int32)
        return GenerateResult(out, num, res.cache, res.logits)

    def generate_ids(self, prompt_ids: Sequence[int], max_new_tokens: int,
                     eos_token_ids: Sequence[int] = ()) -> List[int]:
        """Single-prompt greedy generation; returns generated ids (EOS-trimmed)."""
        return self.generate_batch([prompt_ids], max_new_tokens, eos_token_ids)[0]

    def generate_batch(self, prompts: Sequence[Sequence[int]], max_new_tokens: int,
                       eos_token_ids: Sequence[int] = (),
                       return_result: bool = False,
                       generation: Optional[GenerationConfig] = None,
                       ) -> Union[List[List[int]], Tuple[List[List[int]], GenerateResult]]:
        """Batched greedy generation over prompts padded to the largest
        member's bucket, the batch padded to a multiple of dp (of
        ``pp_microbatches`` under pp) by repeating its last row (JAX
        ``engine.py:226-236``).  Returns one EOS-trimmed id list per prompt;
        with ``return_result`` also the ``GenerateResult`` (the fp32 logits
        each token was chosen from, the padded batch's rows on every rank;
        the final cache, this rank's shard of it).  The tokens are chosen
        by ``GenerationConfig(max_new_tokens, eos_token_ids)``, greedy, as
        JAX's engine chooses them (``cfg.generation`` is not read).  An
        explicit ``generation`` (its ``max_new_tokens`` and
        ``eos_token_ids`` replaced by the arguments) takes its
        ``min_new_tokens`` and, with ``do_sample``, draws each token by its
        temperature / top-k / top-p from the engine's ``rng``, every rank
        drawing the whole batch's noise and keeping its rows."""
        n = len(prompts)
        S = self._bucket(max(len(p) for p in prompts))
        B = -(-n // self.batch_multiple) * self.batch_multiple
        toks = np.zeros((B, S), np.int64)
        lens = np.zeros((B,), np.int32)
        for i in range(B):
            p = prompts[min(i, n - 1)]
            toks[i, :len(p)] = p
            lens[i] = len(p)
        gen_cfg = GenerationConfig(max_new_tokens=max_new_tokens,
                                   eos_token_ids=tuple(eos_token_ids))
        if generation is not None:
            gen_cfg = dataclasses.replace(generation, max_new_tokens=max_new_tokens,
                                          eos_token_ids=tuple(eos_token_ids))
        res = self._generate(toks, lens, gen_cfg, return_logits=return_result)
        nums = res.num_tokens.cpu().numpy()
        all_toks = res.tokens.cpu().numpy()
        ids = [all_toks[i, :int(nums[i])].tolist() for i in range(n)]
        return (ids, res) if return_result else ids


def pp_group(pp: int) -> StagedGroup:
    """The pipeline's stages: the ranks of the default group, which must
    hold ``pp`` of them, in rank order."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"ShardingConfig(pp={pp}) needs an initialized torch.distributed "
                         f"process group of {pp} ranks: launch under torchrun "
                         f"--nproc-per-node {pp}, or call init_process_group in every rank")
    if dist.get_world_size() != pp:
        raise ValueError(f"ShardingConfig(pp={pp}) needs a process group of {pp} ranks, "
                         f"got {dist.get_world_size()}")
    return StagedGroup()


def stage_params(params, cfg: ModelConfig, pp: int, stage: int):
    """This stage's part of ``params``: cut from the whole tree
    (``pipeline.shard_params_pp``), or the tree itself where it holds the
    stage's ``L / pp`` layers already."""
    n = llama.wshape(params["layers"]["qkv_proj"])[0]
    L = cfg.num_hidden_layers
    if n == L // pp:
        return params
    if n != L:
        raise ValueError(f"params hold {n} layers: neither the model's ({L}) nor one "
                         f"pp={pp} stage's")
    return pipeline.shard_params_pp(params, cfg, pp, stage)
