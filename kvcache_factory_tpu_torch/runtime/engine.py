"""High-level inference engine: prompt buckets and cache sizing (port of
``kvcache_factory_tpu/runtime/engine.py``: the single-device path and the
sequence-parallel one, ``cfg.sharding.sp > 1``).

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
does (JAX's batching engine refuses headkv without them; the port's
refuses headkv, ROADMAP.md item 1.10).  ``rng`` is the ``torch.Generator``
cam and random draw from, on the engine's device, seeded 0 by default; every call starts from its state at construction, as
the JAX engine hands one key to every call.

With ``sp > 1`` (JAX ``:66-94, 195-205``) the engine runs on each rank of
an initialized ``torch.distributed`` group of ``sp`` ranks (the default
group, or ``group``): every rank calls :meth:`InferenceEngine.generate_batch`
with the same prompts, prefill splits each bucket's rows over the ranks
(ring attention), and every rank gets the same ids back.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import CompressionConfig, EngineConfig, GenerationConfig
from ..models import llama
from ..parallel.mesh import SequenceParallelGroup
from .generate import GenerateResult, generate


class InferenceEngine:
    def __init__(self, params, cfg: EngineConfig, device="cuda",
                 sparse_budgets: Optional[np.ndarray] = None,
                 group: Optional["torch.distributed.ProcessGroup"] = None,
                 head_capacity: Optional[np.ndarray] = None,
                 rng: Optional[torch.Generator] = None):
        llama._check_supported(cfg.model, cfg.compression, cfg.quant, sp=cfg.sharding.sp > 1)
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.sparse_budgets = sparse_budgets
        self.head_capacity = (None if head_capacity is None else
                              torch.as_tensor(np.asarray(head_capacity), dtype=torch.int32,
                                              device=self.device))
        self.rng = rng if rng is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self._rng_state = self.rng.get_state()
        self.buckets = sorted(cfg.prefill_buckets)
        self.sp_group = None
        sp = cfg.sharding.sp
        if sp > 1:
            bad = [b for b in self.buckets if b % sp]
            if bad:
                raise ValueError(f"prefill buckets {bad} not divisible by sp={sp} "
                                 "(sequence shards must be equal)")
            self.sp_group = SequenceParallelGroup(group)
            if self.sp_group.size != sp:
                raise ValueError(f"sp={sp} needs a process group of {sp} ranks, got "
                                 f"{self.sp_group.size}")

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

    def _generate(self, toks: np.ndarray, lens: np.ndarray, max_new_tokens: int,
                  eos_token_ids: Tuple[int, ...],
                  return_logits: bool = False) -> GenerateResult:
        S = toks.shape[1]
        gen_cfg = GenerationConfig(max_new_tokens=max_new_tokens,
                                   eos_token_ids=eos_token_ids)
        self.rng.set_state(self._rng_state)
        return generate(self.params, self.cfg.model, self._comp_for_bucket(S),
                        gen_cfg, toks, lens,
                        self._cache_capacity(S, max_new_tokens), quant_cfg=self.cfg.quant,
                        device=self.device, return_logits=return_logits,
                        sparse_budgets=self.sparse_budgets, sp_group=self.sp_group,
                        rng=self.rng, head_capacity=self.head_capacity)

    def generate_ids(self, prompt_ids: Sequence[int], max_new_tokens: int,
                     eos_token_ids: Sequence[int] = ()) -> List[int]:
        """Single-prompt greedy generation; returns generated ids (EOS-trimmed)."""
        return self.generate_batch([prompt_ids], max_new_tokens, eos_token_ids)[0]

    def generate_batch(self, prompts: Sequence[Sequence[int]], max_new_tokens: int,
                       eos_token_ids: Sequence[int] = (),
                       return_result: bool = False,
                       ) -> Union[List[List[int]], Tuple[List[List[int]], GenerateResult]]:
        """Batched greedy generation over prompts padded to the largest
        member's bucket.  Returns one EOS-trimmed id list per prompt; with
        ``return_result`` also the ``GenerateResult`` (final cache, and the
        fp32 logits each token was chosen from)."""
        n = len(prompts)
        S = self._bucket(max(len(p) for p in prompts))
        toks = np.zeros((n, S), np.int64)
        lens = np.zeros((n,), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
            lens[i] = len(p)
        res = self._generate(toks, lens, max_new_tokens, tuple(eos_token_ids),
                             return_logits=return_result)
        nums = res.num_tokens.cpu().numpy()
        all_toks = res.tokens.cpu().numpy()
        ids = [all_toks[i, :int(nums[i])].tolist() for i in range(n)]
        return (ids, res) if return_result else ids
