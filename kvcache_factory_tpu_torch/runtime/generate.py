"""Greedy generation: prefill, then a Python decode loop (port of
``kvcache_factory_tpu/runtime/generate.py``).

Behavioral contract from the reference protocol (run_longbench.py:266-275):
greedy, at least ``min_new_tokens`` tokens before EOS can stop generation
(the EOS logit is masked until then), stop on any of ``eos_token_ids`` or
after ``max_new_tokens``; finished rows are padded with 0 and
``num_tokens`` counts each row's tokens, its EOS included.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import CompressionConfig, GenerationConfig, ModelConfig, QuantConfig
from ..models import llama
from ..parallel.mesh import SequenceParallelGroup


class GenerateResult(NamedTuple):
    tokens: torch.Tensor       # [B, max_new_tokens] generated ids (0 after EOS)
    num_tokens: torch.Tensor   # [B] count of valid generated tokens
    cache: llama.Cache  # KVCache, or Int8KVCache / Int4KVCache with quant_cfg
    # [B, max_new_tokens, V] fp32 logits each token was chosen from (entry 0
    # is the prefill's), when requested; rows past a stop are not filled.
    logits: Optional[torch.Tensor] = None


@torch.no_grad()
def generate(
    params: dict,
    model_cfg: ModelConfig,
    comp_cfg: CompressionConfig,
    gen_cfg: GenerationConfig,
    tokens,                  # [B, S] right-padded prompt (tensor or array)
    true_len,                # [B]
    cache_capacity: int,
    *,
    quant_cfg: Optional[QuantConfig] = None,
    device="cuda",
    return_logits: bool = False,
    sparse_budgets=None,     # [L, Hq, 2] MInference per-head budgets
    sp_group: Optional[SequenceParallelGroup] = None,
    rng: Optional[torch.Generator] = None,  # cam, random (llama.prefill)
    head_capacity=None,                     # [L, H] int (headkv)
) -> GenerateResult:
    """Greedy generation.  With ``sp_group`` every rank passes the same
    prompts: prefill splits their rows over the ranks, and decode runs on
    every rank over the same cache (the JAX engine replicates decode over
    the sp axis, ``runtime/engine.py:113-119``)."""
    if gen_cfg.do_sample:
        raise NotImplementedError("sampling is not ported yet (ROADMAP.md "
                                  "queue 1 item 5)")
    tokens = torch.as_tensor(tokens, device=device).to(torch.int64)
    true_len = torch.as_tensor(true_len, device=device).to(torch.int32)
    B = tokens.shape[0]
    max_new = gen_cfg.max_new_tokens
    dev = tokens.device

    if sparse_budgets is not None:
        sparse_budgets = torch.as_tensor(sparse_budgets, device=device).to(torch.int32)
    if head_capacity is not None:
        head_capacity = torch.as_tensor(head_capacity, device=device).to(torch.int32)
    pre = llama.prefill(params, model_cfg, comp_cfg, tokens, true_len,
                        cache_capacity, quant=quant_cfg, sparse_budgets=sparse_budgets,
                        sp_group=sp_group, rng=rng, head_capacity=head_capacity)
    vocab = pre.logits_last.shape[-1]
    eos_ids = [e for e in gen_cfg.eos_token_ids if 0 <= e < vocab]
    eos = torch.tensor(list(gen_cfg.eos_token_ids) or [-1], device=dev)
    eos_mask = torch.zeros(vocab, dtype=torch.bool, device=dev)
    eos_mask[eos_ids] = True

    def suppress_eos(logits, allow_eos: bool):
        """HF min_length semantics: before min_new_tokens the EOS logit is
        masked so the runner-up token is emitted."""
        if allow_eos:
            return logits
        return logits.masked_fill(eos_mask, float("-inf"))

    def is_eos(tok):
        return (tok[:, None] == eos[None]).any(dim=-1)

    all_logits = None
    if return_logits:
        all_logits = torch.zeros((B, max_new, vocab), dtype=torch.float32, device=dev)
        all_logits[:, 0] = pre.logits_last
    first = suppress_eos(pre.logits_last, gen_cfg.min_new_tokens <= 1).argmax(-1)
    out = torch.zeros((B, max_new), dtype=torch.int64, device=dev)
    out[:, 0] = first
    num = torch.ones((B,), dtype=torch.int32, device=dev)
    done = is_eos(first) & (gen_cfg.min_new_tokens <= 1)
    cur, cache = first, pre.cache

    for step in range(1, max_new):
        # Without EOS ids no row can finish early, so the loop needs no
        # device-to-host read per step.
        if gen_cfg.eos_token_ids and bool(done.all()):
            break
        logits, cache = llama.decode_step(params, model_cfg, cur, cache,
                                          quant=quant_cfg)
        if return_logits:
            all_logits[:, step] = logits
        nxt = suppress_eos(logits, step + 1 >= gen_cfg.min_new_tokens).argmax(-1)
        out[:, step] = torch.where(done, 0, nxt)
        num += (~done).to(torch.int32)
        cur = torch.where(done, cur, nxt)
        done = done | is_eos(nxt)
    return GenerateResult(out, num, cache, all_logits)
