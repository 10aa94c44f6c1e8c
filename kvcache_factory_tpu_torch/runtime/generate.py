"""Generation: prefill, then a Python decode loop (port of
``kvcache_factory_tpu/runtime/generate.py``).

Behavioral contract from the reference protocol (run_longbench.py:266-275):
greedy, at least ``min_new_tokens`` tokens before EOS can stop generation
(the EOS logit is masked until then), stop on any of ``eos_token_ids`` or
after ``max_new_tokens``; finished rows are padded with 0 and
``num_tokens`` counts each row's tokens, its EOS included.  With
``do_sample`` each token is drawn from the temperature / top-k / top-p
masked logits by Gumbel-max, as ``jax.random.categorical`` draws, with
noise from a ``torch.Generator`` (:func:`gumbel_draw`).  No step reads the
device from the host unless EOS ids are given.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import CompressionConfig, GenerationConfig, ModelConfig, QuantConfig
from ..models import llama
from ..parallel.mesh import ExpertShard, SequenceParallelGroup, StagedGroup
from ..policies.methods import HeadShard


class GenerateResult(NamedTuple):
    tokens: torch.Tensor       # [B, max_new_tokens] generated ids (0 after EOS)
    num_tokens: torch.Tensor   # [B] count of valid generated tokens
    cache: llama.Cache  # the configured cache (llama.init_prefill_cache)
    # [B, max_new_tokens, V] fp32 logits each token was chosen from (entry 0
    # is the prefill's), when requested; rows past a stop are not filled.
    logits: Optional[torch.Tensor] = None


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1)


def mask_logits(logits: torch.Tensor, gen_cfg: GenerationConfig) -> torch.Tensor:
    """Temperature, then top-k and top-p as -inf masks (JAX
    ``generate.py:37-53``).  top-k is a threshold on the value: everything
    below the k-th largest value goes, so ties at it all stay.  top-p sorts
    descending, takes the fp32 softmax's cumulative sum, and keeps every
    logit at or above the one at index ``sum(cum < top_p)``: the smallest
    set whose mass reaches ``top_p``, with its ties.  Neither depends on the
    order of tied entries."""
    logits = logits / max(gen_cfg.temperature, 1e-6)
    if gen_cfg.top_k:
        kth = torch.topk(logits, gen_cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if gen_cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits.float(), dim=-1), dim=-1)
        # An index past the end (rounding leaves the total below top_p)
        # keeps everything, as JAX's out-of-range gather does.
        cutoff_idx = (cum < gen_cfg.top_p).sum(dim=-1, keepdim=True).clamp(
            max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def gumbel_draw(rng: torch.Generator, step: int, shape: Tuple[int, ...]) -> torch.Tensor:
    """Step ``step``'s standard Gumbel noise, fp32 on the generator's
    device: ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``, as
    ``jax.random.gumbel``.  :func:`generate` looks it up as a module global
    at each step, so a test can hand it JAX's noise."""
    u = torch.rand(shape, generator=rng, device=rng.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_token(logits: torch.Tensor, gen_cfg: GenerationConfig,
                 noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Greedy (the reference protocol), or a draw from the masked logits by
    Gumbel-max: ``argmax(masked + noise)``, masked entries staying -inf."""
    if not gen_cfg.do_sample:
        return greedy_sample(logits)
    return (mask_logits(logits, gen_cfg) + noise).argmax(dim=-1)


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
    tp: Optional[StagedGroup] = None,
    shard: Optional[HeadShard] = None,
    ep: Optional[ExpertShard] = None,
) -> GenerateResult:
    """Greedy or sampled generation.  ``rng`` (a generator on ``device``,
    seeded 0 when None, as JAX's ``PRNGKey(0)``) serves prefill's cam and
    random draws, then each sampled step's noise, in that order; the
    noise of step 0 serves its redraw with EOS suppressed under
    ``min_new_tokens > 1``, as JAX reuses ``k0``.  With ``sp_group`` every
    rank passes the same prompts: prefill splits their rows over the
    ranks, and decode runs on every rank over the same cache (the JAX
    engine replicates decode over the sp axis, ``runtime/engine.py:113-119``).
    With ``tp`` (and ``shard``) ``params`` and ``model_cfg`` are one rank's
    tensor-parallel shard and ``tokens`` its rows of the batch
    (``llama.prefill``); the logits each token is chosen from are gathered
    over the vocabulary, so the tp ranks choose the same tokens, and each
    sampled step's Gumbel noise is drawn at the whole batch's ``[B, V]`` on
    every rank from the same generator and sliced to the rank's rows.
    With ``ep`` ``params`` holds the rank's experts (``llama.ffn_block``)."""
    tokens = torch.as_tensor(tokens, device=device).to(torch.int64)
    true_len = torch.as_tensor(true_len, device=device).to(torch.int32)
    B = tokens.shape[0]
    max_new = gen_cfg.max_new_tokens
    dev = tokens.device

    if sparse_budgets is not None:
        sparse_budgets = torch.as_tensor(sparse_budgets, device=device).to(torch.int32)
    if head_capacity is not None:
        head_capacity = torch.as_tensor(head_capacity, device=device).to(torch.int32)
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    pre = llama.prefill(params, model_cfg, comp_cfg, tokens, true_len,
                        cache_capacity, quant=quant_cfg, sparse_budgets=sparse_budgets,
                        sp_group=sp_group, rng=rng, head_capacity=head_capacity, tp=tp,
                        shard=shard, ep=ep)
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

    b0, batch = (0, B) if shard is None else (shard.b0, shard.batch)

    def draw(logits, step):
        noise = None
        if gen_cfg.do_sample:
            noise = gumbel_draw(rng, step, (batch, vocab))[b0:b0 + B]
        return sample_token(logits, gen_cfg, noise)

    first = draw(suppress_eos(pre.logits_last, gen_cfg.min_new_tokens <= 1), 0)
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
        logits, cache = llama.decode_step(params, model_cfg, cur, cache, quant=quant_cfg,
                                          eviction_recent=comp_cfg.eviction_recent, tp=tp,
                                          ep=ep)
        if return_logits:
            all_logits[:, step] = logits
        nxt = draw(suppress_eos(logits, step + 1 >= gen_cfg.min_new_tokens), step)
        out[:, step] = torch.where(done, 0, nxt)
        num += (~done).to(torch.int32)
        cur = torch.where(done, cur, nxt)
        done = done | is_eos(nxt)
    return GenerateResult(out, num, cache, all_logits)
