"""Sliding-window attention in the port against the JAX package.

The masks of ``blocked_causal_attention`` (with a window and with chunk row
offsets), the fp32 reference forward, and a Mistral-shaped model (2
layers, hidden 256, 4 query heads, 2 KV heads, head_dim 128, sliding
window 24) whose prefill and decode go through K1-SW's and K2-K4's plain
versions, as ``tests/test_sliding_window_kernels.py`` drives the JAX
kernels.  Inputs come from ``np.random.default_rng``; the JAX weights are
carried across with ``params_from_jax``.

Tolerances: fp32 against fp32 with another summation order, 2e-5 on
attention outputs and logits of order 1 (the JAX kernel tests' own); token
streams and cache lengths exact; int8 decode logits 1e-4 and int4 within
``tests/test_torch_quant_decode.py``'s limits (the JAX K4 rounds q and its
probability weights to bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.cache import quant_cache as jq
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.ops import attention as jattn
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.cache import quant_cache as tq
from kvcache_factory_tpu_torch.models import llama as tllama
from kvcache_factory_tpu_torch.models.reference import forward_logits
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.ops import attention as tattn

D = 128
TOL = dict(rtol=2e-5, atol=2e-5)
MODEL = dict(model_type="mistral", vocab_size=256, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=D,
             max_position_embeddings=512, dtype="float32", sliding_window=24)
SNAPKV = dict(method="snapkv", max_capacity_prompt=32, window_size=8, kernel_size=7,
              pooling="maxpool")
FULLKV = dict(method="fullkv", max_capacity_prompt=512)
S = 64


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("window,offset,S_q,lengths", [
    (17, None, 96, [96, 70]),        # a window inside one q block
    (40, None, 96, [1, 96]),         # a window across q blocks, a one-token prompt
    (None, 40, 48, [96, 60]),        # a scalar chunk offset
    (None, [0, 70], 26, [96, 90]),   # per-row offsets, a ragged chunk
    (24, [33, 64], 32, [96, 80]),    # per-row offsets under a window
])
def test_blocked_causal_attention_window_and_offsets_match_jax(window, offset, S_q, lengths):
    rng = np.random.default_rng(4)
    B, Hq, Hk, Sk = 2, 4, 2, 96
    q = rng.standard_normal((B, Hq, S_q, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hk, Sk, D)).astype(np.float32) for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    got = tattn.blocked_causal_attention(
        t(q), t(k), t(v), t(lens), window, q_block=32,
        row_offset=None if offset is None else t(np.asarray(offset, np.int32)))
    want = jattn.blocked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), window,
        q_block=32, row_offset=None if offset is None else jnp.asarray(offset, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_blocked_causal_attention_refuses_unequal_lengths_without_offset():
    x = torch.zeros(1, 2, 8, D)
    with pytest.raises(ValueError, match="row_offset"):
        tattn.blocked_causal_attention(x, torch.zeros(1, 2, 16, D), torch.zeros(1, 2, 16, D),
                                       torch.tensor([8]))


@pytest.fixture(scope="module")
def mistral():
    jc, tc = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, MODEL["vocab_size"], (2, S)).astype(np.int32)
    step = jax.jit(lambda p, tok, c: jllama.decode_step(p, jc, tok, c, attn_backend="xla"))
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, toks=toks, step=step)


def test_reference_forward_applies_the_window(mistral):
    """``forward_logits`` (the card's fp32 yardstick) against the JAX
    prefill's logits at every position, and not the dense function."""
    m = mistral
    lens = np.full((2,), S, np.int32)
    want = jllama.prefill(m["jp"], m["jc"], jcfg.CompressionConfig(**FULLKV),
                          jnp.asarray(m["toks"]), jnp.asarray(lens), S,
                          return_all_logits=True, attn_backend="xla").all_logits
    got = forward_logits(m["tp"], m["tc"], torch.tensor(m["toks"]), q_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = forward_logits(m["tp"], dataclasses.replace(m["tc"], sliding_window=None),
                           torch.tensor(m["toks"]))
    assert (dense - got).abs().max() > 1e-3


# fullkv: every row's cache index is its position, so the decode window
# bites; snapkv at 64 and 55 tokens compresses to 32 entries (not window-
# masked); snapkv at 20 and 27 tokens takes the no-compress branch, where
# the window bites once the rows pass 24 tokens.
CASES = {"fullkv": (FULLKV, [S, S - 9]), "snapkv": (SNAPKV, [S, S - 9]),
         "snapkv_short": (SNAPKV, [20, 27])}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_jax(mistral, case):
    """Windowed prefill (K1-SW's plain version; snapkv scores by its own
    matmul) and six teacher-forced decode steps with the window bound:
    logits, cache lengths and the valid cache entries against JAX."""
    m = mistral
    comp, lengths = CASES[case]
    lens = np.asarray(lengths, np.int32)
    cap = (S if comp["method"] == "fullkv" else 32) + 8
    jres = jllama.prefill(m["jp"], m["jc"], jcfg.CompressionConfig(**comp),
                          jnp.asarray(m["toks"]), jnp.asarray(lens), cap, attn_backend="xla")
    tres = tllama.prefill(m["tp"], m["tc"], tcfg.CompressionConfig(**comp),
                          torch.tensor(m["toks"]), torch.tensor(lens), cap)
    np.testing.assert_allclose(tres.logits_last.numpy(), np.asarray(jres.logits_last), **TOL)
    jlen = np.asarray(jres.cache.lengths)
    np.testing.assert_array_equal(tres.cache.lengths.numpy(), jlen)
    jk = np.asarray(jres.cache.k)
    for li, b, h in np.ndindex(*jlen.shape):
        n = jlen[li, b, h]
        np.testing.assert_allclose(tres.cache.k[li, b, h, :n].numpy(), jk[li, b, h, :n], **TOL)

    jcache, tcache = jres.cache, tres.cache
    dense_cache = tllama.prefill(m["tp"], m["tc"], tcfg.CompressionConfig(**comp),
                                 torch.tensor(m["toks"]), torch.tensor(lens), cap).cache
    dense_cfg = dataclasses.replace(m["tc"], sliding_window=None)
    moved = 0.0
    for tok in np.random.default_rng(1).integers(0, MODEL["vocab_size"], (6, 2)):
        jlogits, jcache = m["step"](m["jp"], jnp.asarray(tok, jnp.int32), jcache)
        tlogits, tcache = tllama.decode_step(m["tp"], m["tc"], torch.tensor(tok), tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
        dlogits, dense_cache = tllama.decode_step(m["tp"], dense_cfg, torch.tensor(tok),
                                                  dense_cache)
        moved = max(moved, (dlogits - tlogits).abs().max().item())
    np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))
    # The decode window bites exactly where a row's cache index is its
    # position; compressed rows are left alone.
    assert (moved > 1e-3) == (case != "snapkv"), moved


def test_window_lower_marks_identity_rows_only():
    cfg = tcfg.ModelConfig(**MODEL)
    lens = torch.tensor([[30, 32], [10, 31]], dtype=torch.int32)
    pos = torch.tensor([30, 40], dtype=torch.int32)
    got = tllama.window_lower(cfg, lens, pos)
    # row 0: identity, lower = len + 1 - 24; row 1 (compressed): 0.
    assert got.tolist() == [[7, 0], [0, 0]] and got.dtype == torch.int32
    assert tllama.window_lower(dataclasses.replace(cfg, sliding_window=None), lens, pos) is None


@pytest.mark.parametrize("nbits", [8, 4])
def test_quantized_decode_window_matches_jax(mistral, nbits):
    """K3/K4's plain versions get the window bound: a cache of identity rows
    (64 tokens, window 24) against the JAX decode step with the Pallas
    quantized kernels in interpret mode, and not the dense function."""
    m = mistral
    rng = np.random.default_rng(71)
    L, B, H, C = 2, 2, 2, 128 if nbits == 8 else 256
    k = jnp.asarray(rng.standard_normal((L, B, H, C, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((L, B, H, C, D)), jnp.float32)
    make = jq.from_packed_prefill_tpu if nbits == 8 else jq.from_packed_prefill_tpu4
    jcache = make(k, v, jnp.full((L, B, H), 64, jnp.int32), jnp.full((B,), 64, jnp.int32))
    tcache = tq.quant_cache_from_jax(*(np.asarray(a) for a in jcache), nbits=nbits)
    qcfg = tcfg.QuantConfig(nbits=nbits)
    tok = np.asarray([3, 5], np.int32)
    jlogits, _ = jllama.decode_step(m["jp"], m["jc"], jnp.asarray(tok), jcache,
                                    quant=jcfg.QuantConfig(nbits=nbits), pallas_interpret=True)
    dense = tllama.decode_step(m["tp"], dataclasses.replace(m["tc"], sliding_window=None),
                               torch.tensor(tok),
                               tq.quant_cache_from_jax(*(np.asarray(a) for a in jcache),
                                                       nbits=nbits), quant=qcfg)[0]
    tlogits, _ = tllama.decode_step(m["tp"], m["tc"], torch.tensor(tok), tcache, quant=qcfg)
    want = np.asarray(jlogits)
    if nbits == 8:
        np.testing.assert_allclose(tlogits.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        rel = np.linalg.norm(tlogits.numpy() - want, axis=-1) / np.linalg.norm(want, axis=-1)
        assert rel.max() < 2e-2 and np.abs(tlogits.numpy() - want).max() < 0.03
    assert (dense - tlogits).abs().max() > 1e-3
