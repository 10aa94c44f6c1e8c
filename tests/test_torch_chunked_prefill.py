"""The port's chunked prefill against the JAX package's and against its own
one-shot prefill.

A Mistral-shaped model (2 layers, hidden 256, 4 query heads, 2 KV heads,
head_dim 128, vocab 256, sliding window 24) in fp32 on the CPU, so every
chunk's attention is K1-chunk's plain version under the window; the JAX
weights are carried across with ``params_from_jax`` and the prompts come
from ``np.random.default_rng``.

Tolerances: fp32 against fp32 with another summation order, 2e-5 on
logits and cache entries of order 1 (the JAX chunked-prefill tests' own);
cache lengths, positions and greedy tokens exact.  The int8/int4 caches
quantize fp32 values that agree to 2e-5, so a code may move by one step
where a value sits at a rounding edge, and the bf16 scale and zero by one
bf16 ulp: the dequantized caches agree within one code step (the token's
scale) plus one bf16 ulp of its zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.cache import quant_cache as jq
from kvcache_factory_tpu.models import chunked_prefill as jchunked
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.cache import quant_cache as tq
from kvcache_factory_tpu_torch.models import chunked_prefill as tchunked
from kvcache_factory_tpu_torch.models import llama as tllama
from kvcache_factory_tpu_torch.models.weights import params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)
MODEL = dict(model_type="mistral", vocab_size=256, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=128,
             max_position_embeddings=512, dtype="float32", sliding_window=24)
SNAPKV = dict(method="snapkv", max_capacity_prompt=48, window_size=8, kernel_size=7,
              pooling="maxpool")
FULLKV = dict(method="fullkv", max_capacity_prompt=512)
S, CAP = 128, 160


@pytest.fixture(scope="module")
def model():
    jc = jcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(2), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(3).integers(0, MODEL["vocab_size"], (2, S)).astype(np.int32)
    return dict(jp=jp, tp=tp, toks=toks, lens=np.asarray([S, 101], np.int32))


def _configs(window):
    m = dict(MODEL, sliding_window=window)
    return jcfg.ModelConfig(**m), tcfg.ModelConfig(**m)


def _assert_caches_match(got, want_lengths, want_k, want_v):
    """Lengths exactly; every valid (layer, row, head) entry within TOL."""
    lens = np.asarray(want_lengths)
    np.testing.assert_array_equal(got.lengths.numpy(), lens)
    want_k, want_v = np.asarray(want_k), np.asarray(want_v)
    for li, b, h in np.ndindex(*lens.shape):
        n = lens[li, b, h]
        np.testing.assert_allclose(got.k[li, b, h, :n].numpy(), want_k[li, b, h, :n], **TOL)
        np.testing.assert_allclose(got.v[li, b, h, :n].numpy(), want_v[li, b, h, :n], **TOL)


def _greedy(tp, tc, res, n=4):
    """``n`` greedy tokens decoded from a prefill result (its cache is
    updated in place)."""
    tok, cache, out = res.logits_last.argmax(-1), res.cache, []
    for _ in range(n):
        logits, cache = tllama.decode_step(tp, tc, tok, cache)
        tok = logits.argmax(-1)
        out.append(tok.tolist())
    return out


CASES = [(m, c, 24) for m in ("snapkv", "fullkv") for c in (16, 32, 128)] \
    + [("snapkv", 32, None), ("fullkv", 32, None)]


@pytest.mark.parametrize("method,chunk,window", CASES)
def test_prefill_chunked_matches_jax_and_oneshot(model, method, chunk, window):
    """Chunked prefill at chunk sizes 16, 32 and 128 (one chunk is the
    whole bucket), under the window and without it: logits, cache lengths,
    positions and valid entries against the JAX ``prefill_chunked`` and
    against the port's one-shot ``prefill``, then four greedy tokens from
    each cache."""
    m = model
    jc, tc = _configs(window)
    kw = SNAPKV if method == "snapkv" else FULLKV
    jcomp, tcomp = jcfg.CompressionConfig(**kw), tcfg.CompressionConfig(**kw)
    toks, lens = torch.tensor(m["toks"]), torch.tensor(m["lens"])
    got = tchunked.prefill_chunked(m["tp"], tc, tcomp, toks, lens, CAP, chunk)
    want = jchunked.prefill_chunked(m["jp"], jc, jcomp, jnp.asarray(m["toks"]),
                                    jnp.asarray(m["lens"]), CAP, chunk)
    one = tllama.prefill(m["tp"], tc, tcomp, toks, lens, CAP)

    np.testing.assert_allclose(got.logits_last.numpy(), np.asarray(want.logits_last), **TOL)
    _assert_caches_match(got.cache, want.cache.lengths, want.cache.k, want.cache.v)
    np.testing.assert_array_equal(got.cache.positions.numpy(), m["lens"])
    np.testing.assert_allclose(got.logits_last.numpy(), one.logits_last.numpy(), **TOL)
    _assert_caches_match(got.cache, one.cache.lengths, one.cache.k, one.cache.v)
    assert _greedy(m["tp"], tc, got) == _greedy(m["tp"], tc, one)


@pytest.mark.parametrize("window", [24, None])
def test_short_prompt_store_placement_matches_jax_and_oneshot(model, window):
    """Prompts shorter than the trailing-query store (WK = 32) but longer
    than the capacity (12) do compress; ``finalize`` rolls the store so
    that every stored row sits at its global position (the JAX package's
    short-prompt fix), and the cache equals both references."""
    m = model
    jc, tc = _configs(window)
    kw = dict(SNAPKV, max_capacity_prompt=12)
    toks = np.random.default_rng(11).integers(0, MODEL["vocab_size"], (2, 64)).astype(np.int32)
    lens = np.asarray([20, 27], np.int32)
    got = tchunked.prefill_chunked(m["tp"], tc, tcfg.CompressionConfig(**kw),
                                   torch.tensor(toks), torch.tensor(lens), 64, 32)
    want = jchunked.prefill_chunked(m["jp"], jc, jcfg.CompressionConfig(**kw),
                                    jnp.asarray(toks), jnp.asarray(lens), 64, 32)
    one = tllama.prefill(m["tp"], tc, tcfg.CompressionConfig(**kw), torch.tensor(toks),
                         torch.tensor(lens), 64)
    assert (got.cache.lengths == 12).all()
    _assert_caches_match(got.cache, want.cache.lengths, want.cache.k, want.cache.v)
    _assert_caches_match(got.cache, one.cache.lengths, one.cache.k, one.cache.v)
    np.testing.assert_allclose(got.logits_last.numpy(), np.asarray(want.logits_last), **TOL)


def _within_one_code_step(got, want, lengths):
    """Two per-token caches, dequantized: every valid entry within one code
    step (the larger of the two tokens' scales) plus one bf16 ulp of the
    zero (2^-7 of its magnitude)."""
    for (x, y), col in zip(zip(tq.dequantize_kv(got), tq.dequantize_kv(want)), (0, 2)):
        sa, sb = got.scales.float(), want.scales.float()
        step = torch.maximum(sa[..., col], sb[..., col]) \
            + sb[..., col + 1].abs() * 2.0 ** -7 + 1e-6
        err = (x - y).abs()
        for li, b, h in np.ndindex(*lengths.shape):
            n = lengths[li, b, h]
            assert (err[li, b, h, :n] <= step[li, b, h, :n, None]).all(), (li, b, h)


@pytest.mark.parametrize("method", ["snapkv", "fullkv"])
@pytest.mark.parametrize("nbits", [8, 4])
def test_quantized_prefill_chunked_within_one_code_step(model, nbits, method):
    """With ``QuantConfig(nbits)`` the chunked prefill builds the per-token
    cache with the one-shot tail (``store_packed_layer``): lengths exact,
    and the dequantized cache within one code step of the JAX package's
    chunked cache quantized by its own ``from_packed_prefill_tpu*`` and of
    the port's quantized one-shot cache."""
    m = model
    jc, tc = _configs(24)
    kw = SNAPKV if method == "snapkv" else FULLKV
    cap = 256
    q = tcfg.QuantConfig(nbits=nbits)
    toks, lens = torch.tensor(m["toks"]), torch.tensor(m["lens"])
    got = tchunked.prefill_chunked(m["tp"], tc, tcfg.CompressionConfig(**kw), toks, lens,
                                   cap, 32, quant=q)
    assert isinstance(got.cache, tq.Int8KVCache if nbits == 8 else tq.Int4KVCache)
    jres = jchunked.prefill_chunked(m["jp"], jc, jcfg.CompressionConfig(**kw),
                                    jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), cap, 32)
    make = jq.from_packed_prefill_tpu if nbits == 8 else jq.from_packed_prefill_tpu4
    jcache = make(jres.cache.k, jres.cache.v, jres.cache.lengths, jres.cache.positions)
    want = tq.quant_cache_from_jax(*(np.asarray(a) for a in jcache), nbits=nbits)
    lengths = np.asarray(jres.cache.lengths)
    np.testing.assert_array_equal(got.cache.lengths.numpy(), lengths)
    np.testing.assert_array_equal(got.cache.positions.numpy(), m["lens"])
    _within_one_code_step(got.cache, want, lengths)
    one = tllama.prefill(m["tp"], tc, tcfg.CompressionConfig(**kw), toks, lens, cap, quant=q)
    np.testing.assert_array_equal(got.cache.lengths.numpy(), one.cache.lengths.numpy())
    _within_one_code_step(got.cache, one.cache, lengths)
    np.testing.assert_allclose(got.logits_last.numpy(), one.logits_last.numpy(), **TOL)


def test_chunk_step_per_row_offsets_and_inert_rows(model):
    """One ``chunk_step`` with a ``[B]`` offset advances rows at different
    depths, as the batching engine's pooled admissions do, and leaves a
    row whose offset is past its prompt untouched: the state equals the
    rows' own runs, and an inert row (``true_len`` 0) stays zero."""
    m = model
    _, tc = _configs(24)
    comp = tcfg.CompressionConfig(**SNAPKV)
    toks = torch.tensor(m["toks"], dtype=torch.int64)
    # Row 0 alone: chunks at 0 and 32.  Row 1 alone: the chunk at 0.
    solo = [tchunked.init_chunked_state(tc, comp, 1, S, "cpu") for _ in range(2)]
    for c0 in (0, 32):
        tchunked.chunk_step(m["tp"], tc, toks[:1, c0:c0 + 32], c0, [S], solo[0])
    tchunked.chunk_step(m["tp"], tc, toks[1:, :32], 0, [101], solo[1])
    # Pooled: row 0 at depth 32 over the chunk at 0 already taken, row 1
    # fresh, row 2 inert.
    pool = tchunked.init_chunked_state(tc, comp, 3, S, "cpu")
    tchunked.chunk_step(m["tp"], tc, torch.cat([toks[:1, :32], toks[:2, :32]]),
                        [0, 0, 0], [S, 0, 0], pool)
    chunk = torch.stack([toks[0, 32:64], toks[1, :32], toks[1, :32]])
    tchunked.chunk_step(m["tp"], tc, chunk, np.asarray([32, 0, 0]), np.asarray([S, 101, 0]),
                        pool)
    for r, ref in ((0, solo[0]), (1, solo[1])):
        for got, want in zip(pool, ref):
            axis = 0 if got.dim() == 2 else 1
            np.testing.assert_allclose(got.select(axis, r).numpy(), want.select(axis, 0).numpy(),
                                       **TOL)
    assert not any(t.select(0 if t.dim() == 2 else 1, 2).any() for t in pool)


def test_chunk_step_refuses_a_chunk_past_the_buffer(model):
    _, tc = _configs(24)
    comp = tcfg.CompressionConfig(**SNAPKV)
    state = tchunked.init_chunked_state(tc, comp, 1, 64, "cpu")
    with pytest.raises(ValueError, match="runs past"):
        tchunked.chunk_step(model["tp"], tc, torch.zeros((1, 32), dtype=torch.int64), 48,
                            [64], state)


@pytest.mark.parametrize("kw", [
    dict(method="h2o", max_capacity_prompt=48, window_size=8),
    dict(method="pyramidkv", max_capacity_prompt=48, window_size=8),
], ids=["h2o", "pyramidkv"])
def test_unported_methods_raise_naming_the_roadmap_item(model, kw):
    _, tc = _configs(24)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 1.10"):
        tchunked.prefill_chunked(model["tp"], tc, tcfg.CompressionConfig(**kw),
                                 torch.tensor(model["toks"]), torch.tensor(model["lens"]),
                                 CAP, 32)


def test_chunked_state_shapes_keep_the_trailing_query_store():
    """WK = min(max(window, 32), S): the policies read q only through its
    last ``window`` rows."""
    tc = tcfg.ModelConfig(**MODEL)
    for window, S_, wk in ((8, 128, 32), (40, 128, 40), (8, 16, 16)):
        kb, vb, qw, xl = tchunked.init_chunked_state(
            tc, tcfg.CompressionConfig(**dict(SNAPKV, window_size=window)), 3, S_, "cpu")
        assert kb.shape == vb.shape == (2, 3, 2, S_, 128)
        assert qw.shape == (2, 3, 4, wk, 128) and xl.shape == (3, 256)
