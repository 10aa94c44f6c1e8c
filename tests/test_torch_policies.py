"""Parity of the PyTorch port's SnapKV policy slice with the JAX package.

Same numpy inputs on both sides, fp32 on the CPU.  Scores agree to fp32
summation-order error (rtol/atol 1e-5 on values of at most the window
size); selections are compared as index sets and packed K/V over each
head's valid prefix ``[0, lengths[h])`` (rows past it are unspecified).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.policies import base as jbase
from kvcache_factory_tpu.policies import methods as jmethods
from kvcache_factory_tpu.policies import scoring as jscoring
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.policies import base as tbase
from kvcache_factory_tpu_torch.policies import methods as tmethods
from kvcache_factory_tpu_torch.policies import scoring as tscoring

TOL = dict(rtol=1e-5, atol=1e-5)
D = 128


def t(x):
    return torch.from_numpy(np.array(x))


def qkv(seed, hq, hkv, s):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((hq, s, D), (hkv, s, D), (hkv, s, D)))


@pytest.mark.parametrize("pooling", ["avgpool", "maxpool"])
@pytest.mark.parametrize("kernel_size", [5, 7])
def test_pool1d(pooling, kernel_size):
    x = np.random.default_rng(0).standard_normal((3, 50)).astype(np.float32)
    np.testing.assert_allclose(
        tscoring.pool1d(t(x), kernel_size, pooling).numpy(),
        np.asarray(jscoring.pool1d(jnp.asarray(x), kernel_size, pooling)), **TOL)


@pytest.mark.parametrize("pooling", ["avgpool", "maxpool"])
@pytest.mark.parametrize("kernel_size", [5, 7])
def test_masked_pool(pooling, kernel_size):
    x = np.random.default_rng(1).standard_normal((3, 50)).astype(np.float32)
    got = tscoring.masked_pool(t(x), torch.tensor(37), kernel_size, pooling).numpy()
    want = np.asarray(jscoring.masked_pool(jnp.asarray(x), jnp.int32(37),
                                           kernel_size, pooling))
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[:, 37:] == jscoring.NEG_INF).all()


@pytest.mark.parametrize("true_len", [96, 61, 5])
def test_window_attention_scores(true_len):
    q, k, _ = qkv(2, 4, 4, 96)
    got = tscoring.window_attention_scores(t(k), t(q), torch.tensor(true_len), 8)
    want = jscoring.window_attention_scores(jnp.asarray(k), jnp.asarray(q),
                                            jnp.int32(true_len), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _both_select(k, v, scores, budget, w, true_len, cap, no_compress):
    got, gidx = tbase.select_and_pack(
        t(k), t(v), t(scores), t(budget), w, torch.tensor(true_len), cap,
        torch.tensor(no_compress), return_indices=True)
    want, widx = jbase.select_and_pack(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(scores), jnp.asarray(budget),
        w, jnp.int32(true_len), cap, jnp.asarray(no_compress), return_indices=True)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    return got, want, gidx.numpy(), np.asarray(widx)


def test_select_and_pack_breaks_maxpool_ties_like_lax_top_k():
    """maxpool turns one high score into a plateau of exactly equal values;
    the budget cuts through such plateaus, so tie order decides membership."""
    H, S, w, cap, tl = 3, 80, 8, 24, 77
    rng = np.random.default_rng(3)
    raw = rng.random((H, S)).astype(np.float32)
    raw[:, 10] = raw[:, 40] = raw[:, 41] = 5.0          # exact ties after pooling
    scores = np.asarray(jscoring.masked_pool(jnp.asarray(raw), jnp.int32(tl - w), 7,
                                             "maxpool"))
    budget = np.full(H, cap - w, np.int32)
    k, v = (rng.standard_normal((H, S, D)).astype(np.float32) for _ in range(2))
    got, want, gidx, widx = _both_select(k, v, scores, budget, w, tl, cap, False)
    np.testing.assert_array_equal(gidx, widx)          # same order, ties included
    for h in range(H):
        n = int(got.lengths[h])
        np.testing.assert_array_equal(got.k[h, :n].numpy(), np.asarray(want.k)[h, :n])
        np.testing.assert_array_equal(got.v[h, :n].numpy(), np.asarray(want.v)[h, :n])


def test_select_and_pack_no_compress_identity():
    H, S, w, cap, tl = 2, 64, 8, 40, 30
    rng = np.random.default_rng(4)
    scores = rng.random((H, S)).astype(np.float32)
    k, v = (rng.standard_normal((H, S, D)).astype(np.float32) for _ in range(2))
    got, want, _, _ = _both_select(k, v, scores, np.full(H, 22, np.int32), w, tl,
                                   cap, True)
    assert (got.lengths.numpy() == tl).all()
    np.testing.assert_array_equal(got.k[:, :tl].numpy(), np.asarray(want.k)[:, :tl])
    np.testing.assert_array_equal(got.k[:, :tl].numpy(), k[:, :tl])


@pytest.mark.parametrize("method,group_reduce,true_len", [
    ("snapkv", "none", 200), ("snapkv", "mean", 200), ("snapkv", "none", 50),
    ("fullkv", "none", 200)])
def test_compress_layer(method, group_reduce, true_len):
    S, Hq, Hkv = 256, 4, 2
    kw = dict(method=method, max_capacity_prompt=64, window_size=8,
              kernel_size=7, pooling="maxpool", group_reduce=group_reduce)
    tc, jc = tcfg.CompressionConfig(**kw), jcfg.CompressionConfig(**kw)
    cap = jc.layer_capacity(2, S)
    q, k, v = qkv(5, Hq, Hkv, S)
    got = tmethods.compress_layer(tc, 2, cap, t(k), t(v), t(q), torch.tensor(true_len),
                                  tmethods.LayerContext(0))
    want = jmethods.compress_layer(jc, 2, cap, jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(q), jnp.int32(true_len),
                                   jmethods.LayerContext(jnp.int32(0)))
    lens = np.asarray(want.lengths)
    np.testing.assert_array_equal(got.lengths.numpy(), lens)
    assert got.k.shape == want.k.shape
    for h in range(lens.shape[0]):
        n = int(lens[h])
        np.testing.assert_array_equal(got.k[h, :n].numpy(), np.asarray(want.k)[h, :n])
        np.testing.assert_array_equal(got.v[h, :n].numpy(), np.asarray(want.v)[h, :n])


@pytest.mark.parametrize("method", ["pyramidkv", "h2o", "adakv", "streamingllm"])
def test_unported_methods_raise(method):
    cfg = tcfg.CompressionConfig(method=method, max_capacity_prompt=64, window_size=8)
    q, k, v = qkv(6, 2, 2, 96)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmethods.compress_layer(cfg, 2, 64, t(k), t(v), t(q), torch.tensor(96),
                                tmethods.LayerContext(0))
