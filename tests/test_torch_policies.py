"""Parity of the PyTorch port's compression policies with the JAX package.

Same numpy inputs on both sides, fp32 on the CPU.  Scores agree to fp32
summation-order error (rtol/atol 1e-5 on values of at most the window
size); selections are compared as packed K/V over each head's valid prefix
``[0, lengths[h])`` (rows past it are unspecified), row by row and exactly:
the keys are distinct random rows, so equal rows in equal order are the
same selected indices in the same order.  Merged values (cam, LOOK-M) agree
within rtol/atol 1e-5; cam and random get JAX's own uniform draws.
"""

import torch_threads  # noqa: F401  (torch's thread share, first)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.evals import longbench as jlongbench
from kvcache_factory_tpu.policies import adakv as jadakv
from kvcache_factory_tpu.policies import base as jbase
from kvcache_factory_tpu.policies import cam as jcam
from kvcache_factory_tpu.policies import lookm as jlookm
from kvcache_factory_tpu.policies import methods as jmethods
from kvcache_factory_tpu.policies import scoring as jscoring
from kvcache_factory_tpu.policies import think as jthink
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.evals import longbench as tlongbench
from kvcache_factory_tpu_torch.policies import adakv as tadakv
from kvcache_factory_tpu_torch.policies import base as tbase
from kvcache_factory_tpu_torch.policies import cam as tcam
from kvcache_factory_tpu_torch.policies import lookm as tlookm
from kvcache_factory_tpu_torch.policies import methods as tmethods
from kvcache_factory_tpu_torch.policies import scoring as tscoring
from kvcache_factory_tpu_torch.policies import think as tthink

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




# ---------------------------------------------------------------------------
# The nine further methods and the LOOK-M pivot merge
# ---------------------------------------------------------------------------

S_POL, HQ, HKV, CAP, W, N_LAYERS = 256, 4, 2, 64, 8, 4
MERGED = ("cam", "pivot")  # values merged in fp32 (within TOL), not selected


def _policy_cfgs(method, group_reduce="none", **extra):
    kw = dict(method=method, max_capacity_prompt=CAP, window_size=W, kernel_size=7,
              pooling="maxpool", group_reduce=group_reduce, **extra)
    return tcfg.CompressionConfig(**kw), jcfg.CompressionConfig(**kw)


def _draw(cfg, key):
    """JAX's draw for the method, as compress_layer draws it from ``key``
    (cam: ``cam_merge_values``' [S, H_q]; random: [H_out, S])."""
    shape = tmethods.draw_shape(cfg, HQ, HKV, S_POL)
    return None if shape is None else np.asarray(jax.random.uniform(key, shape))


def _compress_both(method, group_reduce, true_len, layer_idx=1, seed=11, **extra):
    """Both packages' ``compress_layer`` on one example; returns (port, JAX,
    the port's config)."""
    tc, jc = _policy_cfgs(method, group_reduce, **extra)
    cap = jc.layer_capacity(N_LAYERS, S_POL)
    assert cap == tc.layer_capacity(N_LAYERS, S_POL)
    q, k, v = qkv(seed, HQ, HKV, S_POL)
    H_out = tc.cache_heads(HQ, HKV)
    hc = None
    if method == "headkv":
        hc = np.random.default_rng(seed).integers(0, 130, size=H_out).astype(np.int32)
    key = jax.random.PRNGKey(7)
    draw = _draw(tc, key)
    got = tmethods.compress_layer(
        tc, N_LAYERS, cap, t(k), t(v), t(q), torch.tensor(true_len),
        tmethods.LayerContext(layer_idx, None if hc is None else t(hc),
                              None if draw is None else t(draw)))
    want = jmethods.compress_layer(
        jc, N_LAYERS, cap, jnp.asarray(k), jnp.asarray(v), jnp.asarray(q),
        jnp.int32(true_len),
        jmethods.LayerContext(jnp.int32(layer_idx), None if hc is None else jnp.asarray(hc),
                              key if draw is not None else None))
    return got, want, tc


def _assert_packed_equal(got, want, merged=False):
    lens = np.asarray(want.lengths)
    np.testing.assert_array_equal(got.lengths.numpy(), lens)
    assert got.k.shape == want.k.shape and got.v.shape == want.v.shape
    for h in range(lens.shape[0]):
        n = int(lens[h])
        for g, w_ in ((got.k, want.k), (got.v, want.v)):
            if merged:
                np.testing.assert_allclose(g[h, :n].numpy(), np.asarray(w_)[h, :n], **TOL)
            else:
                np.testing.assert_array_equal(g[h, :n].numpy(), np.asarray(w_)[h, :n])


POLICY_METHODS = ("pyramidkv", "h2o", "streamingllm", "l2norm", "random", "adakv",
                  "headkv", "cam", "think", "pivot")


@pytest.mark.parametrize("true_len", [200, 50], ids=["compressed", "no_compress"])
@pytest.mark.parametrize("group_reduce", ["none", "mean"])
@pytest.mark.parametrize("method", POLICY_METHODS)
def test_compress_layer_matches_jax(method, group_reduce, true_len):
    """Lengths, and packed K/V over each head's valid prefix: exact for
    selections (think's zeroed channels included), within 1e-5 where values
    are merged (cam's V; LOOK-M's K and V).  ``pivot`` is snapkv with
    ``merge="pivot"``."""
    extra = dict(merge="pivot") if method == "pivot" else {}
    got, want, tc = _compress_both("snapkv" if method == "pivot" else method,
                                   group_reduce, true_len, **extra)
    merged = method in MERGED and true_len > CAP
    if method == "cam" and merged:
        # cam merges V only: K is selected exactly.
        lens = np.asarray(want.lengths)
        for h in range(lens.shape[0]):
            np.testing.assert_array_equal(got.k[h, :lens[h]].numpy(),
                                          np.asarray(want.k)[h, :lens[h]])
    _assert_packed_equal(got, want, merged=merged)
    if true_len < CAP:
        assert (got.lengths.numpy() == true_len).all()


@pytest.mark.parametrize("method", ["pyramidkv", "h2o", "streamingllm"])
def test_pivot_merge_after_each_selection_matches_jax(method):
    got, want, _ = _compress_both(method, "none", 200, merge="pivot")
    _assert_packed_equal(got, want, merged=True)


@pytest.mark.parametrize("layer_idx", [0, 1, 3])
def test_l2norm_skip_layers_keep_the_prompt(layer_idx):
    """Layers in ``skip_layers`` (0, 1) take the no-compress branch; the
    others keep the max_capacity_prompt smallest key norms, no window."""
    got, want, _ = _compress_both("l2norm", "none", 200, layer_idx=layer_idx)
    _assert_packed_equal(got, want)
    assert (got.lengths.numpy() == (200 if layer_idx in (0, 1) else CAP)).all()


@pytest.mark.parametrize("true_len", [256, 200, 61])
def test_full_attention_scores(true_len):
    """H2O's scores over 256-row blocks (here 64, so four blocks and the
    trailing window's causal quirk in the last)."""
    q, k, _ = qkv(12, 4, 4, 256)
    got = tscoring.full_attention_scores(t(k), t(q), torch.tensor(true_len), 8, row_block=64)
    want = jscoring.full_attention_scores(jnp.asarray(k), jnp.asarray(q),
                                          jnp.int32(true_len), 8, row_block=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("true_len", [4096, 3000, 1500, 500])
def test_pyramid_budget_matches_jax(true_len):
    """Both branches (below and above 2 * base tokens, and the clamp of
    max_num to q_len - w) at every layer of a 32-layer model."""
    kw = dict(method="pyramidkv", max_capacity_prompt=2048, window_size=8)
    tc, jc = tcfg.CompressionConfig(**kw), jcfg.CompressionConfig(**kw)
    got = [int(tmethods.pyramid_budget(tc, 32, li, torch.tensor(true_len))) for li in range(32)]
    want = [int(jmethods.pyramid_budget(jc, 32, jnp.int32(li), jnp.int32(true_len)))
            for li in range(32)]
    assert got == want
    if true_len == 4096:
        assert got == [3978 - 125 * li for li in range(32)]


@pytest.mark.parametrize("normalize", [True, False])
def test_adakv_budgets_break_ties_like_lax_top_k(normalize):
    """Heads with exactly equal scores: the global top-(H * base) cuts
    through plateaus that span heads, so the tie rule (lower flat index
    first) decides each head's count."""
    H, S, base = 4, 64, 20
    rng = np.random.default_rng(13)
    scores = rng.random((H, S)).astype(np.float32)
    scores[1] = scores[0]                      # two identical heads
    scores[2, :30] = scores[3, :30] = 0.5      # plateaus across heads
    scores[:, 50:] = jscoring.NEG_INF
    got = tadakv.adakv_budgets(t(scores), base, 0.2, normalize, torch.tensor(50), 56)
    want = jadakv.adakv_budgets(jnp.asarray(scores), base, 0.2, normalize, jnp.int32(50),
                                jnp.int32(56))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_think_drop_set_matches_lax_top_k():
    """Equal saliencies (planted) go to the lower channel first."""
    rng = np.random.default_rng(14)
    sal = rng.random((3, 128)).astype(np.float32)
    sal[:, 10:20] = sal[:, 40:50] = 0.01
    got = tthink.think_drop_channels(t(sal), 51).numpy()
    want = np.asarray(jax.lax.top_k(-jnp.asarray(sal), 51)[1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("group_reduce", ["none", "mean"])
def test_think_prune_channels_matches_jax(group_reduce):
    """51 of 128 channels zeroed below ``length - recent`` rows, none above."""
    q, k, _ = qkv(15, 4, 4, 96)
    lengths = np.array([64, 40, 33, 10], np.int32)
    if group_reduce == "mean":  # two KV heads; their query heads' mean
        qq = np.asarray(jthink.aggregate_queries_per_kv_head(jnp.asarray(q), 2))
        np.testing.assert_allclose(tthink.aggregate_queries_per_kv_head(t(q), 2).numpy(),
                                   qq, **TOL)
        k, lengths = k[:2], lengths[:2]
    else:
        qq = q
    packed = tbase.PackedKV(t(k[:, :64]), t(k[:, :64]), t(lengths))
    got = tthink.think_prune_channels(packed, t(qq), torch.tensor(90), 0.4, 32)
    want = jthink.think_prune_channels(
        jbase.PackedKV(jnp.asarray(k[:, :64]), jnp.asarray(k[:, :64]), jnp.asarray(lengths)),
        jnp.asarray(qq), jnp.int32(90), 0.4, 32)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    gk = got.k.numpy()
    for h, n in enumerate(lengths):
        pruned = (gk[h, :max(n - 32, 0)] == 0).all(axis=0).sum() if n > 32 else 0
        assert pruned == (51 if n > 32 else 0)
        assert (gk[h, max(n - 32, 0):n] != 0).all()  # the recent rows keep every channel


def test_headkv_capacities_from_a_file(tmp_path):
    """A head-score file written from a seeded rng (no download)."""
    rng = np.random.default_rng(16)
    L, H = 3, 4
    scores = {f"{li}-{h}": rng.random(5).tolist() for li in range(L) for h in range(H)}
    path = tmp_path / "heads.json"
    path.write_text(json.dumps(scores) + "\n")
    got = tlongbench.headkv_capacities(str(path), L, H, 64)
    want = jlongbench.headkv_capacities(str(path), L, H, 64)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (L, H) and got.dtype == np.int32


CAM_S, CAM_H = 300, 3


def _cam_inputs(seed, true_len):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((CAM_H, CAM_S, D)).astype(np.float32)
    col_mean = rng.random((CAM_H, CAM_S)).astype(np.float32)
    col_mean[:, true_len:] = 0.0  # padded columns get no attention
    uniforms = rng.random((CAM_S, CAM_H)).astype(np.float32)
    return v, col_mean, uniforms


@pytest.mark.parametrize("true_len,w,block", [(300, 8, 64), (251, 8, 8), (300, 5, 256),
                                              (120, 8, 32)])
def test_cam_merge_values_matches_jax(true_len, w, block):
    """The block solve (with ``block`` rows a step: one block, several, and
    blocks of exactly w rows), the sequential form and JAX's ``fori_loop``
    on the same uniforms, within 1e-5."""
    v, col_mean, uniforms = _cam_inputs(17, true_len)
    args = (torch.tensor(true_len), 0.1, w, t(uniforms))
    want = np.asarray(jcam.cam_merge_values(
        jnp.asarray(v), jnp.asarray(col_mean), jnp.int32(true_len), 0.1, w, None,
        uniforms=jnp.asarray(uniforms)))
    seq = tcam.cam_merge_values_sequential(t(v), t(col_mean), *args).numpy()
    got = tcam.cam_merge_values(t(v), t(col_mean), *args, block=block).numpy()
    np.testing.assert_allclose(seq, want, **TOL)
    np.testing.assert_allclose(got, seq, **TOL)
    assert not np.allclose(got, v)  # the merge moved values


def test_lookm_pivot_merge_matches_jax():
    H, S, C, true_len = 3, 120, 40, 110
    rng = np.random.default_rng(18)
    k_full, v_full = (rng.standard_normal((H, S, D)).astype(np.float32) for _ in range(2))
    gidx = np.stack([rng.permutation(true_len)[:C] for _ in range(H)]).astype(np.int32)
    lengths = np.array([40, 33, 20], np.int32)
    k_ret = np.take_along_axis(k_full, gidx[..., None].astype(np.int64), axis=1)
    v_ret = np.take_along_axis(v_full, gidx[..., None].astype(np.int64), axis=1)
    got = tlookm.lookm_pivot_merge(tbase.PackedKV(t(k_ret), t(v_ret), t(lengths)),
                                   t(gidx), t(k_full), t(v_full), torch.tensor(true_len))
    want = jlookm.lookm_pivot_merge(
        jbase.PackedKV(jnp.asarray(k_ret), jnp.asarray(v_ret), jnp.asarray(lengths)),
        jnp.asarray(gidx), jnp.asarray(k_full), jnp.asarray(v_full), jnp.int32(true_len))
    _assert_packed_equal(got, want, merged=True)
