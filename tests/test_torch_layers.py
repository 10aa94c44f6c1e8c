"""Parity of the PyTorch port's layer building blocks with the JAX package.

Both sides get the same numpy inputs (``np.random.default_rng``) and run in
fp32 on the CPU.  Tolerances: fp32 against fp32 with a different summation
order agrees to ~1e-6 relative on these O(1) values; 1e-5 leaves room for
the reductions over 128-512 terms.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.cache import kv_cache as jcache
from kvcache_factory_tpu.models import llama as jl
from kvcache_factory_tpu.ops import attention as jattn
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.cache import kv_cache as tcache
from kvcache_factory_tpu_torch.models import llama as tl
from kvcache_factory_tpu_torch.ops import attention as tattn

TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(x)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    w = rng.standard_normal(256).astype(np.float32)
    np.testing.assert_allclose(tl.rms_norm(t(x), t(w), 1e-5).numpy(),
                               np.asarray(jl.rms_norm(j(x), j(w), 1e-5)), **TOL)


@pytest.mark.parametrize("scaling", [None, ("linear", 4.0, 0.0, 0.0, 0),
                                     ("llama3", 8.0, 1.0, 4.0, 8192)])
def test_rope_inv_freq(scaling):
    kw = dict(head_dim=128, rope_theta=500000.0, rope_scaling=scaling)
    got = tl.rope_inv_freq(tcfg.ModelConfig(**kw)).numpy()
    want = np.asarray(jl.rope_inv_freq(jcfg.ModelConfig(**kw)))
    # pow/exp of fp32 in two libraries: a few ulps apart
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


@pytest.mark.parametrize("per_example", [False, True])
def test_apply_rope(per_example):
    rng = np.random.default_rng(1)
    B, H, T, D = 2, 4, 7, 128
    x = rng.standard_normal((B, H, T, D)).astype(np.float32)
    kw = dict(head_dim=D, rope_theta=1e6)
    cos, sin = (np.asarray(a) for a in jl.rope_tables(jcfg.ModelConfig(**kw), T))
    tcos, tsin = tl.rope_tables(tcfg.ModelConfig(**kw), T)
    np.testing.assert_allclose(tcos.numpy(), cos, rtol=0, atol=2e-6)
    np.testing.assert_allclose(tsin.numpy(), sin, rtol=0, atol=2e-6)
    if per_example:  # [B, T, D] tables, as decode builds them
        cos, sin = np.stack([cos] * B), np.stack([sin] * B)
    got = tl.apply_rope(t(x), t(cos), t(sin)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.apply_rope(j(x), j(cos), j(sin))), **TOL)


def test_split_merge_heads_roundtrip():
    x = torch.arange(2 * 3 * 4 * 128, dtype=torch.float32).reshape(2, 3, 4 * 128)
    heads = tl._split_heads(x, 4, 128)
    np.testing.assert_array_equal(
        heads.numpy(), np.asarray(jl._split_heads(j(x.numpy()), 4, 128)))
    np.testing.assert_array_equal(tl._merge_heads(heads).numpy(), x.numpy())


def test_swiglu_fused():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    gu = (rng.standard_normal((256, 1024)) / 16).astype(np.float32)
    dn = (rng.standard_normal((512, 256)) / 22).astype(np.float32)
    np.testing.assert_allclose(tl.swiglu_fused(t(x), t(gu), t(dn)).numpy(),
                               np.asarray(jl.swiglu_fused(j(x), j(gu), j(dn))), **TOL)


@pytest.mark.parametrize("G,per_head_mask", [(1, False), (2, True), (4, False)])
def test_grouped_attention(G, per_head_mask):
    rng = np.random.default_rng(3)
    B, Hk, Tq, Tk, D = 2, 2, 3, 40, 128
    Hq = Hk * G
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hk, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hk, Tk, D)).astype(np.float32)
    mh = Hq if per_head_mask else Hk
    mask = rng.random((B, mh, Tq, Tk)) < 0.7
    mask[..., 0] = True
    got, gp = tl.grouped_attention(t(q), t(k), t(v), t(mask), return_probs=True)
    want, wp = jl.grouped_attention(j(q), j(k), j(v), j(mask), return_probs=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), **TOL)


@pytest.mark.parametrize("q_block,lengths", [(32, [96, 70]),   # blocks divide S
                                             (40, [1, 96]),    # a ragged last block
                                             (128, [50, 9])])  # one block
def test_blocked_causal_attention(q_block, lengths):
    rng = np.random.default_rng(4)
    B, Hq, Hk, S, D = 2, 4, 2, 96, 128
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hk, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hk, S, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    got = tattn.blocked_causal_attention(t(q), t(k), t(v), t(lens), q_block=q_block)
    want = jattn.blocked_causal_attention(j(q), j(k), j(v), j(lens), q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tattn.NEG_INF == jattn.NEG_INF


def test_cache_append_layer_and_valid_mask():
    """One-hot append at ragged lengths, a full head dropping its token,
    and the validity mask, bit for bit."""
    rng = np.random.default_rng(5)
    B, H, C, D = 2, 3, 8, 128
    kc, vc = (rng.standard_normal((B, H, C, D)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((B, H, 1, D)).astype(np.float32) for _ in range(2))
    lens = np.asarray([[0, 5, 8], [7, 1, 3]], np.int32)  # 8 == C: full
    got = tcache.append_layer(t(kc), t(vc), t(lens), t(kn), t(vn))
    want = jcache.append_layer(j(kc), j(vc), j(lens), j(kn), j(vn))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tcache.valid_mask(t(lens), C).numpy(),
                                  np.asarray(jcache.valid_mask(j(lens), C)))
    c = tcache.init_cache(2, B, H, C, D, torch.float32, "cpu")
    assert c.capacity == C and c.num_layers == 2 and c.lengths.dtype == torch.int32


def test_configs_match_jax():
    """``from_hf_config`` on the Mistral-7B config the card runs, and the
    compression budget arithmetic, field for field."""
    import chip_smoke
    hf = chip_smoke.MISTRAL_7B_HF_CONFIG
    got = dataclasses.asdict(tcfg.ModelConfig.from_hf_config(hf))
    assert got == dataclasses.asdict(jcfg.ModelConfig.from_hf_config(hf))
    assert got["head_dim"] == 128 and got["sliding_window"] is None
    assert tcfg.dtype_of(chip_smoke.MISTRAL_7B) == torch.bfloat16
    for method in ("snapkv", "fullkv"):
        for group_reduce in ("none", "mean"):
            kw = dict(method=method, max_capacity_prompt=2048, window_size=8,
                      group_reduce=group_reduce)
            tc, jc = tcfg.CompressionConfig(**kw), jcfg.CompressionConfig(**kw)
            assert tc.base_capacity == jc.base_capacity
            assert tc.cache_heads(32, 8) == jc.cache_heads(32, 8)
            for S in (1500, 2048, 4096):
                assert tc.layer_capacity(32, S) == jc.layer_capacity(32, S)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcfg.ShardingConfig(tp=2)


def test_port_rejects_weight_quantization():
    """W8A16 is ported: ``wdot`` on a ``{"q", "s"}`` leaf is ``(x @ q) * s``
    (parity with JAX in ``tests/test_torch_weights.py``).  What the port
    still rejects, as the JAX package does, is int4 weights and quantizing
    twice."""
    from kvcache_factory_tpu_torch.models.weights import quantize_weights
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, generator=g)
    q = torch.randint(-127, 128, (4, 3), generator=g, dtype=torch.int8)
    s = torch.rand(1, 3, generator=g)
    torch.testing.assert_close(tl.wdot(x, {"q": q, "s": s}), x @ (q.float() * s),
                               rtol=1e-6, atol=1e-6)
    params = {"lm_head": torch.randn(4, 3, generator=g), "layers": {}}
    with pytest.raises(NotImplementedError, match="nbits=8"):
        quantize_weights(params, nbits=4)
    with pytest.raises(ValueError, match="already weight-quantized"):
        quantize_weights(quantize_weights(params))
