"""The grouped quantized KV cache (``cache/quant_cache.py::QuantizedKVCache``)
and its decode path against the JAX package's, on the CPU in fp32.

Function level, the same numpy inputs through both: codes, packed bytes
(the port's unsigned bytes are JAX's plus 128), outlier indices and ring
rows bitwise; scales, zeros and dequantized values bitwise too (the same
IEEE operations), held at 1e-6 where the text says values.  Model level, a
2-layer fp32 model (hidden 64, head_dim 32, groups of 16) carried across
with ``params_from_jax``: ``decode_step`` over one JAX-built cache handed
to both (``grouped_cache_from_jax``), ``generate``, ``InferenceEngine`` and
chunked prefill against JAX's, logits within 1e-4 (fp32 summation order
over two layers), token streams equal.  JAX on the CPU takes its grouped
XLA path for every ``QuantConfig``.

A decode step appends the token its own forward computed: the two
packages' keys differ by fp32 rounding (about 1e-6), so an appended code
may land one step apart where the value sits on a rounding tie.  Appended
rows are held to one step where they differ, and at most one code in a
hundred may differ; every prefill row stays bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.cache import quant_cache as jq
from kvcache_factory_tpu.models import chunked_prefill as jchunked
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.runtime import engine as jengine
from kvcache_factory_tpu.runtime.generate import generate as jax_generate
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.cache import quant_cache as tq
from kvcache_factory_tpu_torch.models import chunked_prefill as tchunked
from kvcache_factory_tpu_torch.models import llama as tllama
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.runtime import engine as tengine
from kvcache_factory_tpu_torch.runtime import generate as tgenerate

NBITS = (1, 2, 3, 4, 8)
GS = 16
MODEL = dict(model_type="llama", vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=32,
             dtype="float32")
COMP = dict(method="snapkv", max_capacity_prompt=32, window_size=8, kernel_size=7,
            pooling="maxpool")
S = 64
CAP = 34  # request (a) fills it after two appends; later ones are dropped
RING = 24  # longer than request (b)'s 20 entries
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)


def qcfgs(nbits, outliers=True, ring=0):
    kw = dict(nbits=nbits, q_group_size=GS, outlier_extract=outliers, residual_length=ring)
    return jcfg.QuantConfig(**kw), tcfg.QuantConfig(**kw)


def unbiased(a):
    """JAX's stored int8 bytes as the port's unsigned ones."""
    return (np.asarray(a).astype(np.int16) + 128).astype(np.uint8)


def planted(seed, shape=(3, 5, 32)):
    """Normal values, 3 x N(0, 1), with ties of |x| planted in some groups:
    the first of equals must be the outlier, as ``jnp.argmax`` takes it."""
    x = (3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    x[0, 0, 3] = x[0, 0, 9] = 40.0        # two equal maxima
    x[0, 1, 18] = -50.0                   # |x| ties of opposite signs
    x[0, 1, 20] = 50.0
    x[1, 2, :GS] = 1.5                    # a constant group: scale 1e-8 / qmax
    x[2, 3, GS:] = 0.0                    # a zero group
    return x


def carry(jcache):
    return tq.grouped_cache_from_jax(*(None if a is None else np.asarray(a) for a in jcache))


# ---------------------------------------------------------------------------
# The cache's functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", NBITS)
def test_quantize_and_pack_match_jax(nbits):
    x = planted(nbits)
    c, s, z = tq.quantize_groups(torch.from_numpy(x), GS, nbits)
    jc, js, jz = jq.quantize_groups(jnp.asarray(x), GS, nbits)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    assert int(c.max()) <= 2 ** nbits - 1
    packed = tq.pack_codes(c, nbits)
    assert packed.dtype == torch.uint8
    assert packed.shape[-1] == 32 // tq.VALUES_PER_BYTE[nbits]
    np.testing.assert_array_equal(packed.numpy(), unbiased(jq.pack_codes(jc, nbits)))
    np.testing.assert_array_equal(tq.unpack_codes(packed, nbits).numpy(), c.numpy())
    np.testing.assert_array_equal(
        tq.unpack_codes(torch.from_numpy(unbiased(jq.pack_codes(jc, nbits))), nbits).numpy(),
        np.asarray(jq.unpack_codes(jq.pack_codes(jc, nbits), nbits)))
    deq = tq.dequantize_groups(c, s, z, GS, torch.float32)
    np.testing.assert_allclose(deq.numpy(), np.asarray(
        jq.dequantize_groups(jc, js, jz, GS, jnp.float32)), rtol=1e-6, atol=1e-6)


def test_outliers_match_jax_with_planted_ties():
    x = planted(0)
    stripped, oval, oidx = tq.extract_group_outliers(torch.from_numpy(x), GS)
    js, jo, ji = jq.extract_group_outliers(jnp.asarray(x), GS)
    np.testing.assert_array_equal(stripped.numpy(), np.asarray(js))
    np.testing.assert_array_equal(oval.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(oidx.numpy(), np.asarray(ji).astype(np.uint8))
    # the first of equals: 40.0 at 3 (not 9); |-50| at 18 (not 50 at 20)
    assert int(oidx[0, 0, 0]) == 3 and int(oidx[0, 1, 1]) == 2
    back = tq.scatter_group_outliers(stripped, oval, oidx, GS)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.scatter_group_outliers(js, jo, ji, GS)))


@pytest.mark.parametrize("nbits", NBITS)
@pytest.mark.parametrize("outliers", [True, False])
def test_encode_and_decode_values_match_jax(nbits, outliers):
    x = planted(10 + nbits)
    jcfg_, tcfg_ = qcfgs(nbits, outliers)
    got = tq.encode(torch.from_numpy(x), tcfg_)
    want = jq.encode(jnp.asarray(x), jcfg_)
    np.testing.assert_array_equal(got[0].numpy(), unbiased(want[0]))
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w).astype(np.float32))
    if outliers:
        np.testing.assert_array_equal(got[3].float().numpy(),
                                      np.asarray(want[3]).astype(np.float32))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]).astype(np.uint8))
    else:
        assert got[3] is None and got[4] is None and want[3] is None
    values = tq.decode_values(*got[:3], tcfg_, torch.float32, *got[3:])
    np.testing.assert_allclose(values.numpy(), np.asarray(
        jq.decode_values(*want[:3], jcfg_, jnp.float32, *want[3:])), rtol=1e-6, atol=1e-6)


def test_residual_ring_rows_match_jax():
    lengths = np.array([[0, 1, 7, 8], [9, 23, 24, 40]], np.int32)
    for R, C in ((8, 40), (24, 40), (50, 40)):
        np.testing.assert_array_equal(
            tq.residual_ring_rows(torch.from_numpy(lengths), R, C).numpy(),
            np.asarray(jq.residual_ring_rows(jnp.asarray(lengths), R, C)))


@pytest.mark.parametrize("outliers,ring", [(True, 0), (True, RING), (False, RING)])
def test_from_packed_prefill_and_carry_match_jax(outliers, ring):
    """The whole-stack constructor and a carried JAX cache hold the same bytes."""
    rng = np.random.default_rng(5)
    L, B, H, C, D = 2, 2, 3, 40, 32
    k = rng.standard_normal((L, B, H, C, D)).astype(np.float32)
    v = (3 * rng.standard_normal((L, B, H, C, D))).astype(np.float32)
    lens = rng.integers(0, C + 1, size=(L, B, H)).astype(np.int32)
    pos = np.array([70, 33], np.int32)
    jc_, tc_ = qcfgs(2, outliers, ring)
    want = jq.from_packed_prefill(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                                  jnp.asarray(pos), jc_, extra_capacity=3)
    got = tq.from_packed_prefill(torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(lens), torch.from_numpy(pos), tc_,
                                 extra_capacity=3)
    carried = carry(want)
    assert isinstance(got, tq.QuantizedKVCache) and got.capacity == C + 3
    assert got.residual_length == ring
    for name in got._fields:
        a, b = getattr(got, name), getattr(carried, name)
        assert (a is None) == (b is None), name
        if a is not None:
            rows = slice(None) if a.dim() < 4 or name in ("rk", "rv") else slice(0, C)
            assert torch.equal(a[..., rows, :] if a.dim() > 3 else a,
                               b[..., rows, :] if b.dim() > 3 else b), name


def test_reconstruction_within_noise_of_the_hqq_oracle():
    """As ``tests/test_quant_ab.py`` holds JAX's scheme: on heavy-tailed
    data the port's encode / decode tracks the reference's HQQ + outlier
    quantizer (within 1.3x relative MSE at 1-4 bits, 3x at 8) and the
    outlier slot never loses to the plain per-group range."""
    from tools.quant_accuracy_ab import GROUP, heavy_tailed, oracle_roundtrip

    x = heavy_tailed(np.random.default_rng(7), (64, 512))
    rel = lambda a: float(np.mean((a - x) ** 2) / np.mean(x * x))  # noqa: E731
    for nbits, factor in ((1, 1.3), (2, 1.3), (3, 1.3), (4, 1.3), (8, 3.0)):
        cfg = tcfg.QuantConfig(nbits=nbits, q_group_size=GROUP)
        ours = tq.decode_values(*tq.encode(torch.from_numpy(x), cfg)[:3], cfg, torch.float32,
                                *tq.encode(torch.from_numpy(x), cfg)[3:]).numpy()
        plain_cfg = tcfg.QuantConfig(nbits=nbits, q_group_size=GROUP, outlier_extract=False)
        plain = tq.decode_values(*tq.encode(torch.from_numpy(x), plain_cfg)[:3], plain_cfg,
                                 torch.float32).numpy()
        oracle = oracle_roundtrip(x, nbits, GROUP)
        assert rel(ours) <= rel(oracle) * factor, (nbits, rel(ours), rel(oracle))
        assert rel(ours) <= rel(plain) * 1.02, (nbits, rel(ours), rel(plain))


@pytest.mark.parametrize("head_dim,quant,want", [
    (128, dict(nbits=8), tq.Int8KVCache), (128, dict(nbits=4), tq.Int4KVCache),
    (128, dict(nbits=8, residual_length=16), tq.QuantizedKVCache),
    (128, dict(nbits=4, residual_length=16), tq.QuantizedKVCache),
    (128, dict(nbits=3), tq.QuantizedKVCache), (128, dict(nbits=1), tq.QuantizedKVCache),
    (64, dict(nbits=8), tq.QuantizedKVCache)])
def test_each_quant_config_builds_its_cache(head_dim, quant, want):
    """``QuantConfig.per_token`` picks the per-token cache (K3 / K4): nbits 8
    or 4, no ring, head_dim 128; everything else builds the grouped cache,
    nbits 8 with a ring included."""
    cfg = tcfg.ModelConfig(**dict(MODEL, head_dim=head_dim))
    cache = tllama.init_prefill_cache(cfg, tcfg.CompressionConfig(**COMP), tcfg.QuantConfig(
        **quant), 2, 40, 32, "cpu")
    assert type(cache) is want and cache.capacity == 40


# ---------------------------------------------------------------------------
# The decode path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"], size=n).tolist() for n in (60, 20)]
    toks = np.zeros((2, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    jcomp = jcfg.CompressionConfig(**COMP)
    dense = jllama.prefill(jp, jc, jcomp, jnp.asarray(toks), jnp.asarray(lens), CAP)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, prompts=prompts, toks=toks, lens=lens,
                jcomp=jcomp, tcomp=tcfg.CompressionConfig(**COMP), dense=dense)


def assert_codes_close(got, want, nbits, rows_from):
    """Packed bytes bitwise below each head's ``rows_from`` ``[L, B, H]``
    (its prefill rows); above it, codes at most one step apart and at
    most 1% of them apart (see the module docstring)."""
    old = torch.from_numpy(np.arange(got.shape[3]) < rows_from[..., None])
    assert torch.equal(got[old], want[old])
    g = tq.unpack_codes(got[~old], nbits).numpy().astype(np.int32)
    w = tq.unpack_codes(want[~old], nbits).numpy().astype(np.int32)
    assert np.abs(g - w).max(initial=0) <= 1 and (g != w).mean() <= 0.01


@pytest.mark.parametrize("nbits", NBITS)
@pytest.mark.parametrize("outliers", [True, False])
@pytest.mark.parametrize("ring", [0, RING])
def test_decode_step_over_a_jax_cache(model, nbits, outliers, ring):
    """Both decode steps over one JAX-built cache: request (a) reaches
    ``lengths == C`` after two appends and then drops its tokens (the ring's
    write too); request (b)'s 20 entries are fewer than the 24-slot ring."""
    m = model
    jc_, tc_ = qcfgs(nbits, outliers, ring)
    d = m["dense"].cache
    jcache = jq.from_packed_prefill(d.k, d.v, d.lengths, d.positions, jc_)
    tcache = carry(jcache)
    step = jax.jit(lambda t, c: jllama.decode_step(m["jp"], m["jc"], t, c, quant=jc_))
    cur = np.array(jnp.argmax(m["dense"].logits_last, -1))
    plen = np.asarray(d.lengths)
    for _ in range(4):
        jl, jcache = step(jnp.asarray(cur, jnp.int32), jcache)
        tl, tcache = tllama.decode_step(m["tp"], m["tc"], torch.from_numpy(cur), tcache,
                                        quant=tc_)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
        cur = np.array(jl).argmax(-1)
    want = carry(jcache)
    np.testing.assert_array_equal(tcache.lengths.numpy(), want.lengths.numpy())
    assert (tcache.lengths[:, 0] == CAP).all() and (tcache.lengths[:, 1] == 24).all()
    np.testing.assert_array_equal(tcache.positions.numpy(), want.positions.numpy())
    for codes in ("qk", "qv"):
        assert_codes_close(getattr(tcache, codes), getattr(want, codes), nbits, plen)
    values = [tq.decode_values(c.qk, c.k_scale, c.k_zero, tc_, torch.float32, c.k_oval, c.k_oidx)
              for c in (tcache, want)]
    old = torch.from_numpy(np.arange(CAP) < plen[..., None])
    np.testing.assert_allclose(values[0][old].numpy(), values[1][old].numpy(), rtol=1e-6,
                               atol=1e-6)
    if ring:
        # Ring slots of the prefill rows bitwise; the appended ones to fp32 rounding.
        np.testing.assert_allclose(tcache.rk.numpy(), want.rk.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tcache.rv.numpy(), want.rv.numpy(), rtol=1e-5, atol=1e-5)
    else:
        assert tcache.rk is None and want.rk is None


def test_decode_step_refuses_mismatched_configs(model):
    m = model
    d = m["dense"].cache
    _, tc_ = qcfgs(2)
    cache = tq.from_packed_prefill(*(torch.from_numpy(np.array(a)) for a in
                                     (d.k, d.v, d.lengths, d.positions)), tc_)
    tok = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="outlier"):
        tllama.decode_step(m["tp"], m["tc"], tok, cache, quant=qcfgs(2, outliers=False)[1])
    with pytest.raises(ValueError, match="quant config"):
        tllama.decode_step(m["tp"], m["tc"], tok, cache)


@pytest.mark.parametrize("nbits,outliers,ring", [(2, True, RING), (3, True, 0), (4, False, RING),
                                                 (8, True, RING), (1, False, 0)])
def test_prefill_and_generate_match_jax(model, nbits, outliers, ring):
    """One-shot prefill builds JAX's grouped cache (prefill rows of every
    plane and the ring within fp32 rounding); ``generate`` and
    ``InferenceEngine`` give JAX's streams."""
    m = model
    jc_, tc_ = qcfgs(nbits, outliers, ring)
    jres = jllama.prefill(m["jp"], m["jc"], m["jcomp"], jnp.asarray(m["toks"]),
                          jnp.asarray(m["lens"]), CAP, quant=jc_)
    tres = tllama.prefill(m["tp"], m["tc"], m["tcomp"], torch.from_numpy(m["toks"]),
                          torch.from_numpy(m["lens"]), CAP, quant=tc_)
    np.testing.assert_allclose(tres.logits_last.numpy(), np.asarray(jres.logits_last),
                               **LOGITS_TOL)
    want = carry(jres.cache)
    assert isinstance(tres.cache, tq.QuantizedKVCache)
    np.testing.assert_array_equal(tres.cache.lengths.numpy(), want.lengths.numpy())
    for codes in ("qk", "qv"):
        assert_codes_close(getattr(tres.cache, codes), getattr(want, codes), nbits,
                           np.zeros_like(want.lengths.numpy()))
    if ring:
        np.testing.assert_allclose(tres.cache.rk.numpy(), want.rk.numpy(), rtol=1e-5, atol=1e-5)

    gen = dict(max_new_tokens=8)
    jout = jax_generate(m["jp"], m["jc"], m["jcomp"], jcfg.GenerationConfig(**gen),
                        jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), 40, quant_cfg=jc_)
    tout = tgenerate.generate(m["tp"], m["tc"], m["tcomp"], tcfg.GenerationConfig(**gen),
                              m["toks"], m["lens"], 40, quant_cfg=tc_, device="cpu")
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.cache.lengths.numpy(), np.asarray(jout.cache.lengths))
    kw = dict(quant=jc_, prefill_buckets=(S,))
    jeng = jengine.InferenceEngine(m["jp"], jcfg.EngineConfig(model=m["jc"],
                                                              compression=m["jcomp"], **kw))
    teng = tengine.InferenceEngine(m["tp"], tcfg.EngineConfig(
        model=m["tc"], compression=m["tcomp"], quant=tc_, prefill_buckets=(S,)), device="cpu")
    ids, res = teng.generate_batch(m["prompts"], 6, return_result=True)
    assert ids == jeng.generate_batch(m["prompts"], 6)
    assert isinstance(res.cache, tq.QuantizedKVCache)
    # JAX's engine rounds the capacity for its TPU layouts; both build this one.
    assert res.cache.capacity == teng._cache_capacity(S, 6) == (256 if nbits == 4 else 128)


@pytest.mark.parametrize("method", ["snapkv", "fullkv"])
def test_chunked_prefill_builds_the_grouped_cache(model, method):
    m = model
    jc_, tc_ = qcfgs(2, True, RING)
    comp_kw = dict(COMP, method=method)
    cap = jcfg.CompressionConfig(**comp_kw).layer_capacity(2, S) + 4
    want = jchunked.prefill_chunked(m["jp"], m["jc"], jcfg.CompressionConfig(**comp_kw),
                                    jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), cap, 32,
                                    quant=jc_)
    got = tchunked.prefill_chunked(m["tp"], m["tc"], tcfg.CompressionConfig(**comp_kw),
                                   torch.from_numpy(m["toks"]), torch.from_numpy(m["lens"]),
                                   cap, 32, quant=tc_)
    np.testing.assert_allclose(got.logits_last.numpy(), np.asarray(want.logits_last),
                               **LOGITS_TOL)
    carried = carry(want.cache)
    assert isinstance(got.cache, tq.QuantizedKVCache)
    np.testing.assert_array_equal(got.cache.lengths.numpy(), carried.lengths.numpy())
    for codes in ("qk", "qv"):
        assert_codes_close(getattr(got.cache, codes), getattr(carried, codes), 2,
                           np.zeros_like(carried.lengths.numpy()))
    np.testing.assert_allclose(got.cache.rk.numpy(), carried.rk.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,quant", [
    ("nbits2_outliers_ring128", dict(nbits=2, q_group_size=64, outlier_extract=True,
                                     residual_length=128)),
    ("nbits4_ring128", dict(nbits=4, residual_length=128)),
    ("nbits3", dict(nbits=3))])
def test_grouped_decode_logits_near_fp32_reference(name, quant):
    """What grouped quantization alone does to the logits, which sets the
    limits ``chip_smoke.py`` phase 10a holds the card's grouped runs to:
    the port's fp32 plain path, with a Llama-3-shaped model cut to 2 layers
    and hidden 1024 (8 query heads, 2 KV heads, head_dim 128, rope_theta
    5e5), one 600-token prompt on the no-compress branch and 16 greedy
    steps, against the fp32 reference forward over the same tokens.  Each
    limit is at least 1.5 times the worst row seen here (printed with
    ``-s``)."""
    import chip_smoke
    from kvcache_factory_tpu_torch.models.reference import forward_logits
    from kvcache_factory_tpu_torch.models.weights import init_params

    cfg = tcfg.ModelConfig(model_type="llama", vocab_size=2048, hidden_size=1024,
                           intermediate_size=3584, num_hidden_layers=2, num_attention_heads=8,
                           num_key_value_heads=2, rope_theta=5e5, dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    eng = tengine.InferenceEngine(
        params, tcfg.EngineConfig(model=cfg, compression=tcfg.CompressionConfig(**{
            **COMP, "max_capacity_prompt": 2048}), quant=tcfg.QuantConfig(**quant),
            prefill_buckets=(1024,)), device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=600).tolist()
    steps = 16
    ids, res = eng.generate_batch([prompt], steps + 1, return_result=True)
    assert isinstance(res.cache, tq.QuantizedKVCache)
    ref = forward_logits(params, cfg, torch.tensor([prompt + ids[0][:steps]]))[0, len(prompt) - 1:]
    rel = (res.logits[0] - ref).norm(dim=-1) / ref.norm(dim=-1)
    print(f"{name}: prefill row rel L2 {rel[0].item():.3e}, decode worst "
          f"{rel[1:].max().item():.4f}, mean {rel[1:].mean().item():.4f}")
    assert rel[0] < 1e-5  # prefill is not quantized
    assert rel[1:].max() < chip_smoke.GROUPED_REL_L2_TOL[name] / 1.5
