"""The evicting, ThinK-packed, host-offloaded, SSM and encoder-decoder caches,
and generation-state checkpoints of every cache kind, against the JAX
package on the CPU in fp32.

A 2-layer model (hidden 64, 4 query and 2 KV heads of 16) carried across
with ``params_from_jax``; prompts of 60 and 20 tokens in a 64-token bucket,
SnapKV 32 / window 8.  ``decode_step`` runs over one JAX-built cache handed
to both packages (``*_cache_from_jax``); ``generate``, ``InferenceEngine``,
chunked prefill and ``ContinuousBatchingEngine`` are held to JAX's.
Tolerances: logits 1e-4 (fp32 summation order over two layers), K/V and
scores 1e-5, stamps, lengths, channels and token streams exact.  A resumed
decode must equal an uninterrupted one bit for bit (the same code on the
same inputs).
"""

import torch_threads  # noqa: F401  (torch's thread share, first)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.cache import encdec_cache as jencdec
from kvcache_factory_tpu.cache import kv_cache as jkv
from kvcache_factory_tpu.cache import ssm_cache as jssm
from kvcache_factory_tpu.cache.offload_cache import offload_kv_cache as joffload
from kvcache_factory_tpu.models import chunked_prefill as jchunked
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.policies import think as jthink
from kvcache_factory_tpu.runtime import batching as jbatching
from kvcache_factory_tpu.runtime import engine as jengine
from kvcache_factory_tpu.runtime.generate import generate as jax_generate
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.cache import encdec_cache as tencdec
from kvcache_factory_tpu_torch.cache import kv_cache as tkv
from kvcache_factory_tpu_torch.cache import offload_cache as toff
from kvcache_factory_tpu_torch.cache import quant_cache as tq
from kvcache_factory_tpu_torch.cache import ssm_cache as tssm
from kvcache_factory_tpu_torch.cache import think_cache as tthinkc
from kvcache_factory_tpu_torch.models import chunked_prefill as tchunked
from kvcache_factory_tpu_torch.models import llama as tllama
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.policies import think as tthink
from kvcache_factory_tpu_torch.runtime import batching as tbatching
from kvcache_factory_tpu_torch.runtime import checkpoint as tckpt
from kvcache_factory_tpu_torch.runtime import engine as tengine
from kvcache_factory_tpu_torch.runtime import generate as tgenerate

MODEL = dict(model_type="llama", vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             dtype="float32")
COMP = dict(method="snapkv", max_capacity_prompt=32, window_size=8, kernel_size=7,
            pooling="maxpool")
THINK = dict(COMP, method="think", pruning_ratio=0.4, recent_size=8, think_packed=True)
EVICT = dict(COMP, decode_evict=True, eviction_recent=4)
S = 64
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
VALUES_TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(cache):
    return [None if a is None else np.asarray(a) for a in cache]


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, MODEL["vocab_size"], size=n).tolist() for n in (60, 20)]
    toks = np.zeros((2, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, prompts=prompts, toks=toks, lens=lens)


def both_prefills(m, comp_kw, cap, quant_kw=None):
    jq_ = None if quant_kw is None else jcfg.QuantConfig(**quant_kw)
    tq_ = None if quant_kw is None else tcfg.QuantConfig(**quant_kw)
    jres = jllama.prefill(m["jp"], m["jc"], jcfg.CompressionConfig(**comp_kw),
                          jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), cap, quant=jq_)
    tres = tllama.prefill(m["tp"], m["tc"], tcfg.CompressionConfig(**comp_kw),
                          torch.from_numpy(m["toks"]), torch.from_numpy(m["lens"]), cap,
                          quant=tq_)
    np.testing.assert_allclose(tres.logits_last.numpy(), np.asarray(jres.logits_last),
                               **LOGITS_TOL)
    return jres, tres


def step_both(m, jcache, tcache, first, steps, **kw):
    """``steps`` decode steps of both packages from the same tokens (JAX's
    greedy choice fed to both); returns the two caches and the next token."""
    step = jax.jit(lambda t, c: jllama.decode_step(m["jp"], m["jc"], t, c, **kw))
    cur = np.array(first)
    for _ in range(steps):
        jl, jcache = step(jnp.asarray(cur, jnp.int32), jcache)
        tl, tcache = tllama.decode_step(m["tp"], m["tc"], torch.from_numpy(cur), tcache, **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
        cur = np.array(jl).argmax(-1)
    return jcache, tcache, cur


# ---------------------------------------------------------------------------
# ThinK's kept channels
# ---------------------------------------------------------------------------


def test_think_channel_keep_idx_with_planted_ties():
    """Channels with equal saliency (copies of one column in k and q) are
    kept in ``lax.top_k``'s order; the result is ascending."""
    rng = np.random.default_rng(4)
    H, C, S_, D = 3, 24, 40, 16
    k = rng.standard_normal((H, C, D)).astype(np.float32)
    q = rng.standard_normal((H, S_, D)).astype(np.float32)
    for a, b in ((2, 9), (2, 13), (5, 6), (0, 15)):
        k[..., b], q[..., b] = k[..., a], q[..., a]
    lengths = np.array([24, 10, 1], np.int32)
    for true_len, ratio in ((40, 0.4), (33, 0.5), (7, 0.25)):
        got = tthink.think_channel_keep_idx(torch.from_numpy(k), torch.from_numpy(lengths),
                                            torch.from_numpy(q), torch.tensor(true_len), ratio)
        want = jthink.think_channel_keep_idx(jnp.asarray(k), jnp.asarray(lengths),
                                             jnp.asarray(q), jnp.asarray(true_len), ratio)
        assert got.dtype == torch.int32 and got.shape == (H, D - int(D * ratio))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.diff(dim=-1) > 0).all()


# ---------------------------------------------------------------------------
# decode_step over one JAX-built cache of each kind
# ---------------------------------------------------------------------------


def test_evicting_decode_over_a_jax_cache(model):
    """Request (a) fills its 34 slots after two appends, then evicts: the
    victim slots (read from the stamps), stamps, scores and K/V follow JAX
    step by step; request (b) never fills."""
    m = model
    jres, tres = both_prefills(m, EVICT, 34)
    want0 = tkv.evicting_cache_from_jax(*np_tree(jres.cache))
    assert isinstance(tres.cache, tkv.EvictingKVCache)
    for name in ("stamps", "lengths", "positions", "scores"):
        assert torch.equal(getattr(tres.cache, name), getattr(want0, name)), name
    np.testing.assert_array_equal(
        tres.cache.stamps.numpy(),
        tkv.init_eviction_stamps(tres.cache.lengths, tres.cache.positions, 34).numpy())
    jcache, tcache = jres.cache, want0
    cur = np.array(jnp.argmax(jres.logits_last, -1))
    for steps in (2, 6):  # to the fill, then six evicting steps
        jcache, tcache, cur = step_both(m, jcache, tcache, cur, steps, eviction_recent=4)
        want = tkv.evicting_cache_from_jax(*np_tree(jcache))
        for name in ("stamps", "lengths", "positions"):
            assert torch.equal(getattr(tcache, name), getattr(want, name)), name
        for name in ("k", "v", "scores"):
            np.testing.assert_allclose(getattr(tcache, name).numpy(),
                                       getattr(want, name).numpy(), **VALUES_TOL)
    assert (tcache.lengths[:, 0] == 34).all() and (tcache.lengths[:, 1] == 28).all()
    assert int(tcache.stamps[:, 0].max()) == 60 + 7  # the last step's token is in
    assert (tcache.scores >= 0).all() and tcache.positions.tolist() == [68, 28]


@pytest.mark.parametrize("group_reduce", ["none", "mean"])
def test_think_packed_decode_over_a_jax_cache(model, group_reduce):
    """JAX's packed cache carried across: kept channels, boundary and dense
    rows equal the port's own prefill; decode past the dense buffer (Cr =
    recent 8 + 2) drops its appends as JAX does."""
    m = model
    kw = dict(THINK, group_reduce=group_reduce)
    jres, tres = both_prefills(m, kw, 34)
    want = tthinkc.think_cache_from_jax(*np_tree(jres.cache))
    got = tres.cache
    assert isinstance(got, tthinkc.ThinKCache)
    assert got.kept_dim == 16 - int(16 * 0.4) and got.dense_capacity == 8 + 2
    for name in ("channels", "boundary", "lengths", "positions"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("kp", "kd", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                   **VALUES_TOL)
    jcache, tcache, _ = step_both(m, jres.cache, want,
                                  np.asarray(jnp.argmax(jres.logits_last, -1)), 4)
    back = tthinkc.think_cache_from_jax(*np_tree(jcache))
    assert torch.equal(tcache.lengths, back.lengths)
    # (a): boundary 24 + Cr 10 = 34 = C after two appends; (b): 12 + 10.
    assert tcache.lengths[:, 0].unique().tolist() == [34]
    assert tcache.lengths[:, 1].unique().tolist() == [22]
    for name in ("kd", "v"):
        np.testing.assert_allclose(getattr(tcache, name).numpy(), getattr(back, name).numpy(),
                                   **VALUES_TOL)


def test_offloaded_decode_over_a_jax_cache(model):
    """JAX's offloaded cache carried across, and the port's own offload of
    its prefill cache: host K/V never written, appends in the 2-slot ring,
    lengths capped at prefill + 2, logits equal to the device-resident
    decode's until the ring fills."""
    m = model
    jres, tres = both_prefills(m, COMP, 32)
    joff = joffload(jres.cache, decode_headroom=2)
    carried = toff.offloaded_cache_from_jax(*np_tree(joff))
    own = toff.offload_kv_cache(tres.cache, 2)
    assert own.hk.device.type == "cpu" and own.device_capacity == 2
    assert own.capacity == carried.capacity == 34
    np.testing.assert_allclose(own.hk.numpy(), carried.hk.numpy(), **VALUES_TOL)
    assert torch.equal(own.prefill_len, carried.prefill_len)
    host_before = carried.hk.clone()
    first = np.array(jnp.argmax(jres.logits_last, -1))
    jcache, tcache, _ = step_both(m, joff, carried, first, 4)
    back = toff.offloaded_cache_from_jax(*np_tree(jcache))
    assert torch.equal(tcache.lengths, back.lengths)
    assert ((tcache.lengths - tcache.prefill_len) == 2).all()
    assert torch.equal(tcache.hk, host_before)
    np.testing.assert_allclose(tcache.dk.numpy(), back.dk.numpy(), **VALUES_TOL)
    # The same two steps on the device-resident cache (capacity 34): equal logits.
    dense = tkv.KVCache(*(torch.cat([t, torch.zeros_like(t[:, :, :, :2])], dim=3)
                          for t in (tres.cache.k, tres.cache.v)),
                        tres.cache.lengths.clone(), tres.cache.positions.clone())
    off2 = toff.offload_kv_cache(tres.cache, 2)
    cur = torch.from_numpy(first)
    for _ in range(2):
        ld, dense = tllama.decode_step(m["tp"], m["tc"], cur, dense)
        lo, off2 = tllama.decode_step(m["tp"], m["tc"], cur, off2)
        np.testing.assert_allclose(lo.numpy(), ld.numpy(), **LOGITS_TOL)
        cur = ld.argmax(-1)


def test_offload_on_a_cpu_cache_copies_to_plain_host_tensors(model):
    """On a CPU cache the host tensors are plain CPU copies (the device is
    the CPU); the pinned path needs a card and is ``chip_smoke.py``'s."""
    m = model
    _, tres = both_prefills(m, COMP, 32)
    off = toff.offload_kv_cache(tres.cache, 3)
    assert not off.hk.is_pinned() and off.hk.data_ptr() != tres.cache.k.data_ptr()
    assert torch.equal(off.hk, tres.cache.k) and off.dk.shape[3] == 3
    pf = toff.LayerPrefetch(off, torch.device("cpu"))
    assert pf.layer(1)[0] is not None and torch.equal(pf.layer(1)[0], off.hk[1])


# ---------------------------------------------------------------------------
# Generation, chunked prefill and serving with each cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comp_kw", [EVICT, THINK], ids=["evicting", "think_packed"])
def test_generate_and_engine_match_jax(model, comp_kw):
    m = model
    gen = dict(max_new_tokens=10)
    jcomp, tcomp = jcfg.CompressionConfig(**comp_kw), tcfg.CompressionConfig(**comp_kw)
    jout = jax_generate(m["jp"], m["jc"], jcomp, jcfg.GenerationConfig(**gen),
                        jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), 36)
    tout = tgenerate.generate(m["tp"], m["tc"], tcomp, tcfg.GenerationConfig(**gen),
                              m["toks"], m["lens"], 36, device="cpu")
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.cache.lengths.numpy(), np.asarray(jout.cache.lengths))
    if comp_kw is EVICT:
        np.testing.assert_array_equal(tout.cache.stamps.numpy(), np.asarray(jout.cache.stamps))
    jeng = jengine.InferenceEngine(m["jp"], jcfg.EngineConfig(model=m["jc"], compression=jcomp,
                                                              prefill_buckets=(S,)))
    teng = tengine.InferenceEngine(m["tp"], tcfg.EngineConfig(model=m["tc"], compression=tcomp,
                                                              prefill_buckets=(S,)), device="cpu")
    assert teng.generate_batch(m["prompts"], 8) == jeng.generate_batch(m["prompts"], 8)


@pytest.mark.parametrize("method", ["snapkv", "fullkv"])
def test_chunked_prefill_builds_the_evicting_cache(model, method):
    m = model
    kw = dict(EVICT, method=method)
    cap = jcfg.CompressionConfig(**kw).layer_capacity(2, S) + 2
    want = jchunked.prefill_chunked(m["jp"], m["jc"], jcfg.CompressionConfig(**kw),
                                    jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), cap, 32)
    got = tchunked.prefill_chunked(m["tp"], m["tc"], tcfg.CompressionConfig(**kw),
                                   torch.from_numpy(m["toks"]), torch.from_numpy(m["lens"]),
                                   cap, 32)
    np.testing.assert_allclose(got.logits_last.numpy(), np.asarray(want.logits_last),
                               **LOGITS_TOL)
    carried = tkv.evicting_cache_from_jax(*np_tree(want.cache))
    assert isinstance(got.cache, tkv.EvictingKVCache)
    for name in ("stamps", "lengths", "positions", "scores"):
        assert torch.equal(getattr(got.cache, name), getattr(carried, name)), name
    np.testing.assert_allclose(got.cache.k.numpy(), carried.k.numpy(), **VALUES_TOL)


@pytest.mark.parametrize("what", ["grouped", "evicting", "think_packed"])
def test_batching_engine_serves_each_cache_as_jax(model, what):
    """Two slots, three requests (the third admitted when a slot frees):
    streams equal to JAX's engine; the pool is the configured cache type,
    ``None`` planes included."""
    m = model
    comp_kw, quant_kw = {"grouped": (COMP, dict(nbits=2, q_group_size=8, residual_length=4)),
                         "evicting": (EVICT, None), "think_packed": (THINK, None)}[what]
    kw = dict(prefill_buckets=(S,))
    jeng = jbatching.ContinuousBatchingEngine(m["jp"], jcfg.EngineConfig(
        model=m["jc"], compression=jcfg.CompressionConfig(**comp_kw),
        quant=None if quant_kw is None else jcfg.QuantConfig(**quant_kw), **kw),
        n_slots=2, max_new_cap=6)
    teng = tbatching.ContinuousBatchingEngine(m["tp"], tcfg.EngineConfig(
        model=m["tc"], compression=tcfg.CompressionConfig(**comp_kw),
        quant=None if quant_kw is None else tcfg.QuantConfig(**quant_kw), **kw),
        n_slots=2, max_new_cap=6, device="cpu")
    prompts = m["prompts"] + [m["prompts"][0][:45]]
    jr = [jeng.submit(p, n) for p, n in zip(prompts, (6, 3, 5))]
    tr = [teng.submit(p, n) for p, n in zip(prompts, (6, 3, 5))]
    jout, tout = jeng.run(), teng.run()
    assert [tout[r] for r in tr] == [jout[r] for r in jr]
    want = {"grouped": tq.QuantizedKVCache, "evicting": tkv.EvictingKVCache,
            "think_packed": tthinkc.ThinKCache}[what]
    assert isinstance(teng.cache, want) and teng.cache.lengths.shape[1] == 2
    if what == "grouped":
        assert teng.cache.k_oval is not None and teng.cache.rk.shape[3] == 4


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

MODEL128 = dict(MODEL, hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
                head_dim=128)
CKPT_KINDS = {
    "dense": (COMP, None, tkv.KVCache),
    "int8": (COMP, dict(nbits=8), tq.Int8KVCache),
    "int4": (COMP, dict(nbits=4), tq.Int4KVCache),
    "grouped": (COMP, dict(nbits=2, residual_length=16), tq.QuantizedKVCache),
    "evicting": (EVICT, None, tkv.EvictingKVCache),
    "think_packed": (THINK, None, tthinkc.ThinKCache),
    "offloaded": (COMP, None, toff.OffloadedKVCache),
}


def clone(cache):
    return type(cache)(*(None if t is None else t.clone() for t in cache))


@pytest.fixture(scope="module")
def model128():
    cfg = tcfg.ModelConfig(**MODEL128)
    from kvcache_factory_tpu_torch.models.weights import init_params
    return cfg, init_params(cfg, seed=7, device="cpu")


@pytest.mark.parametrize("kind", list(CKPT_KINDS))
def test_checkpoint_round_trip_continues_bit_for_bit(model, model128, kind, tmp_path):
    """8 steps without a stop against 3 steps, save, load, 5 more: tokens
    and every step's logits bitwise equal (head_dim 128, so nbits 8 and 4
    take the per-token caches)."""
    cfg, params = model128
    m = model
    comp_kw, quant_kw, cls = CKPT_KINDS[kind]
    quant = None if quant_kw is None else tcfg.QuantConfig(**quant_kw)
    pre = tllama.prefill(params, cfg, tcfg.CompressionConfig(**comp_kw),
                         torch.from_numpy(m["toks"]), torch.from_numpy(m["lens"]), 36,
                         quant=quant)
    cache = pre.cache if kind != "offloaded" else toff.offload_kv_cache(pre.cache, 4)
    assert isinstance(cache, cls)
    evr = comp_kw.get("eviction_recent", 32)
    first = pre.logits_last.argmax(-1)

    def run(c, cur, n):
        toks, logits = [], []
        for _ in range(n):
            lg, c = tllama.decode_step(params, cfg, cur, c, quant=quant, eviction_recent=evr)
            cur = lg.argmax(-1)
            toks.append(cur)
            logits.append(lg)
        return c, cur, toks, logits

    _, _, ref_toks, ref_logits = run(clone(cache), first, 8)
    c, cur, toks, logits = run(clone(cache), first, 3)
    path = tckpt.save_generation_state(str(tmp_path / kind), c, cur,
                                       torch.stack(toks, 1).numpy(), {"kind": kind})
    c2, cur2, gen2, meta = tckpt.load_generation_state(path, device="cpu")
    assert meta == {"kind": kind} and type(c2) is cls
    np.testing.assert_array_equal(gen2, torch.stack(toks, 1).numpy())
    for a, b in zip(c, c2):
        assert (a is None and b is None) or torch.equal(a, b)
    _, _, more_toks, more_logits = run(c2, cur2, 5)
    assert torch.equal(torch.stack(toks + more_toks), torch.stack(ref_toks))
    assert torch.equal(torch.stack(logits + more_logits), torch.stack(ref_logits))


# ---------------------------------------------------------------------------
# SSM and encoder-decoder caches (mirroring tests/test_aux_caches.py)
# ---------------------------------------------------------------------------


def test_ssm_cache_matches_jax():
    L, B, I, K, St = 3, 2, 8, 4, 6
    jc = jssm.init_ssm_cache(L, B, I, K, St, dtype=jnp.float32)
    tc = tssm.init_ssm_cache(L, B, I, K, St, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    for t in range(7):  # past the t >= K regime
        for li in range(L):
            x = rng.standard_normal((B, I)).astype(np.float32)
            jc = jssm.update_conv(jc, li, jnp.asarray(x))
            tc = tssm.update_conv(tc, li, torch.from_numpy(x))
            if t == 2:
                st = rng.standard_normal((B, I, St)).astype(np.float32)
                jc = jssm.update_ssm(jc, li, jnp.asarray(st))
                tc = tssm.update_ssm(tc, li, torch.from_numpy(st))
        jc, tc = jssm.advance(jc), tssm.advance(tc)
        np.testing.assert_array_equal(tc.conv_states.numpy(), np.asarray(jc.conv_states))
    np.testing.assert_array_equal(tc.ssm_states.numpy(), np.asarray(jc.ssm_states))
    np.testing.assert_array_equal(tc.positions.numpy(), np.asarray(jc.positions))
    np.testing.assert_array_equal(tssm.conv_window(tc, 1).numpy(),
                                  np.asarray(jssm.conv_window(jc, 1)))
    # The layout rule: the batching engine's slot copies serve it.
    pool = tbatching._alloc_pool(tc, 4)
    row = tssm.SSMCache(tc.conv_states[:, 1:], tc.ssm_states[:, 1:], tc.positions[1:] + 3)
    tbatching._insert_row(pool, row, 2)
    assert torch.equal(pool.conv_states[:, 2], tc.conv_states[:, 1])
    assert int(pool.positions[2]) == int(tc.positions[1]) + 3 and pool.positions[0] == 0


def test_encdec_cache_matches_jax():
    L, B, H, C, D = 2, 3, 2, 8, 4
    rng = np.random.default_rng(3)
    arrays = [(rng.standard_normal((L, B, H, C, D)).astype(np.float32),
               rng.standard_normal((L, B, H, C, D)).astype(np.float32),
               np.array(l, np.int32), rng.integers(0, 9, B).astype(np.int32))
              for l in (rng.integers(0, C, (L, B, H)), np.zeros((L, B, H)))]
    jcache = jencdec.build_encoder_decoder_cache(*(jkv.KVCache(*map(jnp.asarray, a))
                                                   for a in arrays))
    tcache = tencdec.build_encoder_decoder_cache(*(tkv.KVCache(*map(torch.from_numpy, a))
                                                   for a in arrays))
    np.testing.assert_array_equal(tcache.cross_written.numpy(), np.asarray(jcache.cross_written))
    fresh = rng.standard_normal((B, H, 5, D)).astype(np.float32)
    for li in (0, 1):
        for got, want in zip(tencdec.select_cross(tcache, li, torch.from_numpy(fresh),
                                                  torch.from_numpy(fresh)),
                             jencdec.select_cross(jcache, li, jnp.asarray(fresh),
                                                  jnp.asarray(fresh))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jcache = jencdec.mark_cross_written(jcache, 1)
    tcache = tencdec.mark_cross_written(tcache, 1)
    np.testing.assert_array_equal(tcache.cross_written.numpy(), np.asarray(jcache.cross_written))
    idx = np.array([2, 2, 0], np.int32)
    got = tencdec.batch_select(tcache, torch.from_numpy(idx))
    want = jencdec.batch_select(jcache, jnp.asarray(idx))
    for side in ("self_cache", "cross_cache"):
        for a, b in zip(getattr(got, side), getattr(want, side)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cache_combinations_jax_refuses_still_raise(model):
    """JAX asserts; the port raises ``ValueError`` before any work."""
    m = model
    for comp_kw, quant in ((dict(THINK), tcfg.QuantConfig(nbits=2, q_group_size=8)),
                           (dict(THINK, decode_evict=True), None),
                           (EVICT, tcfg.QuantConfig(nbits=2, q_group_size=8))):
        with pytest.raises(ValueError, match="compose"):
            tengine.InferenceEngine(m["tp"], tcfg.EngineConfig(
                model=m["tc"], compression=tcfg.CompressionConfig(**comp_kw), quant=quant,
                prefill_buckets=(S,)), device="cpu")
        with pytest.raises(AssertionError):
            jllama.prefill(m["jp"], m["jc"], jcfg.CompressionConfig(**comp_kw),
                           jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), 40,
                           quant=None if quant is None else jcfg.QuantConfig(
                               **dataclasses.asdict(quant)))
