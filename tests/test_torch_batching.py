"""The port's continuous-batching engine and schedulers against the JAX
package's.

A Mistral-shaped model (2 layers, hidden 256, 4 query heads, 2 KV heads,
head_dim 128, vocab 256, sliding window 24) in fp32 on the CPU; the JAX
weights are carried across with ``params_from_jax`` and the prompts come
from ``np.random.default_rng``.  Greedy decoding is deterministic per row,
so token streams must be identical: between the two engines, between
one-shot and chunked admission, and through pool growth and shrink.  The
drain's counters (row-chunks, dispatches, decode steps) are exact.
"""

import torch_threads  # noqa: F401  (torch's thread share, first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.runtime import batching as jbatching
from kvcache_factory_tpu.runtime import native as jnative
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.cache import quant_cache as tq
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.runtime import batching as tbatching
from kvcache_factory_tpu_torch.runtime import native as tnative

MODEL = dict(model_type="mistral", vocab_size=256, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=128,
             max_position_embeddings=512, dtype="float32", sliding_window=24)
COMP = dict(method="snapkv", max_capacity_prompt=32, window_size=8, kernel_size=7,
            pooling="maxpool")
BUCKETS = (64, 128)


# --- the schedulers ----------------------------------------------------------

def _lifecycle(s):
    """The JAX package's scheduler lifecycle (``tests/test_batching.py``):
    every call's result, in order."""
    out = [s.submit(200, 4)]  # past the largest bucket: -1
    out += [s.submit(50, 2), s.submit(100, 3), s.submit(10, 1)]
    out += [s.admit(), s.admit(), s.admit(), s.stats()]
    slot1, slot2 = out[4][0], out[5][0]
    out += [s.step(slot1, False), s.step(slot1, False), s.stats()]
    out.append(s.admit())     # the third request takes the freed slot
    out += [s.step(out[-1][0], True), s.step(slot2, True), s.stats()]
    out += [s.step(-1, False), s.step(7, False)]  # out-of-range slots are refused
    return out


@pytest.mark.parametrize("which", ["PyScheduler", "NativeScheduler"])
def test_scheduler_lifecycle_matches_jax(which):
    got = _lifecycle(getattr(tnative, which)(2, [64, 128]))
    assert got == _lifecycle(jnative.PyScheduler(2, [64, 128]))
    r1 = got[1]
    assert got[0] == -1 and got[1:4] == [r1, r1 + 1, r1 + 2]
    assert got[4][1:] == (r1, 64, 2) and got[5][1:3] == (r1 + 1, 128) and got[6] is None
    assert got[7] == {"queued": 1, "active": 2, "free": 0, "completed": 0}
    assert got[8:10] == [False, True] and got[11][:2] == (got[4][0], r1 + 2)
    assert got[-3] == {"queued": 0, "active": 0, "free": 2, "completed": 3}


def test_native_scheduler_builds_into_build_dir_never_csrc():
    s = tnative.make_scheduler(2, [64])
    assert isinstance(s, tnative.NativeScheduler)
    lib = tnative._lib_path()
    assert lib.exists() and lib.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "native")
    assert not (tnative.SCHED_SOURCE.parent / lib.name).exists()


# --- the engine -------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(7), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return dict(jc=jc, tc=tc, jp=jp, tp=tp)


def _ecfg(m, buckets=BUCKETS, quant=None):
    return tcfg.EngineConfig(model=m["tc"], compression=tcfg.CompressionConfig(**COMP),
                             prefill_buckets=buckets, quant=quant)


def _drain(m, prompts, max_new, buckets=BUCKETS, quant=None, **kw):
    """A port drain on the CPU: (engine, token streams in submission order)."""
    eng = tbatching.ContinuousBatchingEngine(m["tp"], _ecfg(m, buckets, quant), device="cpu",
                                             **kw)
    rids = [eng.submit(p, n) for p, n in zip(prompts, max_new)]
    out = eng.run()
    return eng, [out[r] for r in rids]


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL["vocab_size"], size=n).tolist() for n in lengths]


@pytest.mark.parametrize("chunk_tokens", [0, 32], ids=["one_shot", "chunked"])
def test_engine_matches_jax_with_eos(model, chunk_tokens):
    """Five requests through two slots (slots refill mid-drain), with
    budgets of their own and an EOS that one stream emits mid-chunk: the
    port's streams equal the JAX engine's, one-shot and chunked."""
    m = model
    prompts = _prompts(0, (40, 90, 25, 60, 120))
    max_new = [6, 3, 6, 4, 5]
    kw = dict(n_slots=2, max_new_cap=6, chunk_size=4, prefill_chunk_tokens=chunk_tokens)
    _, free = _drain(m, prompts, max_new, **kw)
    stream = free[0]
    stop = next(i for i in range(2, len(stream)) if stream[i] not in stream[:i])
    eos = (stream[stop],)
    eng, got = _drain(m, prompts, max_new, eos_token_ids=eos, **kw)
    assert got[0] == stream[:stop + 1]

    jeng = jbatching.ContinuousBatchingEngine(
        m["jp"], jcfg.EngineConfig(model=m["jc"], compression=jcfg.CompressionConfig(**COMP),
                                   prefill_buckets=BUCKETS), eos_token_ids=eos, **kw)
    jrids = [jeng.submit(p, n) for p, n in zip(prompts, max_new)]
    jout = jeng.run()
    assert got == [jout[r] for r in jrids]
    assert eng.scheduler.stats() == {"queued": 0, "active": 0, "free": 2, "completed": 5}
    assert eng.cache_capacity == jeng.cache_capacity
    if chunk_tokens:
        assert eng.prefill_chunks_executed == jeng.prefill_chunks_executed
        assert eng.prefill_chunk_dispatches == jeng.prefill_chunk_dispatches


def test_concurrent_admissions_share_one_dispatch(model):
    """Four prompts of one bucket admitted together advance in one
    ``chunk_step`` per loop iteration (per-row offsets): dispatches are
    about the longest prompt's chunk count (4), not the sum of every
    prompt's (15), and the streams equal the one-shot drain's."""
    m = model
    prompts = _prompts(23, (120, 100, 110, 90))
    kw = dict(buckets=(128,), n_slots=4, max_new_cap=5)
    _, want = _drain(m, prompts, [5] * 4, **kw)
    eng, got = _drain(m, prompts, [5] * 4, prefill_chunk_tokens=32, **kw)
    assert got == want
    assert eng.prefill_chunks_executed == sum(-(-len(p) // 32) for p in prompts) == 15
    assert eng.prefill_chunk_dispatches <= 5, eng.prefill_chunk_dispatches


@pytest.mark.parametrize("lengths,final_pool", [
    ((120, 110, 100, 90, 40), 1),  # a burst grows the pool to 4; the straggler admits alone
    ((128, 120, 33, 34), 2),       # the short rows finish first: halved with rows in flight
], ids=["after_burst", "mid_flight"])
def test_chunk_pool_shrinks_and_streams_stay_exact(model, lengths, final_pool):
    """Pools double for a burst and halve once their live rows fit in half,
    compacting rows still mid-prefill into fresh tensors; the streams equal
    the one-shot drain's."""
    m = model
    prompts = _prompts(31, lengths)
    kw = dict(buckets=(128,), n_slots=4, max_new_cap=5)
    _, want = _drain(m, prompts, [5] * len(prompts), **kw)
    eng, got = _drain(m, prompts, [5] * len(prompts), prefill_chunk_tokens=32, **kw)
    assert got == want
    assert eng._chunk_groups[128]["P"] == final_pool


def test_eos_early_exit_step_count(model):
    """A chunk whose rows all hit EOS stops there: the first token comes
    from prefill, and the chunk runs exactly the ``stop`` steps after it."""
    m = model
    prompts = _prompts(29, (30,))
    _, free = _drain(m, prompts, [16], n_slots=2, max_new_cap=16, chunk_size=16)
    stream = free[0]
    stop = next(i for i in range(2, len(stream)) if stream[i] not in stream[:i])
    eng, got = _drain(m, prompts, [16], n_slots=2, max_new_cap=16, chunk_size=16,
                      eos_token_ids=(stream[stop],))
    assert got[0] == stream[:stop + 1]
    assert eng.steps_executed == stop


def test_frozen_rows_keep_their_cache_lengths(model):
    """Rows frozen at EOS or at their budget get ``lengths`` and
    ``positions`` restored after every step: a finished slot's cache ends
    at its prompt's entries plus the tokens it fed back."""
    m = model
    prompts = _prompts(41, (40, 50))
    eng, got = _drain(m, prompts, [2, 7], n_slots=2, max_new_cap=8, chunk_size=8)
    assert [len(s) for s in got] == [2, 7]
    lens = eng.cache.lengths
    # Row 0 fed back one token, row 1 six; snapkv keeps 32 of each prompt.
    assert set(lens[:, 0].flatten().tolist()) == {32 + 1}
    assert set(lens[:, 1].flatten().tolist()) == {32 + 6}
    assert eng.cache.positions.tolist() == [40 + 1, 50 + 6]


def test_instrument_records_logits_and_stalls(model):
    """``instrument`` keeps each request's fp32 logits for every token it
    emitted (entry 0 from its prefill) and one admission stall per loop
    iteration that did prefill work; the streams are the uninstrumented
    ones."""
    m = model
    prompts = _prompts(43, (40, 90, 60))
    kw = dict(n_slots=2, max_new_cap=4, prefill_chunk_tokens=32)
    _, want = _drain(m, prompts, [4] * 3, **kw)
    eng, got = _drain(m, prompts, [4] * 3, instrument=True, **kw)
    assert got == want
    for rid, stream in zip(sorted(eng.logits), got):
        logits = eng.logits[rid]
        assert len(logits) == len(stream)
        assert [int(lg.argmax()) for lg in logits] == stream
        assert all(lg.dtype == torch.float32 and lg.shape == (MODEL["vocab_size"],)
                   for lg in logits)
    # Chunks of 32: the 90-token prompt takes three loop iterations.
    assert len(eng.admission_stalls_s) >= 3 and min(eng.admission_stalls_s) > 0


@pytest.mark.parametrize("nbits", [8, 4])
def test_quantized_engine_chunked_matches_one_shot(model, nbits):
    """With ``QuantConfig(nbits)`` the batched cache is the per-token cache
    of the JAX engine's capacity (rounded up to 128 / 256 slots), and
    chunked admission gives the one-shot streams."""
    m = model
    prompts = _prompts(5, (40, 90, 120))
    q = tcfg.QuantConfig(nbits=nbits)
    kw = dict(quant=q, n_slots=2, max_new_cap=5)
    one, want = _drain(m, prompts, [5] * 3, **kw)
    eng, got = _drain(m, prompts, [5] * 3, prefill_chunk_tokens=32, **kw)
    assert got == want
    assert isinstance(eng.cache, tq.Int8KVCache if nbits == 8 else tq.Int4KVCache)
    jeng = jbatching.ContinuousBatchingEngine(
        m["jp"], jcfg.EngineConfig(model=m["jc"], compression=jcfg.CompressionConfig(**COMP),
                                   prefill_buckets=BUCKETS, quant=jcfg.QuantConfig(nbits=nbits)),
        n_slots=2, max_new_cap=5)
    assert eng.cache_capacity == one.cache_capacity == jeng.cache_capacity \
        == eng.cache.capacity == (128 if nbits == 8 else 256)


def test_engine_runs_on_cuda_unless_asked(model):
    """The default device is the card: CPU weights without ``device="cpu"``
    are refused rather than run where the caller did not ask."""
    with pytest.raises(ValueError, match="cuda"):
        tbatching.ContinuousBatchingEngine(model["tp"], _ecfg(model))
    assert tbatching.ContinuousBatchingEngine(model["tp"], _ecfg(model),
                                              device="cpu").device.type == "cpu"


def test_engine_refuses_what_it_cannot_serve(model):
    m = model
    with pytest.raises(ValueError, match="not divisible"):
        tbatching.ContinuousBatchingEngine(m["tp"], _ecfg(m), prefill_chunk_tokens=48,
                                           device="cpu")
    eng = tbatching.ContinuousBatchingEngine(m["tp"], _ecfg(m), device="cpu")
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        eng.submit([1] * 129, 4)


# --- headkv, cam and random through admission ---------------------------------

def jax_draws(layers=MODEL["num_hidden_layers"]):
    """``uniform_draw`` with JAX's draws for a one-row admission: JAX's
    engine hands ``PRNGKey(0)`` to every prefill and finalize, which split
    it over the layers, then each layer's key over the one row."""
    layer_keys = jax.random.split(jax.random.PRNGKey(0), layers)

    def draw(rng, layer_idx, example, shape):
        key = jax.random.split(layer_keys[layer_idx], 1)[example]
        return torch.from_numpy(np.array(jax.random.uniform(key, shape))).to(rng.device)
    return draw


@pytest.mark.parametrize("method", ["headkv", "cam", "random"])
def test_chunked_admission_of_drawing_and_capacity_methods_matches_jax(model, method,
                                                                       monkeypatch):
    """headkv (capacities from one seeded array), cam and random (JAX's
    draws, the generator restored for every admission) through chunked
    admission: the port's streams equal the JAX engine's, and each
    admission drew the same uniforms (two prompts of one length give one
    cache)."""
    from kvcache_factory_tpu_torch.policies import methods as tmethods
    m = model
    monkeypatch.setattr(tmethods, "uniform_draw", jax_draws())
    comp = dict(COMP, method=method)
    H = tcfg.CompressionConfig(**comp).cache_heads(MODEL["num_attention_heads"],
                                                    MODEL["num_key_value_heads"])
    hc = np.random.default_rng(3).integers(4, 30, size=(MODEL["num_hidden_layers"], H))
    hc = hc.astype(np.int32) if method == "headkv" else None
    prompts = _prompts(61, (120, 90, 100))
    kw = dict(n_slots=2, max_new_cap=5, chunk_size=4, prefill_chunk_tokens=32,
              head_capacity=hc)
    eng = tbatching.ContinuousBatchingEngine(
        m["tp"], tcfg.EngineConfig(model=m["tc"], compression=tcfg.CompressionConfig(**comp),
                                   prefill_buckets=BUCKETS), device="cpu", **kw)
    rids = [eng.submit(p, 5) for p in prompts]
    out = eng.run()
    jeng = jbatching.ContinuousBatchingEngine(
        m["jp"], jcfg.EngineConfig(model=m["jc"], compression=jcfg.CompressionConfig(**comp),
                                   prefill_buckets=BUCKETS), **kw)
    jrids = [jeng.submit(p, 5) for p in prompts]
    jout = jeng.run()
    assert [out[r] for r in rids] == [jout[r] for r in jrids]
    assert eng.prefill_chunks_executed == jeng.prefill_chunks_executed


def test_headkv_without_capacities_is_refused_as_in_jax(model):
    cfg = tcfg.EngineConfig(model=model["tc"], compression=tcfg.CompressionConfig(
        **dict(COMP, method="headkv")), prefill_buckets=BUCKETS)
    with pytest.raises(ValueError, match="head_capacity"):
        tbatching.ContinuousBatchingEngine(model["tp"], cfg, device="cpu")


# --- prefix caching -----------------------------------------------------------
# The JAX package's prefix-cache tests (tests/test_chunked_prefill.py) on
# their own model: Llama, vocab 128, hidden 128, 8 / 4 heads, head_dim 16.

PREFIX_MODEL = dict(model_type="llama", vocab_size=128, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
                    head_dim=16, max_position_embeddings=512, dtype="float32")


@pytest.fixture(scope="module")
def prefix_model():
    jc, tc = jcfg.ModelConfig(**PREFIX_MODEL), tcfg.ModelConfig(**PREFIX_MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(7), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return dict(jc=jc, tc=tc, jp=jp, tp=tp)


def _prefix_engines(m, buckets, **kw):
    """(port engine, JAX engine) over the prefix model with JAX's test
    compression (snapkv, capacity 32, window 8)."""
    comp = dict(method="snapkv", max_capacity_prompt=32, window_size=8, kernel_size=7,
                pooling="maxpool")
    teng = tbatching.ContinuousBatchingEngine(
        m["tp"], tcfg.EngineConfig(model=m["tc"], compression=tcfg.CompressionConfig(**comp),
                                   prefill_buckets=buckets), device="cpu", **kw)
    jeng = jbatching.ContinuousBatchingEngine(
        m["jp"], jcfg.EngineConfig(model=m["jc"], compression=jcfg.CompressionConfig(**comp),
                                   prefill_buckets=buckets), **kw)
    return teng, jeng


def test_prefix_cache_resume_matches_and_skips_chunks(prefix_model):
    """Registered shared prefixes snapshot their chunk state once and later
    admissions resume from it: the streams equal a drain without the
    prefix and the JAX engine's, and the 2-chunk prefix is skipped for the
    2nd and 3rd prompts (JAX's counts)."""
    rng = np.random.default_rng(13)
    system = rng.integers(0, 128, size=70).tolist()
    prompts = [system + rng.integers(0, 128, size=n).tolist() for n in (40, 50, 45)]

    def drain(eng, register):
        if register:
            eng.cache_prefix(system)
        rids = [eng.submit(p, 5) for p in prompts]
        out = eng.run()
        return [out[r] for r in rids], eng.prefill_chunks_executed

    kw = dict(n_slots=1, max_new_cap=5, prefill_chunk_tokens=32)
    plain, n_plain = drain(_prefix_engines(prefix_model, (128,), **kw)[0], False)
    teng, jeng = _prefix_engines(prefix_model, (128,), **kw)
    cached, n_cached = drain(teng, True)
    jcached, jn_cached = drain(jeng, True)
    assert cached == plain == jcached
    assert n_cached == jn_cached <= n_plain - 4, (n_cached, jn_cached, n_plain)
    assert list(teng._prefix_states) == list(jeng._prefix_states)


def test_prefix_cache_double_resume_leaves_the_snapshot_untouched(prefix_model):
    """The port's ``chunk_step`` writes its pool in place, so a resumed row
    must copy the snapshot, never alias it: two resumes from one snapshot
    (in turn, then side by side in one pool) give the cold streams, and the
    snapshot stays bitwise what it was when taken."""
    rng = np.random.default_rng(19)
    system = rng.integers(0, 128, size=70).tolist()
    first = system + rng.integers(0, 128, size=40).tolist()
    tails = [system + rng.integers(0, 128, size=n).tolist() for n in (50, 45)]
    kw = dict(max_new_cap=5, prefill_chunk_tokens=32)
    cold, _ = _prefix_engines(prefix_model, (128,), n_slots=2, **kw)
    rids = [cold.submit(p, 5) for p in tails]
    want = cold.run()
    want = [want[r] for r in rids]

    eng, _ = _prefix_engines(prefix_model, (128,), n_slots=2, **kw)
    eng.cache_prefix(system)
    eng.submit(first, 5)
    eng.run()
    ((key, snap),) = eng._prefix_states.items()
    taken = [t.clone() for t in snap]
    for _ in range(2):  # one resume after the other, each alone in the pool
        before = eng.prefill_chunks_executed
        rid = eng.submit(tails[0], 5)
        assert eng.run()[rid] == want[0]
        assert eng.prefill_chunks_executed - before == 2  # the chunks past 64
    rids = [eng.submit(p, 5) for p in tails]  # two resumes in one dispatch
    out = eng.run()
    assert [out[r] for r in rids] == want
    assert all(torch.equal(a, b) for a, b in zip(eng._prefix_states[key], taken))


def test_prefix_cache_byte_budget_evicts_oldest(prefix_model):
    """The snapshot LRU is bounded in bytes: a larger-bucket snapshot
    evicts the smaller one, and an evicted prefix's chunks run again with
    the one-shot stream (JAX's test, the JAX engine beside)."""
    rng = np.random.default_rng(17)
    pref_small = rng.integers(0, 128, size=33).tolist()
    pref_large = rng.integers(0, 128, size=70).tolist()

    def snap_bytes(bucket):
        # kbuf + vbuf ([L, 1, Hkv, S, D] fp32 each) + qwin + x_last
        return 2 * 2 * 1 * 4 * bucket * 16 * 4 + 2 * 1 * 8 * 32 * 16 * 4 + 128 * 4

    kw = dict(n_slots=1, max_new_cap=4, prefill_chunk_tokens=32,
              prefix_cache_bytes=snap_bytes(128) + snap_bytes(64) // 2)
    engines = _prefix_engines(prefix_model, (64, 128), **kw)
    tails = [rng.integers(0, 128, size=n).tolist() for n in (31, 20, 31)]
    outs = []
    for eng in engines:
        eng.cache_prefix(pref_small)
        eng.cache_prefix(pref_large)
        eng.submit(pref_small + tails[0], 4)
        eng.run()
        assert len(eng._prefix_states) == 1
        eng.submit(pref_large + tails[1], 4)
        eng.run()
        ((bucket, _),) = eng._prefix_states.keys()
        assert bucket == 128 and eng._prefix_state_bytes() <= eng._prefix_cache_bytes
        before = eng.prefill_chunks_executed
        rid = eng.submit(pref_small + tails[2], 4)
        outs.append(eng.run()[rid])
        assert eng.prefill_chunks_executed - before == 2  # both chunks ran again
    # The re-run took the small snapshot again, which evicted the large one.
    assert [list(e._prefix_states) for e in engines] == [[(64, tuple(pref_small[:32]))]] * 2
    assert engines[0]._prefix_state_bytes() == engines[1]._prefix_state_bytes() \
        == snap_bytes(64)
    plain, _ = _prefix_engines(prefix_model, (64, 128), n_slots=1, max_new_cap=4)
    rid = plain.submit(pref_small + tails[2], 4)
    assert outs[0] == outs[1] == plain.run()[rid]


def test_prefix_cache_requires_chunked_admission(prefix_model):
    eng, _ = _prefix_engines(prefix_model, (128,))
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        eng.cache_prefix([1, 2, 3])
