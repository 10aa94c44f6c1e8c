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
