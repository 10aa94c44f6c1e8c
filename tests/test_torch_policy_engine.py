"""Every compression method through the port's ``InferenceEngine`` against
the JAX package, end to end on the CPU.

``tests/test_torch_generate.py``'s model (2 layers, hidden 256, Hq 4, Hkv 2,
head_dim 128, vocab 512, fp32), two prompts (200 tokens, compressed to the
64-entry budget, and 40, below it) on a 256-token bucket, 8 new tokens.
Token streams must be identical, cache lengths equal, and first-token
logits within 1e-4 (fp32 summation-order error, as in
``tests/test_torch_generate.py``).  cam and random get JAX's own uniform
draws: ``policies.methods.uniform_draw`` is replaced by one that draws
what JAX's prefill draws for the same layer and example.  headkv reads
capacities from a head-score file written under ``tmp_path``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.evals.longbench import headkv_capacities as jax_headkv_capacities
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.runtime import engine as jengine
from kvcache_factory_tpu.runtime.generate import generate as jax_generate
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.evals.longbench import headkv_capacities
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.policies import methods as tmethods
from kvcache_factory_tpu_torch.runtime import batching as tbatching
from kvcache_factory_tpu_torch.runtime import engine as tengine

MODEL = dict(model_type="llama", vocab_size=512, hidden_size=256,
             intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=128, rope_theta=10000.0, dtype="float32")
L, HQ = MODEL["num_hidden_layers"], MODEL["num_attention_heads"]
COMP = dict(max_capacity_prompt=64, window_size=8, kernel_size=7, pooling="maxpool",
            group_reduce="none")
BUCKET = 256
MAX_NEW = 8
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
# Per method: the CompressionConfig fields beside COMP.  l2norm skips layer
# 0 only, so that layer 1 of the 2-layer model compresses.
CASES = {
    "pyramidkv": dict(method="pyramidkv"),
    "h2o": dict(method="h2o"),
    "streamingllm": dict(method="streamingllm"),
    "l2norm": dict(method="l2norm", skip_layers=(0,)),
    "random": dict(method="random"),
    "adakv": dict(method="adakv"),
    "headkv": dict(method="headkv"),
    "cam": dict(method="cam"),
    "think": dict(method="think"),
    "pivot": dict(method="snapkv", merge="pivot"),
    "adakv_mean": dict(method="adakv", group_reduce="mean"),
    "cam_mean": dict(method="cam", group_reduce="mean"),
}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    jc, tc = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"], size=n).tolist() for n in (200, 40)]
    toks = np.zeros((len(prompts), BUCKET), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    # A head-score file (one JSON line of per-head score lists, layer-major).
    path = tmp_path_factory.mktemp("headkv") / "heads.json"
    scores = {f"{li}-{h}": rng.random(4).tolist() for li in range(L) for h in range(HQ)}
    path.write_text(json.dumps(scores) + "\n")
    hc = headkv_capacities(str(path), L, HQ, COMP["max_capacity_prompt"])
    np.testing.assert_array_equal(hc, jax_headkv_capacities(str(path), L, HQ,
                                                            COMP["max_capacity_prompt"]))
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, prompts=prompts, toks=toks, lens=lens, hc=hc)


def jax_draws(batch):
    """``uniform_draw`` with JAX's draws: the prefill splits ``PRNGKey(0)``
    over the layers, each layer's key over the batch, and draws
    ``uniform(key, shape)`` per example."""
    layer_keys = jax.random.split(jax.random.PRNGKey(0), L)

    def draw(rng, layer_idx, example, shape):
        key = jax.random.split(layer_keys[layer_idx], batch)[example]
        return torch.from_numpy(np.array(jax.random.uniform(key, shape))).to(rng.device)
    return draw


def _port_engine(m, comp_kw, **kw):
    cfg = tcfg.EngineConfig(model=m["tc"], compression=tcfg.CompressionConfig(**comp_kw),
                            prefill_buckets=(BUCKET,), **kw)
    return tengine.InferenceEngine(m["tp"], cfg, device="cpu",
                                   head_capacity=m["hc"] if comp_kw["method"] == "headkv"
                                   else None)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax(model, case, monkeypatch):
    m = model
    comp_kw = dict(COMP, **CASES[case])
    monkeypatch.setattr(tmethods, "uniform_draw", jax_draws(len(m["prompts"])))
    eng = _port_engine(m, comp_kw)
    ids, res = eng.generate_batch(m["prompts"], MAX_NEW, return_result=True)

    jcomp = jcfg.CompressionConfig(**comp_kw)
    cap = eng._cache_capacity(BUCKET, MAX_NEW)
    kw = dict(rng=jax.random.PRNGKey(0),
              head_capacity=jnp.asarray(m["hc"]) if comp_kw["method"] == "headkv" else None)
    jres = jax_generate(m["jp"], m["jc"], jcomp, jcfg.GenerationConfig(max_new_tokens=MAX_NEW),
                        jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), cap, **kw)
    nums, toks = np.asarray(jres.num_tokens), np.asarray(jres.tokens)
    assert ids == [toks[i, :nums[i]].tolist() for i in range(len(ids))]
    np.testing.assert_array_equal(res.cache.lengths.numpy(), np.asarray(jres.cache.lengths))
    jpre = jllama.prefill(m["jp"], m["jc"], jcomp, jnp.asarray(m["toks"]),
                          jnp.asarray(m["lens"]), cap, **kw)
    np.testing.assert_allclose(res.logits[:, 0].numpy(), np.asarray(jpre.logits_last),
                               **LOGITS_TOL)
    # The short prompt takes the no-compress branch on every method.
    assert (res.cache.lengths[:, 1].numpy() == 40 + MAX_NEW - 1).all()


@pytest.mark.parametrize("method", tmethods.SCORES_REUSABLE)
def test_score_reusing_methods_take_the_emitted_scores(model, method, monkeypatch):
    """With ``window_attention_scores`` made to raise, the five methods
    whose scores K1 emits still run: their scores come from K1's plain
    version, here on the CPU as on the card from the kernel."""
    def must_not_run(*args, **kwargs):
        raise AssertionError("the policy recomputed the window scores")
    monkeypatch.setattr(tmethods, "window_attention_scores", must_not_run)
    ids = _port_engine(model, dict(COMP, method=method)).generate_batch(model["prompts"],
                                                                        MAX_NEW)
    assert [len(x) for x in ids] == [MAX_NEW, MAX_NEW]


def test_engine_draws_repeat_from_the_generators_state(model):
    """Each call starts from the generator's state at construction, as the
    JAX engine hands one key to every call; another seed draws otherwise."""
    m = model
    comp_kw = dict(COMP, method="random")
    eng = _port_engine(m, comp_kw)
    first = eng.generate_batch(m["prompts"], 2, return_result=True)[1].cache
    again = eng.generate_batch(m["prompts"], 2, return_result=True)[1].cache
    assert torch.equal(first.k, again.k)
    other = tengine.InferenceEngine(
        m["tp"], tcfg.EngineConfig(model=m["tc"], compression=tcfg.CompressionConfig(**comp_kw),
                                   prefill_buckets=(BUCKET,)),
        device="cpu", rng=torch.Generator().manual_seed(1))
    assert not torch.equal(other.generate_batch(m["prompts"], 2, return_result=True)[1].cache.k,
                           first.k)


@pytest.mark.parametrize("what", ["sp", "headkv_without_capacities",
                                  "batching_headkv", "batching_cam", "batching_random"])
def test_refusals_name_their_roadmap_item(model, what):
    """What this slice leaves unported raises, naming its ROADMAP.md item.
    headkv without capacities is no longer refused: as JAX's
    ``InferenceEngine`` does, prefill feeds zero capacities and every head
    keeps only its window; that case holds the port's engine to JAX's
    (streams, lengths, first-token logits).  ThinK's packed cache is
    ported: ``tests/test_torch_caches.py``."""
    m = model
    cfg = lambda **kw: tcfg.EngineConfig(  # noqa: E731
        model=m["tc"], compression=tcfg.CompressionConfig(**dict(COMP, **kw)),
        prefill_buckets=(BUCKET,))
    if what == "sp":
        c = tcfg.EngineConfig(model=m["tc"], compression=tcfg.CompressionConfig(
            **dict(COMP, method="pyramidkv")), sharding=tcfg.ShardingConfig(sp=2),
            prefill_buckets=(BUCKET,))
        with pytest.raises(NotImplementedError, match="item 1.11"):
            tengine.InferenceEngine(m["tp"], c, device="cpu")
    elif what == "headkv_without_capacities":
        comp_kw = dict(COMP, method="headkv")
        eng = tengine.InferenceEngine(m["tp"], cfg(method="headkv"), device="cpu")
        ids, res = eng.generate_batch(m["prompts"], MAX_NEW, return_result=True)
        cap = eng._cache_capacity(BUCKET, MAX_NEW)
        jcomp = jcfg.CompressionConfig(**comp_kw)
        jeng = jengine.InferenceEngine(m["jp"], jcfg.EngineConfig(
            model=m["jc"], compression=jcomp, prefill_buckets=(BUCKET,)))
        assert ids == jeng.generate_batch(m["prompts"], MAX_NEW)
        jres = jax_generate(m["jp"], m["jc"], jcomp, jcfg.GenerationConfig(
            max_new_tokens=MAX_NEW), jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), cap)
        np.testing.assert_array_equal(res.cache.lengths.numpy(),
                                      np.asarray(jres.cache.lengths))
        # Request (a) keeps its window alone in every head.
        assert (res.cache.lengths[:, 0].numpy() == COMP["window_size"] + MAX_NEW - 1).all()
        jpre = jllama.prefill(m["jp"], m["jc"], jcomp, jnp.asarray(m["toks"]),
                              jnp.asarray(m["lens"]), cap)
        np.testing.assert_allclose(res.logits[:, 0].numpy(), np.asarray(jpre.logits_last),
                                   **LOGITS_TOL)
    else:
        method = what.split("_")[1]
        with pytest.raises(NotImplementedError, match="item 1.10"):
            tbatching.ContinuousBatchingEngine(m["tp"], cfg(method=method), device="cpu")


@pytest.mark.parametrize("method", ["pyramidkv", "h2o", "l2norm", "adakv", "think"])
def test_batching_engine_serves_the_deterministic_methods(model, method):
    """One-shot admission takes the deterministic methods: the streams equal
    the single-request engine's."""
    m = model
    comp_kw = dict(COMP, method=method)
    cfg = tcfg.EngineConfig(model=m["tc"], compression=tcfg.CompressionConfig(**comp_kw),
                            prefill_buckets=(BUCKET,))
    eng = tbatching.ContinuousBatchingEngine(m["tp"], cfg, n_slots=2, max_new_cap=MAX_NEW,
                                             device="cpu")
    rids = [eng.submit(p, MAX_NEW) for p in m["prompts"]]
    out = eng.run()
    single = _port_engine(m, comp_kw)
    assert [out[r] for r in rids] == [single.generate_ids(p, MAX_NEW) for p in m["prompts"]]
