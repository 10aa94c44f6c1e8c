"""The port's parallel layouts (``ShardingConfig`` dp, tp, ep, sp, pp and
dcn_dp through ``InferenceEngine``, ``(dp, tp)`` and ``(dp, ep)`` through
``ContinuousBatchingEngine``, ``pipeline_forward``) on spawned gloo ranks,
against the JAX package's engines under the same ``ShardingConfig`` on the
8-device CPU mesh and the port's single-device engine.

Models, fp32, 2 layers: JAX's sharding tests' (hidden 128, Hq 8, Hkv 4,
head_dim 16, vocab 256; ``tests/test_sharding.py:22-32``), the same with
Hkv 2 (tp 4 > Hkv) and with 4 layers (pp over 4 stages), one with head_dim
128 for the per-token int8 / int4 caches (hidden 256, Hq 4, Hkv 2), one
with q/k/v, o, gate/up and down biases, its W8A16 tree (JAX's
``quantize_weights``) and a 4-expert Mixtral with its W8A16 tree.  Weights
are JAX's ``init_params``; each rank takes its tp / ep shard through
``shard_params_from_jax`` or its pipeline stage through
``stage_params_from_jax`` (one case hands the engine the whole tree to
cut).  Prompts come from ``np.random.default_rng``: 100, 60, 90 and 30
tokens on a 128-row bucket, 6 new tokens.  cam and random run on JAX's
draws, handed to the ranks as numpy arrays.  One case samples through
``InferenceEngine`` at ``(dp, tp) = (2, 2)`` (``generate_batch``'s
``generation``): each rank draws the whole batch's Gumbel noise from one
seed and keeps its rows.  The ``ContinuousBatchingEngine`` drains run
one-shot and chunked admission (32-token chunks), each against JAX's
engine with the same ``prefill_chunk_tokens``; under ep one-shot only.
Under sp every compressing method runs; under pp the GPipe engine at M = P
and M = 2P, and ``pipeline_forward`` against JAX's on its pp mesh.

One module-scoped spawn per world size (2 and 4 ranks) runs every case of
that size (``tests/torch_sp_worker.py::_sharded``); rank 0 then runs each
case on the single-device engine.  Every rank is held to: JAX's engine's
ids under the same layout and first-token logits within 1e-5 relative L2
of JAX's prefill there (under pp, of JAX's single-device prefill; the
per-token int8 / int4 caches excepted: JAX's engine on the CPU takes its
grouped cache, so those are held to the port's single-device engine,
which ``tests/test_torch_quant_decode.py`` holds to JAX, as is the sampled
case, since JAX's engine is greedy only); the single-device engine's ids
and logits within the same tolerance; every other rank's ids and logits
bitwise; and its cache shard (its rows and heads, its stage's layers)
against the single-device cache over each head's valid prefix.
"""

import torch_threads  # noqa: F401  (torch's thread share, first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_sp_worker
from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.parallel import mesh as jmesh
from kvcache_factory_tpu.parallel import pipeline as jpipeline
from kvcache_factory_tpu.runtime import batching as jbatching
from kvcache_factory_tpu.runtime import engine as jengine
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.parallel import mesh as tmesh
from kvcache_factory_tpu_torch.parallel import pipeline as tpipeline
from kvcache_factory_tpu_torch.policies.methods import draw_shape
from kvcache_factory_tpu_torch.runtime import batching as tbatching
from kvcache_factory_tpu_torch.runtime import engine as tengine

BASE = dict(model_type="llama", vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4, head_dim=16,
            dtype="float32")
MOE = dict(BASE, model_type="mixtral", num_local_experts=4, num_experts_per_tok=2)
MODELS = {
    "tiny": BASE,
    "hkv2": dict(BASE, num_key_value_heads=2),
    "deep": dict(BASE, num_hidden_layers=4),
    "d128": dict(BASE, hidden_size=256, intermediate_size=512, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=128),
    "bias": BASE,   # + the four bias kinds (weights fixture)
    "w8a16": BASE,  # JAX's quantize_weights of the tiny weights
    "moe": MOE,
    "moe_w8a16": MOE,  # JAX's quantize_weights of the moe weights
}
SNAPKV = dict(method="snapkv", max_capacity_prompt=48, window_size=8, kernel_size=7,
              pooling="maxpool")
BUCKETS = (128,)
MAX_NEW = 6
PROMPT_LENS = (100, 60, 90, 30)
REL_L2_TOL = 1e-5
L = BASE["num_hidden_layers"]
# The compressing methods sequence parallelism serves beside snapkv
# (tests/test_torch_sp_prefill.py), and LOOK-M's merge on snapkv.
SP_METHODS = {m: dict(SNAPKV, method=m) for m in (
    "pyramidkv", "h2o", "streamingllm", "l2norm", "random", "adakv", "headkv", "cam", "think")}
SP_METHODS["lookm"] = dict(SNAPKV, merge="pivot")

# name -> (model, ShardingConfig fields, case fields beside the defaults)
CASES = {
    2: {
        "tp2": ("tiny", dict(tp=2), {}),
        "dp2_padded": ("tiny", dict(dp=2), dict(n_prompts=3)),
        "dcn2_dp2_padded": ("tiny", dict(dp=2, dcn_dp=2), dict(n_prompts=3)),
        "fullkv_tp2": ("tiny", dict(tp=2), dict(comp=dict(method="fullkv"))),
        "int8_tp2": ("d128", dict(tp=2), dict(quant=dict(nbits=8))),
        "int4_tp2": ("d128", dict(tp=2), dict(quant=dict(nbits=4))),
        "grouped4_tp2": ("tiny", dict(tp=2), dict(quant=dict(nbits=4, q_group_size=16))),
        "adakv_tp2": ("tiny", dict(tp=2), dict(comp=dict(SNAPKV, method="adakv"))),
        "cam_tp2": ("tiny", dict(tp=2), dict(comp=dict(SNAPKV, method="cam"))),
        "random_dp2": ("tiny", dict(dp=2), dict(comp=dict(SNAPKV, method="random"))),
        "headkv_tp2": ("tiny", dict(tp=2), dict(comp=dict(SNAPKV, method="headkv"))),
        "w8a16_tp2": ("w8a16", dict(tp=2), {}),
        "bias_tp2_whole": ("bias", dict(tp=2), dict(whole_params=True)),
        "moe_tp2": ("moe", dict(tp=2), {}),
        "ep2": ("moe", dict(ep=2), {}),
        "ep2_w8a16_whole": ("moe_w8a16", dict(ep=2), dict(whole_params=True)),
        "pp2_m2": ("deep", dict(pp=2, pp_microbatches=2), {}),
        "pp2_m4_pyramidkv": ("deep", dict(pp=2, pp_microbatches=4),
                             dict(comp=dict(SNAPKV, method="pyramidkv"))),
        "pp2_w8a16": ("w8a16", dict(pp=2), {}),
        "pp2_cam": ("deep", dict(pp=2), dict(comp=dict(SNAPKV, method="cam"))),
        "pp2_headkv_whole": ("deep", dict(pp=2), dict(comp=dict(SNAPKV, method="headkv"),
                                                      whole_params=True)),
        "forward_pp2": ("deep", dict(pp=2, pp_microbatches=2), dict(forward=True)),
        **{f"sp2_{m}": ("tiny", dict(sp=2), dict(comp=comp)) for m, comp in SP_METHODS.items()},
    },
    4: {
        "dp2_tp2": ("tiny", dict(dp=2, tp=2), {}),
        "tp4": ("tiny", dict(tp=4), {}),
        "tp4_over_hkv2": ("hkv2", dict(tp=4), {}),
        "sp2_tp2": ("tiny", dict(sp=2, tp=2), {}),
        "sp2_tp2_h2o": ("tiny", dict(sp=2, tp=2), dict(comp=SP_METHODS["h2o"])),
        "random_dp2_tp2": ("tiny", dict(dp=2, tp=2), dict(comp=dict(SNAPKV, method="random"))),
        "drain_dp2_tp2": ("tiny", dict(dp=2, tp=2), dict(n_slots=4, n_prompts=5)),
        "drain_chunked_dp2_tp2": ("tiny", dict(dp=2, tp=2), dict(n_slots=4, n_prompts=5,
                                                                chunk=32)),
        "sampled_dp2_tp2": ("tiny", dict(dp=2, tp=2), dict(sample=dict(
            do_sample=True, temperature=0.8, top_k=40), seed=5)),
        "ep2_tp2": ("moe", dict(ep=2, tp=2), {}),
        "dp2_ep2": ("moe", dict(dp=2, ep=2), {}),
        "drain_dp2_ep2": ("moe", dict(dp=2, ep=2), dict(n_slots=4, n_prompts=5)),
        "pp4_m4": ("deep", dict(pp=4), {}),
        "pp4_m8_random": ("deep", dict(pp=4, pp_microbatches=8),
                          dict(comp=dict(SNAPKV, method="random"))),
        "forward_pp4": ("deep", dict(pp=4, pp_microbatches=4), dict(forward=True)),
    },
}
ALL = [(n, name) for n in CASES for name in CASES[n]]
PER_TOKEN = ("int8_tp2", "int4_tp2")
# Held to the port's single device only: JAX's engine on the CPU takes its
# grouped cache for the per-token quant configs, and its engine is greedy.
NOT_JAX = PER_TOKEN + ("sampled_dp2_tp2",)
# The forward cases hold logits only.
ENGINE = [x for x in ALL if not CASES[x[0]][x[1]][2].get("forward")]


@pytest.fixture(scope="module")
def weights():
    """JAX weights per model (jax arrays and numpy), prompts, HeadKV
    capacities."""
    out = {}
    for name, m in MODELS.items():
        if name in ("bias", "w8a16", "moe_w8a16"):
            continue
        jp = jweights.init_params(jcfg.ModelConfig(**m), jax.random.PRNGKey(3), dtype=jnp.float32)
        out[name] = jp
    rng = np.random.default_rng(0)
    jp = dict(out["tiny"])
    layers = dict(jp["layers"])
    width = {"qkv_bias": layers["qkv_proj"].shape[-1], "o_bias": BASE["hidden_size"],
             "gate_up_bias": layers["gate_up_proj"].shape[-1], "down_bias": BASE["hidden_size"]}
    for key, w in width.items():
        layers[key] = jnp.asarray(0.1 * rng.standard_normal((L, w)), jnp.float32)
    out["bias"] = dict(jp, layers=layers)
    out["w8a16"] = jweights.quantize_weights(out["tiny"])
    out["moe_w8a16"] = jweights.quantize_weights(out["moe"])
    prompts = [rng.integers(0, BASE["vocab_size"], size=n).tolist() for n in PROMPT_LENS]
    prompts.append(rng.integers(0, BASE["vocab_size"], size=75).tolist())
    hc = rng.integers(0, 60, size=(4, BASE["num_attention_heads"])).astype(np.int32)
    return dict(jp=out, np={k: jax.tree.map(np.asarray, v) for k, v in out.items()},
                prompts=prompts, hc=hc)


def batch_multiple(sharding):
    """The multiple a layout pads its batch to: dp, or the microbatches."""
    sh = tcfg.ShardingConfig(**sharding)
    return (sh.pp_microbatches or sh.pp) if sh.pp > 1 else sh.dp


def _case(n, name, w):
    """The payload of one case (``torch_sp_worker._sharded_case``)."""
    model, sharding, extra = CASES[n][name]
    extra = dict(extra)
    prompts = w["prompts"][:extra.pop("n_prompts", len(PROMPT_LENS))]
    c = dict(dict(model=MODELS[model], comp=dict(SNAPKV), sharding=sharding,
                  params=w["np"][model], prompts=prompts, max_new=MAX_NEW, buckets=BUCKETS),
             **extra)
    if c["comp"]["method"] == "headkv":
        c["hc"] = w["hc"][:MODELS[model]["num_hidden_layers"]]
    if c["comp"]["method"] in ("cam", "random"):
        c["draws"] = jax_draws(c, -(-len(prompts) // batch_multiple(sharding))
                               * batch_multiple(sharding))
    if c.get("forward"):
        B = batch_multiple(sharding)
        c["tokens"] = np.zeros((B, BUCKETS[0]), np.int64)
        c["lens"] = np.zeros((B,), np.int32)
        for i in range(B):
            p = prompts[i % len(prompts)]
            c["tokens"][i, :len(p)], c["lens"][i] = p, len(p)
    return c


def jax_draws(c, batch):
    """What JAX's prefill draws for each (layer, example) of a batch of
    ``batch`` rows: ``PRNGKey(0)`` split over the layers, each layer's key
    over the batch, ``uniform(key, shape)`` at the whole model's shape."""
    m, comp = c["model"], tcfg.CompressionConfig(**c["comp"])
    layers = m["num_hidden_layers"]
    shape = draw_shape(comp, m["num_attention_heads"], m["num_key_value_heads"], BUCKETS[0])
    layer_keys = jax.random.split(jax.random.PRNGKey(0), layers)
    return {(li, b): np.array(jax.random.uniform(jax.random.split(layer_keys[li], batch)[b],
                                                 shape))
            for li in range(layers) for b in range(batch)}


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """One spawn per world size, every case of that size."""
    done = {}

    def run(n):
        if n not in done:
            done[n] = torch_sp_worker.spawn(n, tmp_path_factory.mktemp(f"sharded{n}"), "sharded",
                                            [_case(n, name, weights) for name in CASES[n]])
        return done[n]
    return run


def _rank_results(runs, n, name):
    i = list(CASES[n]).index(name)
    ranks = runs(n)
    return [rk["cases"][i] for rk in ranks], ranks[0]["single"][i]


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_engine_cfg(c):
    quant = None if c.get("quant") is None else jcfg.QuantConfig(**c["quant"])
    return jcfg.EngineConfig(model=jcfg.ModelConfig(**c["model"]),
                             compression=jcfg.CompressionConfig(**c["comp"]), quant=quant,
                             sharding=jcfg.ShardingConfig(**c["sharding"]),
                             prefill_buckets=c["buckets"])


# JAX's first-token logits by (weights, layout, padded batch): the prefill's
# logits do not depend on the compression or the cache, so the cases that
# differ only there share one compiled prefill.
_JAX_LOGITS = {}


def jax_reference(c, jp):
    """JAX's ids and first-token logits under the case's ``ShardingConfig``:
    its ``InferenceEngine`` (or ``ContinuousBatchingEngine``), and its
    prefill on the engine's sharded weights under the engine's mesh, on the
    batch its engine pads (under pp JAX's single-device prefill, since
    ``pp_generate`` returns no logits); for a forward case JAX's
    ``pipeline_forward`` on its pp mesh."""
    cfg = _jax_engine_cfg(c)
    prompts = c["prompts"]
    if c.get("forward"):
        mesh = jpipeline.make_pp_mesh(cfg.sharding.pp)
        got = jax.jit(lambda p, t, tl: jpipeline.pipeline_forward(
            p, cfg.model, t, tl, mesh, n_microbatches=cfg.sharding.pp_microbatches))(
            jpipeline.shard_params_pp(jp, mesh), jnp.asarray(c["tokens"], jnp.int32),
            jnp.asarray(c["lens"]))
        return [], np.asarray(got)
    if "n_slots" in c:
        eng = jbatching.ContinuousBatchingEngine(jp, cfg, n_slots=c["n_slots"],
                                                 max_new_cap=c["max_new"],
                                                 prefill_chunk_tokens=c.get("chunk", 0))
        rids = [eng.submit(p, c["max_new"]) for p in prompts]
        out = eng.run()
        return [out[r] for r in rids], None
    eng = jengine.InferenceEngine(jp, cfg, head_capacity=c.get("hc"))
    ids = eng.generate_batch(prompts, c["max_new"])
    S = eng._bucket(max(len(p) for p in prompts))
    B = -(-len(prompts) // eng.dp) * eng.dp
    toks = np.zeros((B, S), np.int32)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        p = prompts[min(i, len(prompts) - 1)]
        toks[i, :len(p)], lens[i] = p, len(p)
    comp, cap = eng._comp_for_bucket(S), eng._cache_capacity(S, c["max_new"])
    mesh = eng.sp_mesh if eng.sp_mesh is not None else eng.mesh
    key = (id(jp), len(prompts), B,
           None if mesh is None else tuple(sorted(c["sharding"].items())))
    if key in _JAX_LOGITS:
        return ids, _JAX_LOGITS[key][:len(prompts)]

    def logits(p, t, tl):
        return jllama.prefill(p, cfg.model, comp, t, tl, cap, rng=eng.rng,
                              head_capacity=eng.head_capacity, quant=cfg.quant,
                              attn_backend="xla", sp_mesh=eng.sp_mesh).logits_last

    if mesh is None:  # pp: the single-device prefill on the whole tree
        got = jax.jit(logits)(jp, jnp.asarray(toks), jnp.asarray(lens))
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P
        b_ax = "dp" if "dp" in mesh.axis_names else None
        t_spec = P(b_ax, "sp") if eng.sp_mesh is not None else P(b_ax, None)
        with mesh:
            got = jax.jit(logits)(eng.params,
                                  jax.device_put(jnp.asarray(toks), NamedSharding(mesh, t_spec)),
                                  jax.device_put(jnp.asarray(lens), NamedSharding(mesh, P(b_ax))))
    _JAX_LOGITS[key] = np.asarray(got)
    return ids, _JAX_LOGITS[key][:len(prompts)]


@pytest.mark.parametrize("n,name", [x for x in ALL if x[1] not in NOT_JAX])
def test_ranks_match_jax_engine_under_the_same_sharding(weights, runs, n, name):
    """Every rank's ids equal JAX's engine's under the same
    ``ShardingConfig`` (GSPMD on the 8-device CPU mesh), and its first-token
    logits lie within 1e-5 relative L2 of JAX's prefill there."""
    c = _case(n, name, weights)
    want_ids, want_logits = jax_reference(c, weights["jp"][CASES[n][name][0]])
    ranks, _ = _rank_results(runs, n, name)
    for r, rk in enumerate(ranks):
        assert rk["ids"] == want_ids, f"rank {r}"
        if want_logits is None:
            continue
        for i, got in rk["logits"].items():
            assert rel_l2(got, want_logits[i]) < REL_L2_TOL, f"rank {r}, prompt {i}"


@pytest.mark.parametrize("n,name", ALL)
def test_ranks_match_single_device_and_each_other(runs, n, name):
    """The same ids as the port's single-device engine and first-token
    logits within 1e-5 relative L2; every rank's logits of a prompt bitwise
    equal (a drain's rank records the prompts its slots served)."""
    ranks, single = _rank_results(runs, n, name)
    for r, rk in enumerate(ranks):
        assert rk["ids"] == single["ids"], f"rank {r}"
        for i, got in rk["logits"].items():
            assert rel_l2(got, single["logits"][i]) < REL_L2_TOL, f"rank {r}, prompt {i}"
            np.testing.assert_array_equal(
                got, next(o["logits"][i] for o in ranks if i in o["logits"]))
    served = set().union(*(rk["logits"] for rk in ranks))
    assert served == set(single["logits"])


def _cache_slices(c, coords, heads):
    """The single-device cache's layers, batch rows and heads that the rank
    at ``coords`` holds: a pipeline stage all rows and heads of its layers;
    a grid rank all layers, its dp rows and its tp heads (every head under
    ep alone)."""
    sh = tcfg.ShardingConfig(**c["sharding"])
    m = tcfg.ModelConfig(**c["model"])
    n_rows = c.get("n_slots") or -(-len(c["prompts"]) // batch_multiple(c["sharding"])) * \
        batch_multiple(c["sharding"])
    if sh.pp > 1:
        l0, n = tpipeline.stage_layers(m, sh.pp, coords[0])
        return slice(l0, l0 + n), slice(0, n_rows), slice(0, heads)
    rows = n_rows // sh.dp
    comp = tcfg.CompressionConfig(**c["comp"])
    per_query = comp.cache_heads(m.num_attention_heads, m.num_key_value_heads) == \
        m.num_attention_heads
    h0 = coords[2] * heads if per_query else tmesh.kv_head_offset(m, sh.tp, coords[2])
    return (slice(None), slice(coords[0] * rows, (coords[0] + 1) * rows),
            slice(h0, h0 + heads))


@pytest.mark.parametrize("n,name", ENGINE)
def test_cache_shards_are_slices_of_the_single_device_cache(weights, runs, n, name):
    """Each rank's cache holds its rows and heads (a pipeline stage, its
    layers) of the single-device cache: lengths and positions equal, and
    over each head's valid prefix float planes within fp32 summation error
    and code planes equal but for rounding ties (at most 1% of the bytes),
    so every rank selected what one device selects.  A drain's slots are
    admitted in one order on both sides; its rows are compared where the
    single device ran the same request in the same slot."""
    c = _case(n, name, weights)
    ranks, single = _rank_results(runs, n, name)
    want = single["cache"]
    for r, rk in enumerate(ranks):
        got = rk["cache"]
        assert set(got) == set(want)
        heads = got["lengths"].shape[2]
        layers, rows, hs = _cache_slices(c, rk["coords"], heads)
        # Rows past the prompts pad the batch to a multiple of dp.
        n_real = c["n_slots"] if "n_slots" in c else len(c["prompts"])
        keep = slice(0, min(rows.stop, n_real) - rows.start)
        lens = want["lengths"][layers, rows, hs][:, keep]
        np.testing.assert_array_equal(got["lengths"][:, keep], lens, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["positions"][keep], want["positions"][rows][keep])
        capacity = max(p.shape[3] for p in got.values() if p.ndim >= 4)
        for key, plane in got.items():
            if plane.ndim < 4:
                continue
            ref = want[key][layers, rows, hs][:, keep]
            plane = plane[:, keep]
            assert plane.shape == ref.shape, key
            # A plane of the cache's capacity over each head's valid prefix;
            # a ring (the grouped cache's fp rows) whole.
            valid = np.ones(plane.shape, bool)
            if plane.shape[3] == capacity:
                valid = np.arange(capacity) < lens[..., None]
                valid = np.broadcast_to(valid.reshape(valid.shape + (1,) * (plane.ndim - 4)),
                                        plane.shape)
            if np.issubdtype(plane.dtype, np.floating):
                np.testing.assert_allclose(plane[valid], ref[valid], rtol=1e-4, atol=1e-5,
                                           err_msg=f"rank {r}: {key}")
            else:
                assert np.mean(plane[valid] != ref[valid]) <= 0.01, f"rank {r}: {key}"


@pytest.mark.parametrize("n", sorted(CASES))
def test_ranks_import_no_jax(runs, n):
    """The spawned ranks loaded neither JAX nor the JAX package, and each
    axis wider than one rank counted its collectives (none staged: the
    tensors lie on the CPU)."""
    for rk in runs(n):
        assert rk["banned_modules"] == []
        for case in rk["cases"]:
            assert case["counts"] and all(a["collectives"] > 0 and a["staged_bytes"] == 0
                                          for a in case["counts"].values())


def _port_cfg(model="tiny", comp=SNAPKV, **sharding):
    return tcfg.EngineConfig(model=tcfg.ModelConfig(**MODELS[model]),
                             compression=tcfg.CompressionConfig(**comp),
                             sharding=tcfg.ShardingConfig(**sharding), prefill_buckets=BUCKETS)


@pytest.mark.parametrize("what", ["slots_dp", "vocab_tp", "kv_cache_tp_over_hkv",
                                  "grouped_reduce_tp_over_hkv", "no_group"])
def test_layout_refusals(weights, what):
    """What the port refuses, before any process group is needed: slots
    that dp does not divide (as JAX's batching engine), a vocabulary that
    tp does not divide (JAX's ``device_put`` refuses the uneven shard), a
    cache of the KV heads (fullkv, a grouped reduce) under tp > Hkv; and a
    valid layout without a process group of its size."""
    tp_params = params_from_jax(weights["np"]["tiny"], device="cpu")
    if what == "slots_dp":
        with pytest.raises(ValueError, match="divisible by dp=2"):
            tbatching.ContinuousBatchingEngine(tp_params, _port_cfg(dp=2), n_slots=3,
                                               device="cpu")
        with pytest.raises(ValueError):
            jbatching.ContinuousBatchingEngine(weights["jp"]["tiny"], jcfg.EngineConfig(
                model=jcfg.ModelConfig(**BASE), sharding=jcfg.ShardingConfig(dp=2)), n_slots=3)
    elif what == "vocab_tp":
        cfg = tcfg.EngineConfig(model=tcfg.ModelConfig(**dict(BASE, vocab_size=255)),
                                sharding=tcfg.ShardingConfig(tp=2), prefill_buckets=BUCKETS)
        with pytest.raises(ValueError, match="vocab_size=255"):
            tengine.InferenceEngine(tp_params, cfg, device="cpu")
    elif what in ("kv_cache_tp_over_hkv", "grouped_reduce_tp_over_hkv"):
        comp = (dict(method="fullkv") if what.startswith("kv_cache")
                else dict(SNAPKV, group_reduce="mean"))
        with pytest.raises(ValueError, match="KV heads, which tp=4 does not divide"):
            tengine.InferenceEngine(tp_params, _port_cfg("hkv2", comp, tp=4), device="cpu")
        # The per-query-head cache takes the same layout (the spawned case tp4_over_hkv2).
        tengine.check_tp_layout(_port_cfg("hkv2", SNAPKV, tp=4))
    else:
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
            tengine.InferenceEngine(tp_params, _port_cfg(dp=2, tp=2), device="cpu")


@pytest.mark.parametrize("model", ["tiny", "w8a16", "bias", "moe", "hkv2"])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_shards_concatenate_back_to_the_whole_leaves(weights, model, tp):
    """Every leaf has a spec, on the axis where JAX's ``param_specs`` puts
    ``tp``; the tp shards of each leaf, split back into their components
    (q, k, v by heads; gate, up by columns) and concatenated in rank order,
    are the whole leaf bitwise (KV heads read by several ranks once)."""
    cfg = tcfg.ModelConfig(**MODELS[model])
    if cfg.num_attention_heads % tp or (cfg.num_key_value_heads % tp and
                                        tp % cfg.num_key_value_heads):
        pytest.skip("the layout does not split these heads")
    whole = weights["np"][model]
    jspecs = jmesh.param_specs(jcfg.ModelConfig(**MODELS[model]))
    specs = tmesh.param_specs(cfg)
    for key, leaf in list(whole["layers"].items()) + [(k, whole[k]) for k in whole
                                                     if k != "layers"]:
        spec = specs["layers"][key] if key in whole["layers"] else specs[key]
        jspec = jspecs["layers"][key] if key in whole["layers"] else jspecs[key]
        ndim = np.ndim(leaf["q"] if isinstance(leaf, dict) else leaf)
        want = next((i - ndim for i, a in enumerate(jspec) if a == "tp"), None)
        assert spec == want, key
    shards = [tmesh.shard_tree(whole, cfg, tp, r) for r in range(tp)]
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    nq, nkv = Hq // tp, max(Hkv // tp, 1)

    def rebuild(key, parts, axis):
        if axis is None:
            assert all(p is parts[0] for p in parts)
            return parts[0]
        if key.startswith("qkv"):
            q = np.concatenate([np.take(p, range(nq * D), axis) for p in parts], axis)
            step = max(tp // Hkv, 1)  # ranks that read one KV head
            kv = [np.take(p, range(nq * D, p.shape[axis]), axis) for p in parts[::step]]
            k = np.concatenate([np.take(x, range(nkv * D), axis) for x in kv], axis)
            v = np.concatenate([np.take(x, range(nkv * D, 2 * nkv * D), axis) for x in kv], axis)
            return np.concatenate([q, k, v], axis)
        if key.startswith("gate_up"):
            f = parts[0].shape[axis] // 2
            return np.concatenate([np.take(p, range(f), axis) for p in parts]
                                  + [np.take(p, range(f, 2 * f), axis) for p in parts], axis)
        return np.concatenate(parts, axis)

    for key, leaf in whole["layers"].items():
        got = [s["layers"][key] for s in shards]
        axis = specs["layers"][key]
        if isinstance(leaf, dict):
            np.testing.assert_array_equal(rebuild(key, [g["q"] for g in got], axis), leaf["q"])
            s_axis = axis if axis == -1 else None
            np.testing.assert_array_equal(rebuild(key, [g["s"] for g in got], s_axis), leaf["s"])
        else:
            np.testing.assert_array_equal(rebuild(key, got, axis), leaf, err_msg=key)
    for key in ("embed", "final_norm", "lm_head"):
        got = [s[key] for s in shards]
        leaf = whole[key]
        parts = [g["q"] for g in got] if isinstance(leaf, dict) else got
        np.testing.assert_array_equal(rebuild(key, parts, specs[key]),
                                      leaf["q"] if isinstance(leaf, dict) else leaf)


def test_dcn_dp_on_one_host_is_dp(runs):
    """``ShardingConfig(dp=2, dcn_dp=2)`` on one host is plain dp, as JAX's
    flat mesh when ``process_count() == 1``: every rank's ids, logits and
    cache bitwise those of the dp=2 run."""
    dcn, _ = _rank_results(runs, 2, "dcn2_dp2_padded")
    dp, _ = _rank_results(runs, 2, "dp2_padded")
    for a, b in zip(dcn, dp):
        assert a["ids"] == b["ids"] and a["coords"] == b["coords"]
        for i in b["logits"]:
            np.testing.assert_array_equal(a["logits"][i], b["logits"][i])
        for key in b["cache"]:
            np.testing.assert_array_equal(a["cache"][key], b["cache"][key])


@pytest.mark.parametrize("world,local,dcn_dp,hosts", [
    (4, 4, 2, 1),      # one host: plain dp
    (4, 2, 2, 2),      # two hosts carry the two inter-host ways
    (4, 1, 2, None),   # four hosts for two ways: cannot be placed
    (8, 2, 2, None),   # four hosts, dcn_dp 2
    (6, 4, 2, None),   # ranks that do not split into hosts
])
def test_dcn_dp_placement(world, local, dcn_dp, hosts):
    """Across hosts (torchrun's ``WORLD_SIZE`` over ``LOCAL_WORLD_SIZE``)
    the ``dcn_dp`` ways of dp are the hosts; a layout that cannot put them
    there raises ``ValueError``.  JAX's ``dcn_dp`` must divide ``dp``."""
    sh = tcfg.ShardingConfig(dp=4, dcn_dp=dcn_dp)
    if hosts is None:
        with pytest.raises(ValueError):
            tmesh.check_dcn(sh, world, local)
    else:
        assert tmesh.check_dcn(sh, world, local) == hosts
    with pytest.raises(ValueError, match="dcn_dp must divide dp"):
        tcfg.ShardingConfig(dp=2, dcn_dp=4)
    with pytest.raises(ValueError, match="dcn_dp must divide dp"):
        jcfg.ShardingConfig(dp=2, dcn_dp=4)


@pytest.mark.parametrize("what", ["quant", "decode_evict", "think_packed", "sliding_window",
                                  "microbatches"])
def test_pp_refusals(weights, what):
    """JAX's pp scope, as ``ValueError`` before any process group is
    needed: the dense cache only (JAX asserts at its engine,
    ``runtime/engine.py:58-61``), no sliding window (JAX asserts in
    ``pp_generate``), microbatches at least the stages (JAX's
    ``ValueError``)."""
    params = params_from_jax(weights["np"]["deep"], device="cpu")
    model, comp, quant = dict(MODELS["deep"]), dict(SNAPKV), None
    if what == "microbatches":
        with pytest.raises(ValueError, match="pp_microbatches must be >= pp"):
            tcfg.ShardingConfig(pp=4, pp_microbatches=2)
        with pytest.raises(ValueError, match="pp_microbatches must be >= pp"):
            jcfg.ShardingConfig(pp=4, pp_microbatches=2)
        return
    if what == "quant":
        quant = dict(nbits=8)
    elif what == "sliding_window":
        model["sliding_window"] = 64
    else:
        comp.update({what: True}, method="think" if what == "think_packed" else "snapkv")
    cfg = tcfg.EngineConfig(model=tcfg.ModelConfig(**model),
                            compression=tcfg.CompressionConfig(**comp),
                            quant=None if quant is None else tcfg.QuantConfig(**quant),
                            sharding=tcfg.ShardingConfig(pp=2), prefill_buckets=BUCKETS)
    with pytest.raises(ValueError, match="pp"):
        tengine.InferenceEngine(params, cfg, device="cpu")
    if what != "sliding_window":
        jc = jcfg.EngineConfig(model=jcfg.ModelConfig(**model),
                               compression=jcfg.CompressionConfig(**comp),
                               quant=None if quant is None else jcfg.QuantConfig(**quant),
                               sharding=jcfg.ShardingConfig(pp=2), prefill_buckets=BUCKETS)
        with pytest.raises(AssertionError):
            jengine.InferenceEngine(weights["jp"]["deep"], jc)


@pytest.mark.parametrize("what", ["chunked_ep", "batching_sp", "batching_pp", "ep_dense_model",
                                  "ep_over_experts"])
def test_layout_refusals_that_remain(weights, what):
    """What stays refused: chunked admission under ep (JAX's ``ValueError``,
    ``runtime/batching.py:144-153``), sp and pp in the batching engine
    (JAX's has no path for either), ep on a model without experts or over
    more ranks than experts divide."""
    moe = params_from_jax(weights["np"]["moe"], device="cpu")
    tiny = params_from_jax(weights["np"]["tiny"], device="cpu")
    if what == "chunked_ep":
        with pytest.raises(ValueError, match="expert parallelism"):
            tbatching.ContinuousBatchingEngine(moe, _port_cfg("moe", ep=2), device="cpu",
                                               prefill_chunk_tokens=32)
        with pytest.raises(ValueError, match="expert parallelism"):
            jbatching.ContinuousBatchingEngine(weights["jp"]["moe"], jcfg.EngineConfig(
                model=jcfg.ModelConfig(**MOE), sharding=jcfg.ShardingConfig(ep=2),
                prefill_buckets=BUCKETS), prefill_chunk_tokens=32)
    elif what.startswith("batching"):
        axis = what.split("_")[1]
        with pytest.raises(ValueError, match="sp and pp run through InferenceEngine"):
            tbatching.ContinuousBatchingEngine(tiny, _port_cfg(**{axis: 2}), device="cpu")
    elif what == "ep_dense_model":
        with pytest.raises(ValueError, match="no"):
            tengine.InferenceEngine(tiny, _port_cfg(ep=2), device="cpu")
    else:
        with pytest.raises(ValueError, match="does not divide num_local_experts"):
            tengine.InferenceEngine(moe, _port_cfg("moe", ep=8), device="cpu")


@pytest.mark.parametrize("model", ["moe", "moe_w8a16"])
@pytest.mark.parametrize("ep,tp", [(2, 1), (4, 1), (2, 2)])
def test_expert_shards_concatenate_back(weights, model, ep, tp):
    """Each ep rank's expert stacks (``q`` and ``s`` alike) are its block
    of experts; concatenated over ep they are the tp shard of the whole
    stack bitwise; every other leaf is the tp shard alone (replicated over
    ep, as JAX's ``param_specs(ep=True)``)."""
    cfg = tcfg.ModelConfig(**MODELS[model])
    whole = weights["np"][model]
    jspecs = jmesh.param_specs(jcfg.ModelConfig(**MODELS[model]), ep=True)
    for r in range(tp):
        plain = tmesh.shard_tree(whole, cfg, tp, r)
        parts = [tmesh.shard_tree(whole, cfg, tp, r, ep, e) for e in range(ep)]
        for key, leaf in plain["layers"].items():
            expert = "ep" in jspecs["layers"][key]
            for name in (("q", "s") if isinstance(leaf, dict) else (None,)):
                pick = (lambda x: x[name]) if name else (lambda x: x)
                got = [pick(p["layers"][key]) for p in parts]
                if expert:
                    np.testing.assert_array_equal(np.concatenate(got, axis=1), pick(leaf))
                else:
                    for g in got:
                        np.testing.assert_array_equal(g, pick(leaf))


@pytest.mark.parametrize("model,pp", [("deep", 2), ("deep", 4), ("w8a16", 2)])
def test_stage_params_concatenate_back(weights, model, pp):
    """A stage holds its ``L / pp`` contiguous layers of every layer leaf
    (``q`` and ``s`` alike), the embedding on stage 0 and ``final_norm`` /
    ``lm_head`` on the last stage; the stages' layers concatenated are the
    whole leaves bitwise."""
    cfg = tcfg.ModelConfig(**MODELS[model])
    whole = weights["np"][model]
    stages = [tpipeline.shard_params_pp(whole, cfg, pp, s) for s in range(pp)]
    assert [sorted(k for k in st if k != "layers") for st in stages] == \
        [["embed"]] + [[]] * (pp - 2) + [["final_norm", "lm_head"]]
    for key, leaf in whole["layers"].items():
        for name in (("q", "s") if isinstance(leaf, dict) else (None,)):
            pick = (lambda x: x[name]) if name else (lambda x: x)
            np.testing.assert_array_equal(
                np.concatenate([pick(st["layers"][key]) for st in stages]), pick(leaf))
