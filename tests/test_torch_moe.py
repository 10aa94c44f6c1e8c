"""Mixtral's sparse-MoE FFN in the port against the JAX package and HF.

A tiny Mixtral (hidden 64, ffn 96, 2 layers, Hq 4, Hkv 2, head_dim 16,
vocab 128, top-2 of E 4 or 8 experts) in fp32 on the CPU, its weights from
JAX's ``init_params`` carried across with ``params_from_jax``; inputs from
``np.random.default_rng``.

- ``moe_router``: ``topi`` exact, on integer-valued inputs whose logits tie
  exactly (the port ranks by a stable descending sort, which keeps the
  lower expert first, as ``lax.top_k``), ``topv`` and ``combine`` within
  1e-6.
- ``moe_ffn``: at T = 1 in both of JAX's branches (B*k <= E/2 gathers the
  selected experts, above it the dense all-expert combine) and at T > 1
  (JAX's dense combine, the port's per-token dispatch), with fp32 and with
  W8A16 expert leaves, within 1e-5: the same function summed in another
  order.  W8A16 ``q`` and ``s`` bitwise with JAX's ``quantize_weights``.
- The model: prefill logits within 1e-4 (two layers of fp32 summation-order
  error and the vocab-wide lm_head sum, as ``tests/test_torch_generate.py``),
  ``generate``, ``InferenceEngine`` and ``ContinuousBatchingEngine`` token
  streams identical to JAX's.
- The tiny HF Mixtral of ``tests/test_model_parity.py``: ``load_params``
  leaves bitwise against JAX's ``load_params`` of the same directory, and
  ``forward_logits`` (every position) and prefill logits within 1e-4 of
  HF's forward.
"""

import torch_threads  # noqa: F401  (torch's thread share, first)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.runtime import batching as jbatching
from kvcache_factory_tpu.runtime import engine as jengine
from kvcache_factory_tpu.runtime.generate import generate as jax_generate
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.models import llama as tllama
from kvcache_factory_tpu_torch.models import weights as tweights
from kvcache_factory_tpu_torch.models.reference import forward_logits
from kvcache_factory_tpu_torch.runtime import batching as tbatching
from kvcache_factory_tpu_torch.runtime import engine as tengine
from kvcache_factory_tpu_torch.runtime import generate as tgenerate

MODEL = dict(model_type="mixtral", vocab_size=128, hidden_size=64, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=512, rope_theta=10000.0, dtype="float32",
             num_experts_per_tok=2)
K = MODEL["num_experts_per_tok"]
ROUTER_TOL = dict(rtol=1e-6, atol=1e-6)
FFN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
SNAPKV = dict(method="snapkv", max_capacity_prompt=24, window_size=8, kernel_size=7,
              pooling="maxpool")
BUCKET = 64


@pytest.fixture(scope="module")
def models():
    """E -> the JAX and port configs and weights (built on first use)."""
    built = {}

    def get(E):
        if E not in built:
            jc = jcfg.ModelConfig(**MODEL, num_local_experts=E)
            tc = tcfg.ModelConfig(**MODEL, num_local_experts=E)
            jp = jweights.init_params(jc, jax.random.PRNGKey(E), dtype=jnp.float32)
            tp = tweights.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
            built[E] = dict(jc=jc, tc=tc, jp=jp, tp=tp)
        return built[E]
    return get


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL["vocab_size"], size=n).tolist() for n in lengths]


def _padded(prompts, S=BUCKET):
    toks = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, np.asarray([len(p) for p in prompts], np.int32)


# --- the router and the FFN --------------------------------------------------

@pytest.mark.parametrize("E", [4, 8])
def test_moe_router_matches_jax_with_planted_ties(E):
    """Small integers in x and the router give exact logits with many ties,
    so softmax gives equal probabilities and the top-k order is the tie
    rule alone: ``topi`` must equal ``lax.top_k``'s."""
    rng = np.random.default_rng(E)
    x = rng.integers(-1, 2, size=(3, 5, 16)).astype(np.float32)
    w = rng.integers(-1, 2, size=(16, E)).astype(np.float32)
    w[:, 1] = w[:, 0]          # experts 0 and 1 always tie
    w[:, E - 1] = w[:, 2]      # and 2 with the last
    cj, ij, vj = jllama.moe_router(jnp.asarray(x), jnp.asarray(w), K)
    ct, it, vt = tllama.moe_router(torch.tensor(x), torch.tensor(w), K)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), axis=-1))
    kth = np.sort(probs, axis=-1)[..., ::-1]
    assert (kth[..., K - 1] == kth[..., K]).any(), "no tie at the k-th place"
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **ROUTER_TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **ROUTER_TOL)


# (E, B, T): T = 1 below and above JAX's B*k <= E/2 gather bound, then T > 1.
FFN_CASES = [(4, 1, 1), (4, 2, 1), (8, 2, 1), (8, 4, 1), (8, 2, 12)]


def _quantized(m):
    """Both packages' W8A16 trees of one model, memoised on it."""
    if "qjp" not in m:
        m["qjp"] = jweights.quantize_weights(m["jp"])
        m["qtp"] = tweights.quantize_weights(m["tp"])
    return m["qjp"], m["qtp"]


@pytest.mark.parametrize("w8a16", [False, True], ids=["fp32", "w8a16"])
@pytest.mark.parametrize("E,B,T", FFN_CASES)
def test_moe_ffn_matches_jax(models, E, B, T, w8a16):
    m = models(E)
    jp, tp = _quantized(m) if w8a16 else (m["jp"], m["tp"])
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    tlp = tllama._layer(tp, 1)
    x = np.random.default_rng(E * 100 + B * 10 + T).normal(
        size=(B, T, MODEL["hidden_size"])).astype(np.float32)
    want = np.asarray(jllama.moe_ffn(jnp.asarray(x), jlp, m["jc"]))
    got = tllama.moe_ffn(torch.tensor(x), tlp, m["tc"]).numpy()
    np.testing.assert_allclose(got, want, **FFN_TOL)
    # The decode form equals the port's own dispatch on the same rows.
    if T == 1:
        dispatch = tllama.moe_ffn(torch.tensor(x).reshape(1, B, -1), tlp, m["tc"])
        np.testing.assert_allclose(got[:, 0], dispatch[0].numpy(), **FFN_TOL)


@pytest.mark.parametrize("E", [4, 8])
def test_w8a16_expert_leaves_bitwise_with_jax(models, E):
    qjp, qtp = _quantized(models(E))
    for name in ("gate_up_proj", "down_proj"):
        for part in ("q", "s"):
            np.testing.assert_array_equal(qtp["layers"][name][part].numpy(),
                                          np.asarray(qjp["layers"][name][part]))
    assert not isinstance(qtp["layers"]["router"], dict)  # the router stays fp


def test_init_params_moe_shapes_and_fan_in():
    cfg = tcfg.ModelConfig(**dict(MODEL, hidden_size=256), num_local_experts=8)
    p = tweights.init_params(cfg, seed=0, device="cpu")
    lay = p["layers"]
    assert lay["router"].shape == (2, 256, 8)
    assert lay["gate_up_proj"].shape == (2, 8, 256, 2 * 96)
    assert lay["down_proj"].shape == (2, 8, 96, 256)
    # normal / sqrt(fan_in), the input axis: 256 for gate_up, 96 for down.
    assert abs(float(lay["gate_up_proj"].std()) * 16 - 1) < 0.02
    assert abs(float(lay["down_proj"].std()) * 96 ** 0.5 - 1) < 0.02


# --- the model ----------------------------------------------------------------

@pytest.mark.parametrize("w8a16", [False, True], ids=["fp32", "w8a16"])
@pytest.mark.parametrize("E", [4, 8])
def test_prefill_and_generate_match_jax(models, E, w8a16):
    """fullkv prefill logits of two right-padded prompts, then snapkv
    ``generate`` (8 new tokens, decode T = 1 at B = 2: JAX's gather branch
    at E 8, its dense one at E 4)."""
    m = models(E)
    jp, tp = _quantized(m) if w8a16 else (m["jp"], m["tp"])
    toks, lens = _padded(_prompts(E, (60, 37)))
    full_j, full_t = jcfg.CompressionConfig(method="fullkv"), tcfg.CompressionConfig(method="fullkv")
    want = jllama.prefill(jp, m["jc"], full_j, jnp.asarray(toks), jnp.asarray(lens), BUCKET)
    got = tllama.prefill(tp, m["tc"], full_t, torch.tensor(toks), torch.tensor(lens), BUCKET)
    np.testing.assert_allclose(got.logits_last.numpy(), np.asarray(want.logits_last),
                               **LOGITS_TOL)
    cap, new = 40, 8
    jres = jax_generate(jp, m["jc"], jcfg.CompressionConfig(**SNAPKV),
                        jcfg.GenerationConfig(max_new_tokens=new), jnp.asarray(toks),
                        jnp.asarray(lens), cap)
    tres = tgenerate.generate(tp, m["tc"], tcfg.CompressionConfig(**SNAPKV),
                              tcfg.GenerationConfig(max_new_tokens=new), toks, lens, cap,
                              device="cpu")
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.cache.lengths.numpy(), np.asarray(jres.cache.lengths))


@pytest.mark.parametrize("chunk_tokens", [None, 0, 32], ids=["inference", "one_shot", "chunked"])
def test_engines_match_jax(models, chunk_tokens):
    """``InferenceEngine`` on two prompts, and ``ContinuousBatchingEngine``
    (one-shot and chunked admission, four prompts through two slots), each
    against the JAX engine: identical streams."""
    m = models(8)
    comp_j, comp_t = jcfg.CompressionConfig(**SNAPKV), tcfg.CompressionConfig(**SNAPKV)
    kw = dict(prefill_buckets=(32, BUCKET))
    jecfg = jcfg.EngineConfig(model=m["jc"], compression=comp_j, **kw)
    tecfg = tcfg.EngineConfig(model=m["tc"], compression=comp_t, **kw)
    if chunk_tokens is None:
        prompts = _prompts(5, (50, 20))
        want = jengine.InferenceEngine(m["jp"], jecfg).generate_batch(prompts, 6)
        got = tengine.InferenceEngine(m["tp"], tecfg, device="cpu").generate_batch(prompts, 6)
        assert got == want
        return
    prompts = _prompts(6, (50, 20, 64, 33))
    new = [5, 6, 4, 5]
    ekw = dict(n_slots=2, max_new_cap=6, chunk_size=4, prefill_chunk_tokens=chunk_tokens)
    jeng = jbatching.ContinuousBatchingEngine(m["jp"], jecfg, **ekw)
    jrids = [jeng.submit(p, n) for p, n in zip(prompts, new)]
    jout = jeng.run()
    teng = tbatching.ContinuousBatchingEngine(m["tp"], tecfg, device="cpu", **ekw)
    trids = [teng.submit(p, n) for p, n in zip(prompts, new)]
    tout = teng.run()
    assert [tout[r] for r in trids] == [jout[r] for r in jrids]


# --- a tiny HF Mixtral -----------------------------------------------------------

@pytest.fixture(scope="module")
def hf_mixtral(tmp_path_factory):
    """``tests/test_model_parity.py``'s tiny HF Mixtral (3 layers, E 4),
    saved once under a temporary directory."""
    from transformers import MixtralConfig, MixtralForCausalLM
    torch.manual_seed(10)
    hf_cfg = MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=512, rope_theta=10000.0,
        rms_norm_eps=1e-5, sliding_window=None, tie_word_embeddings=False)
    model = MixtralForCausalLM(hf_cfg).eval()
    path = tmp_path_factory.mktemp("mixtral")
    model.save_pretrained(path, max_shard_size="200KB")
    cfg = dataclasses.replace(tcfg.ModelConfig.from_hf_config(hf_cfg), dtype="float32")
    return model, cfg, str(path)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_hf_mixtral_load_params_bitwise_with_jax(hf_mixtral):
    _, cfg, path = hf_mixtral
    tp, tc = tweights.load_params(path, dtype=torch.float32, device="cpu")
    jp, jc = jweights.load_params(path, dtype=jnp.float32)
    assert tc.is_moe and tc.num_local_experts == 4 and tc == dataclasses.replace(cfg, dtype=tc.dtype)
    got, want = dict(_leaves(tp)), dict(_leaves(jax.tree.map(np.asarray, jp)))
    assert set(got) == set(want) and {"layers.router", "layers.gate_up_proj"} <= set(got)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


def test_hf_mixtral_logits_match_hf(hf_mixtral):
    """``forward_logits`` at every position and the port's prefill at each
    row's last token against HF's forward, on the weights read from the
    saved checkpoint."""
    model, cfg, path = hf_mixtral
    tp, _ = tweights.load_params(path, cfg, dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(20).integers(0, cfg.vocab_size, size=(2, 40))
    with torch.no_grad():
        hf = model(torch.tensor(toks)).logits.numpy()
    np.testing.assert_allclose(forward_logits(tp, cfg, torch.tensor(toks)).numpy(), hf,
                               **LOGITS_TOL)
    lens = np.array([40, 29], np.int32)
    pre = tllama.prefill(tp, cfg, tcfg.CompressionConfig(method="fullkv"), torch.tensor(toks),
                         torch.tensor(lens), 40)
    np.testing.assert_allclose(pre.logits_last.numpy(), hf[[0, 1], lens - 1], **LOGITS_TOL)


def test_bf16_routing_near_fp32_reference():
    """What bf16 alone does to the routing, which sets the limit
    ``chip_smoke.py`` holds the card's flips to: a Mixtral-shaped model cut
    to hidden 1024 and 4 layers (8 / 2 heads of 128, E 8, top-2), bf16
    weights, one 600-token prompt through the port's bf16 prefill on the
    CPU, against the fp32 reference forward on the same weights with the
    bf16 run's routing replayed (``chip_smoke.routing_record`` /
    ``routing_replay``).  A decision (the set of a token's two experts in a
    layer) may differ only where the reference's 2nd and 3rd probabilities
    are within 2 max |dp|; the card's limit is at least twice that reach.
    ``-s`` prints the measurement."""
    import chip_smoke
    cfg = tcfg.ModelConfig(model_type="mixtral", vocab_size=2048, hidden_size=1024,
                           intermediate_size=3584, num_hidden_layers=4, num_attention_heads=8,
                           num_key_value_heads=2, rope_theta=1e6, dtype="bfloat16",
                           num_local_experts=8, num_experts_per_tok=2)
    params = tweights.init_params(cfg, seed=0, device="cpu")
    T = 600
    prompt = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, T)))
    calls, report = [], []
    with chip_smoke.routing_record(calls):
        pre = tllama.prefill(params, cfg, tcfg.CompressionConfig(method="fullkv"), prompt,
                             torch.tensor([T]), T)
    with chip_smoke.routing_replay([c[0][0] for c in calls], report):
        ref = forward_logits(params, cfg, prompt)[0, -1]
    rel = ((pre.logits_last[0] - ref).norm() / ref.norm()).item()
    dp = max((c[1] - r[1]).abs().max().item() for c, r in zip(calls, report))
    margins = []
    for (card_i, _), (own_i, probs) in zip(calls, report):
        differ = (card_i.sort(-1).values != own_i.sort(-1).values).any(-1)
        top = probs.sort(-1, descending=True).values
        margins += (top[..., 1] - top[..., 2])[differ].tolist()
    print(f"bf16 routing against fp32, {cfg.num_hidden_layers} layers x {T} tokens: "
          f"max |dp| {dp:.3e}; {len(margins)} decisions differ, at margins up to "
          f"{max(margins, default=0.0):.3e}; first-token rel L2 {rel:.4f}")
    assert all(m < 2 * dp for m in margins)
    assert 2 * (2 * dp) <= chip_smoke.MOE_FLIP_MARGIN_TOL
    assert rel < chip_smoke.E2E_REL_L2_TOL / 3
