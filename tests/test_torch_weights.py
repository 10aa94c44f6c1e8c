"""HF checkpoints and W8A16 weights in the port, against the JAX package and
against HF transformers, on the CPU.

Loader: ``runtime/native.py::SafetensorsFile`` on files written by
``save_pretrained`` under ``tmp_path`` equals ``safetensors``' own read
(bf16 included), with the native reader and with its Python twin; the
port's ``load_params(dtype=fp32)`` leaves are bitwise equal to JAX's
``load_params`` on the same directory, sharded (``model.safetensors.index
.json``) or not.  HF parity (as ``tests/test_model_parity.py``): prefill
logits within rtol/atol 2e-4 (fp32, summation order) for tiny Llama,
Mistral with a sliding window, Qwen2 (``qkv_bias``), Llama with
``attention_bias`` + ``mlp_bias`` and llama3 rope scaling; greedy streams
equal the greedy stream of HF's forward (each token the argmax of HF's
full forward over the prompt and the tokens before it: HF's ``generate``
takes its cached path, which here disagrees with its own forward by up to
1e-3 in a logit and flips near-ties), and teacher-forced decode logits
within 2e-4 of that forward.  W8A16: ``q`` and ``s``
bitwise equal to JAX's ``quantize_weights``; the snapped-weights forward
within 1e-5 of the fp forward; prefill and decode logits within 1e-5 of
JAX's on the same quantized tree; engine streams equal JAX's.
"""

import dataclasses
import json
import os

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
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.models import llama as tllama
from kvcache_factory_tpu_torch.models import weights as tweights
from kvcache_factory_tpu_torch.models.reference import forward_logits
from kvcache_factory_tpu_torch.runtime import batching as tbatching
from kvcache_factory_tpu_torch.runtime import engine as tengine
from kvcache_factory_tpu_torch.runtime import generate as tgenerate
from kvcache_factory_tpu_torch.runtime import native

HF_TOL = dict(rtol=2e-4, atol=2e-4)
QUANT_TOL = dict(rtol=1e-5, atol=1e-5)
FULL = tcfg.CompressionConfig(method="fullkv")
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
            rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False)


def tiny_hf(family, seed=0):
    """A tiny random HF model of ``family`` (biases drawn, where it has
    them: HF initialises them to zero) and the port's config for it."""
    import transformers as tf
    torch.manual_seed(seed)
    if family == "llama":
        model = tf.LlamaForCausalLM(tf.LlamaConfig(**TINY))
    elif family == "mistral_sw":
        model = tf.MistralForCausalLM(tf.MistralConfig(**TINY, sliding_window=16))
    elif family == "qwen2":
        model = tf.Qwen2ForCausalLM(tf.Qwen2Config(**TINY))
    elif family == "llama_bias":
        model = tf.LlamaForCausalLM(tf.LlamaConfig(**TINY, attention_bias=True, mlp_bias=True))
    elif family == "llama3_rope":
        model = tf.LlamaForCausalLM(tf.LlamaConfig(**dict(TINY, num_hidden_layers=2), rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 64}))
    else:
        raise ValueError(family)
    model.eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0.0, 0.5)
    cfg = dataclasses.replace(tcfg.ModelConfig.from_hf_config(model.config), dtype="float32")
    return model, cfg


FAMILIES = ["llama", "mistral_sw", "qwen2", "llama_bias", "llama3_rope"]
BIASES = {"llama": (), "mistral_sw": (), "qwen2": ("qkv_bias",), "llama3_rope": (),
          "llama_bias": ("qkv_bias", "o_bias", "gate_up_bias", "down_bias")}


@pytest.fixture(scope="module")
def hf_models():
    return {f: tiny_hf(f, seed=i) for i, f in enumerate(FAMILIES)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------


def twin_only(monkeypatch):
    """Make the native reader unavailable, as on a machine without g++:
    the Python twin serves."""
    monkeypatch.setattr(native, "_st_lib", False)


@pytest.mark.parametrize("use_native", [True, False])
def test_safetensors_file_matches_safetensors(tmp_path, monkeypatch, use_native):
    from safetensors.torch import load_file
    if not use_native:
        twin_only(monkeypatch)
    model, _ = tiny_hf("qwen2")
    model.to(torch.bfloat16).save_pretrained(tmp_path, max_shard_size="40KB")
    shards = sorted(f for f in os.listdir(tmp_path) if f.endswith(".safetensors"))
    assert len(shards) > 1 and (tmp_path / "model.safetensors.index.json").exists()
    extra = {"f32": torch.randn(3, 5), "i8": torch.arange(-4, 4, dtype=torch.int8),
             "i64": torch.arange(6).reshape(2, 3), "empty": torch.zeros(0, 4),
             "flags": torch.tensor([True, False, True])}
    from safetensors.torch import save_file
    save_file(extra, tmp_path / "extra.safetensors")
    before = dict(native.SafetensorsFile.bytes_read)
    n = 0
    for shard in shards + ["extra.safetensors"]:
        want = load_file(tmp_path / shard)
        with native.SafetensorsFile(str(tmp_path / shard)) as f:
            assert f.reader == ("native" if use_native else "python")
            assert sorted(f.keys()) == sorted(want)
            for name, t in want.items():
                got = f.tensor(name)
                assert got.dtype == t.dtype and got.shape == t.shape, name
                assert torch.equal(got.view(torch.uint8), t.contiguous().view(torch.uint8)), name
                n += t.numel() * t.element_size()
    reader = "native" if use_native else "python"
    assert native.SafetensorsFile.bytes_read[reader] - before[reader] == n


def test_safetensors_reader_builds_into_build_dir_never_csrc():
    assert native._st() is not None
    lib = native._lib_path(native.ST_SOURCE)
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert lib.name.startswith("libkvcf_st-")
    assert not (native.ST_SOURCE.parent / lib.name).exists()


@pytest.mark.parametrize("use_native", [True, False])
def test_safetensors_file_refuses_a_truncated_file(tmp_path, monkeypatch, use_native):
    if not use_native:
        twin_only(monkeypatch)
    path = tmp_path / "bad.safetensors"
    path.write_bytes((1000).to_bytes(8, "little") + b"{}")
    with pytest.raises(OSError, match="header length"):
        native.SafetensorsFile(str(path))


@pytest.mark.parametrize("family,shard", [("qwen2", "40KB"), ("llama_bias", None),
                                          ("llama", "60KB")])
def test_load_params_matches_jax(tmp_path, monkeypatch, family, shard):
    """bf16 on disk, both loaders to fp32: every leaf bitwise equal, with
    the native reader and its twin; the config read from config.json
    equal field for field."""
    model, _ = tiny_hf(family)
    kw = {"max_shard_size": shard} if shard else {}
    model.to(torch.bfloat16).save_pretrained(tmp_path, **kw)
    assert (tmp_path / "model.safetensors.index.json").exists() == bool(shard)
    jp, jc = jweights.load_params(str(tmp_path), dtype=jnp.float32)
    tc = tcfg.ModelConfig.from_json(str(tmp_path / "config.json"))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    want = dict(_leaves(jax.tree.map(np.asarray, jp)))
    assert set(want) >= {f"layers.{b}" for b in BIASES[family]}
    for reader in ("native", "python"):
        if reader == "python":
            twin_only(monkeypatch)
        before = native.SafetensorsFile.bytes_read[reader]
        tp, cfg = tweights.load_params(str(tmp_path), dtype=torch.float32, device="cpu")
        assert native.SafetensorsFile.bytes_read[reader] > before
        got = dict(_leaves(tp))
        assert sorted(got) == sorted(want)
        for name, arr in want.items():
            assert got[name].dtype == torch.float32, name
            np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)


def test_tied_embeddings_and_moe_refusal():
    model, cfg = tiny_hf("llama")
    state = {k: v for k, v in model.state_dict().items() if k != "lm_head.weight"}
    tp = tweights.params_from_state_dict(cfg, state, torch.float32, device="cpu")
    assert torch.equal(tp["lm_head"], tp["embed"].T)
    with pytest.raises(NotImplementedError, match="1.9"):
        tweights.params_from_state_dict(dataclasses.replace(cfg, num_local_experts=4),
                                        model.state_dict(), device="cpu")


# ---------------------------------------------------------------------------
# HF parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_logits_match_hf(hf_models, family):
    """The fp32 reference forward at every position, and the port's prefill
    (K1's plain version) at each row's last token, against HF's forward."""
    model, cfg = hf_models[family]
    tp = tweights.params_from_state_dict(cfg, model.state_dict(), torch.float32, device="cpu")
    assert all(b in tp["layers"] for b in BIASES[family])
    S = 96 if family == "llama3_rope" else 48  # past original_max (64) for llama3
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, S))
    with torch.no_grad():
        hf = model(torch.tensor(toks)).logits.numpy()
    np.testing.assert_allclose(forward_logits(tp, cfg, torch.tensor(toks)).numpy(), hf,
                               **HF_TOL)
    lens = np.array([S, S - 11], np.int32)
    pre = tllama.prefill(tp, cfg, FULL, torch.tensor(toks), torch.tensor(lens), S)
    np.testing.assert_allclose(pre.logits_last.numpy(), hf[[0, 1], lens - 1], **HF_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_streams_match_hf(hf_models, family):
    model, cfg = hf_models[family]
    tp = tweights.params_from_state_dict(cfg, model.state_dict(), torch.float32, device="cpu")
    S, new = 40, 8
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(1, S))
    seq = torch.tensor(toks)
    with torch.no_grad():
        for _ in range(new):
            nxt = model(seq).logits[:, -1].argmax(-1, keepdim=True)
            seq = torch.cat([seq, nxt], dim=1)
        hf = model(seq).logits.numpy()[0]
    res = tgenerate.generate(tp, cfg, FULL, tcfg.GenerationConfig(max_new_tokens=new),
                             toks, [S], S + new, device="cpu", return_logits=True)
    np.testing.assert_array_equal(res.tokens[0].numpy(), seq[0, S:].numpy())
    np.testing.assert_allclose(res.logits[0].numpy(), hf[S - 1:S + new - 1], **HF_TOL)


# ---------------------------------------------------------------------------
# W8A16
# ---------------------------------------------------------------------------

QMODEL = dict(model_type="llama", vocab_size=96, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              max_position_embeddings=256, dtype="float32")
QCOMP = dict(method="snapkv", max_capacity_prompt=24, window_size=8, kernel_size=7,
             pooling="maxpool")


@pytest.fixture(scope="module")
def qmodel():
    jc, tc = jcfg.ModelConfig(**QMODEL), tcfg.ModelConfig(**QMODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(2), dtype=jnp.float32)
    # Qwen2-style q/k/v biases, so the quantized forward carries one.
    qkv_w = jp["layers"]["qkv_proj"].shape[-1]
    jp["layers"]["qkv_bias"] = 0.3 * jax.random.normal(jax.random.PRNGKey(3),
                                                       (QMODEL["num_hidden_layers"], qkv_w))
    jq = jweights.quantize_weights(jp)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, QMODEL["vocab_size"], size=n).tolist() for n in (48, 37)]
    return dict(jc=jc, tc=tc, jp=jp, jq=jq, prompts=prompts,
                tp=tweights.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
                tq_from_jax=tweights.params_from_jax(jax.tree.map(np.asarray, jq),
                                                     device="cpu"))


@pytest.mark.parametrize("skip", [(), ("lm_head",), ("gate_up_proj", "o_proj")])
def test_quantize_weights_matches_jax(qmodel, skip):
    m = qmodel
    want = dict(_leaves(jax.tree.map(np.asarray, jweights.quantize_weights(m["jp"], skip=skip))))
    got = dict(_leaves(tweights.quantize_weights(m["tp"], skip=skip)))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == {np.dtype(np.int8): torch.int8,
                                   np.dtype(np.float32): torch.float32}[arr.dtype], name
        np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)
    for k in skip:
        assert not isinstance(got.get(k, m["tp"]["layers"].get(k)), dict)
    # The repaired params_from_jax carries JAX's quantized tree exactly.
    for name, t in _leaves(m["tq_from_jax"]):
        if name.endswith(".q"):
            assert t.dtype == torch.int8, name


def test_quantize_weights_rounds_half_to_even_and_clips():
    """A column whose max is 127 units: q = w / s rounded half to even,
    within +-127; s bf16-exact."""
    w = torch.tensor([[127.0, 0.5, 1.5], [2.5, -3.5, 254.0]])  # [in 2, out 3]
    qw = tweights._quantize_matrix(w)
    s = qw["s"]
    assert torch.equal(s, s.to(torch.bfloat16).float())
    want = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    assert torch.equal(qw["q"], want)
    assert qw["q"][0, 0] == 127 and qw["q"][1, 0] == 2  # 2.5 rounds to 2


def dequant_tree(params):
    """Every {"q", "s"} leaf folded back to a dense fp32 matrix."""
    def deq(x):
        return x["q"].float() * x["s"] if isinstance(x, dict) else x
    return {**params, "lm_head": deq(params["lm_head"]),
            "layers": {k: deq(v) for k, v in params["layers"].items()}}


def test_snapped_weights_forward_is_exact(qmodel):
    """Weights already on the int8 grid quantize losslessly, so the W8A16
    forward equals the fp forward on them up to the post-dot scale's
    rounding (JAX ``test_weight_quant.py:61-89``)."""
    m = qmodel
    snapped = dequant_tree(tweights.quantize_weights(m["tp"]))
    qp = tweights.quantize_weights(snapped)
    for k in tweights.WEIGHT_QUANT_KEYS:
        assert torch.equal(qp["layers"][k]["q"],
                           tweights.quantize_weights(m["tp"])["layers"][k]["q"])
    toks = torch.tensor(np.random.default_rng(1).integers(0, QMODEL["vocab_size"], (2, 48)))
    tl = torch.tensor([48, 37])
    comp = tcfg.CompressionConfig(**QCOMP)
    pre_f = tllama.prefill(snapped, m["tc"], comp, toks, tl, 64)
    pre_q = tllama.prefill(qp, m["tc"], comp, toks, tl, 64)
    np.testing.assert_allclose(pre_q.logits_last.numpy(), pre_f.logits_last.numpy(),
                               **QUANT_TOL)
    tok = pre_f.logits_last.argmax(-1)
    lg_f, _ = tllama.decode_step(snapped, m["tc"], tok, pre_f.cache)
    lg_q, _ = tllama.decode_step(qp, m["tc"], tok, pre_q.cache)
    np.testing.assert_allclose(lg_q.numpy(), lg_f.numpy(), **QUANT_TOL)


@pytest.mark.parametrize("source", ["jax_tree", "port_quantized"])
def test_quantized_logits_match_jax(qmodel, source):
    """JAX's quantized tree carried across by ``params_from_jax``, and the
    port's own ``quantize_weights`` of the fp tree: prefill and three
    teacher-forced decode steps within 1e-5 of JAX's."""
    m = qmodel
    tq = m["tq_from_jax"] if source == "jax_tree" else tweights.quantize_weights(m["tp"])
    toks = np.zeros((2, 64), np.int32)
    for i, p in enumerate(m["prompts"]):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in m["prompts"]], np.int32)
    jcomp, tcomp = jcfg.CompressionConfig(**QCOMP), tcfg.CompressionConfig(**QCOMP)
    jpre = jllama.prefill(m["jq"], m["jc"], jcomp, jnp.asarray(toks), jnp.asarray(lens), 40)
    tpre = tllama.prefill(tq, m["tc"], tcomp, torch.tensor(toks), torch.tensor(lens), 40)
    np.testing.assert_allclose(tpre.logits_last.numpy(), np.asarray(jpre.logits_last),
                               **QUANT_TOL)
    jcache, tcache = jpre.cache, tpre.cache
    for step in range(3):
        tok = np.array([(7 * step + 3) % 96, (5 * step + 11) % 96], np.int32)
        jl, jcache = jllama.decode_step(m["jq"], m["jc"], jnp.asarray(tok), jcache)
        tl_, tcache = tllama.decode_step(tq, m["tc"], torch.tensor(tok), tcache)
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **QUANT_TOL)


def test_quantized_engines_match_jax(qmodel):
    """``InferenceEngine`` and the chunked-admission
    ``ContinuousBatchingEngine`` on the quantized tree: streams equal JAX's
    engines'."""
    m = qmodel
    comp_j, comp_t = jcfg.CompressionConfig(**QCOMP), tcfg.CompressionConfig(**QCOMP)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, QMODEL["vocab_size"], size=s).tolist() for s in (40, 90, 120)]
    jeng = jengine.InferenceEngine(m["jq"], jcfg.EngineConfig(
        model=m["jc"], compression=comp_j, prefill_buckets=(64, 128)))
    teng = tengine.InferenceEngine(m["tq_from_jax"], tcfg.EngineConfig(
        model=m["tc"], compression=comp_t, prefill_buckets=(64, 128)), device="cpu")
    assert [teng.generate_ids(p, 5) for p in prompts] == \
        [jeng.generate_ids(p, 5) for p in prompts]
    jb = jbatching.ContinuousBatchingEngine(m["jq"], jcfg.EngineConfig(
        model=m["jc"], compression=comp_j, prefill_buckets=(64, 128)), n_slots=2,
        max_new_cap=5, prefill_chunk_tokens=32)
    tb = tbatching.ContinuousBatchingEngine(m["tq_from_jax"], tcfg.EngineConfig(
        model=m["tc"], compression=comp_t, prefill_buckets=(64, 128)), n_slots=2,
        max_new_cap=5, prefill_chunk_tokens=32, device="cpu")
    rj, rt = [jb.submit(p, 5) for p in prompts], [tb.submit(p, 5) for p in prompts]
    out_j, out_t = jb.run(), tb.run()
    assert [out_t[r] for r in rt] == [out_j[r] for r in rj]


def test_quantize_weights_errors(qmodel):
    tp = qmodel["tp"]
    with pytest.raises(NotImplementedError, match="nbits=8"):
        tweights.quantize_weights(tp, nbits=4)
    with pytest.raises(ValueError, match="not quantizable"):
        tweights.quantize_weights(tp, skip=("embed",))
    with pytest.raises(ValueError, match="already weight-quantized"):
        tweights.quantize_weights(tweights.quantize_weights(tp))
    # Skipping every matrix quantizes nothing, which quantizing again accepts.
    every = ("lm_head",) + tweights.WEIGHT_QUANT_KEYS
    fp = tweights.quantize_weights(tp, skip=every)
    assert not any(isinstance(v, dict) for v in fp["layers"].values())
    assert json.dumps(sorted(fp["layers"])) == json.dumps(sorted(tp["layers"]))
