"""K1 and K2 at head_dims that are no multiple of 8 (a bf16 row that is no
whole number of 16-byte pieces), and an OpenLLaMA-3B-shaped model (head_dim
100) through the serving paths, against the JAX package on the CPU.

On the card such a head_dim runs the kernel libraries whose rows are copied
in 8- or 4-byte pieces (``flash_prefill.library``, ``decode_attn.library``);
here the wrappers run their plain versions.  The JAX package runs its XLA
attention at these head_dims (its Pallas kernels take ``D % 128 == 0``):
K1's plain version is held to ``ops/attention.py::blocked_causal_attention``
and ``policies/scoring.py::window_attention_scores``, K2's to
``models/llama.py::grouped_attention`` over the appended cache.  Inputs are
fp32 numpy arrays from ``np.random.default_rng``.

Tolerances, each with its reason:

- Kernels in fp32 against XLA's fp32 with another summation order: ~1e-6
  on values of order 1, checked at 1e-5; the appended cache rows bitwise.
- Models: token streams identical, first-token logits within 1e-4 (fp32
  summation order over two layers and the lm_head, as in
  ``tests/test_torch_head_dims.py``).
"""

import torch_threads  # noqa: F401  (torch's thread share, first)
import contextlib
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.models import chunked_prefill as jchunked
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.ops.attention import blocked_causal_attention
from kvcache_factory_tpu.policies.scoring import window_attention_scores
from kvcache_factory_tpu.runtime import batching as jbatching
from kvcache_factory_tpu.runtime.generate import generate as jax_generate
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.models import chunked_prefill as tchunked
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.ops.kernels import decode_attn as tdecode
from kvcache_factory_tpu_torch.ops.kernels import flash_prefill as tflash
from kvcache_factory_tpu_torch.runtime import batching as tbatching
from kvcache_factory_tpu_torch.runtime import engine as tengine

TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
RAGGED = (2, 20, 42, 100, 110, 150, 300, 510)   # every instantiation, D % 8 of 2, 4, 6
REFUSED = (1, 99, 101, 511, 513, 515, 521, 641)  # odd: every even head_dim is taken


def t(x):
    return torch.from_numpy(np.array(x))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --- the rule -------------------------------------------------------------------

def test_head_dim_rule_instance_and_copy_width_from_1_to_520():
    """K1 and K2 take every even head_dim: up to 512 each on the narrowest
    instantiation at least as wide, copied in the widest pieces a row is a
    whole number of (16, 8 or 4 bytes), from the library built for them;
    above 512 on the wide libraries, at the head_dim's own width."""
    for D in range(1, 521):
        assert tflash.takes_head_dim(D) == (D % 2 == 0), D
        width = 16 if D % 8 == 0 else 8 if D % 4 == 0 else 4
        assert tflash.copy_bytes(D) == width
        assert D % 2 or (2 * D) % width == 0  # an even row is a whole number of pieces
        if D <= 512:
            assert tflash.instance(D) == min(w for w in tflash.INSTANCES if w >= D)
            suffix = "" if width == 16 else f"_p{width}"
            assert tflash.library(D) == "flash_prefill" + suffix
            assert tdecode.library(D) == "decode_attn" + suffix
        else:
            assert tflash.instance(D) == D
            assert tflash.library(D) == "flash_prefill_wide"
            assert tdecode.library(D) == "decode_attn_wide"


def _k1_check_args(D, offset=0):
    """K1 ``_check`` arguments at head_dim D (B 1, Hq 4, Hkv 2, S 64); q
    starts ``offset`` elements into its buffer."""
    bf = torch.bfloat16
    n = 4 * 64 * D
    q = torch.zeros(n + offset, dtype=bf)[offset:].view(1, 4, 64, D)
    return [q, torch.zeros(1, 2, 64, D, dtype=bf), torch.zeros(1, 2, 64, D, dtype=bf),
            torch.zeros(1, dtype=torch.int32), 8]


def _k2_check_args(D, offset=0, G=1):
    """K2 ``_check`` arguments at head_dim D (2 heads of G rows, C 16); the
    cache's keys start ``offset`` elements into their buffer."""
    bf = torch.bfloat16
    kc = torch.zeros(2 * 16 * D + offset, dtype=bf)[offset:].view(2, 16, D)
    return [torch.zeros(2, G, D, dtype=bf), kc, torch.zeros(2, 16, D, dtype=bf),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2, D, dtype=bf),
            torch.zeros(2, D, dtype=bf), None]


@pytest.mark.parametrize("D", REFUSED)
def test_checks_refuse_odd_head_dims_and_above_512(D):
    """What stays refused on the card: odd head_dims (RoPE needs even ones,
    in both packages), with the reason.  Head_dims above 512 are taken since
    the wide kernels (``tests/test_torch_wide_head_dims.py``)."""
    for mod, args in ((tflash, _k1_check_args(D)), (tdecode, _k2_check_args(D))):
        with pytest.raises(ValueError, match="odd head_dims") as err:
            mod._check(*args)
        assert "RoPE" in str(err.value)


@pytest.mark.parametrize("D", RAGGED)
def test_checks_take_every_ragged_head_dim(D):
    """Every shape check passes at a head_dim that is no multiple of 8 (and
    at G 4 and 12 for K2); only the device stops a CPU tensor."""
    for args in (_k1_check_args(D),):
        with pytest.raises(ValueError, match="unsupported device"):
            tflash._check(*args)
    for G in (1, 4, 12):
        with pytest.raises(ValueError, match="unsupported device"):
            tdecode._check(*_k2_check_args(D, G=G))


@pytest.mark.parametrize("D,piece", [(100, 8), (20, 8), (110, 4), (510, 4)])
def test_alignment_follows_the_copy_width(D, piece):
    """A row of 2 D bytes is aligned to its copy width, not to 16: an input
    that starts one piece into its buffer is taken, one that starts half a
    piece in is refused."""
    for mod, make in ((tflash, _k1_check_args), (tdecode, _k2_check_args)):
        with pytest.raises(ValueError, match="unsupported device"):
            mod._check(*make(D, offset=piece // 2))
        with pytest.raises(ValueError, match=f"must be {piece}-byte aligned"):
            mod._check(*make(D, offset=piece // 4))


class _StubLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("kvcf_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@contextlib.contextmanager
def _stubbed(monkeypatch, mod):
    """Let a meta tensor through ``mod``'s kernel path to a stubbed library:
    no device check, no CUDA stream or device, 132 SMs.  Yields the names
    of the libraries loaded and the stub."""
    lib, loaded = _StubLib(), []
    monkeypatch.setattr(tflash._build, "load", lambda name: loaded.append(name) or lib)
    monkeypatch.setattr(mod, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: mock.Mock(cuda_stream=0))
    yield loaded, lib


@pytest.mark.parametrize("D", [100, 110, 20, 510, 80])
def test_k1_and_k2_stubs_take_the_piece_library_and_the_true_scale(D, monkeypatch):
    """On a tensor off the CPU, K1 and K2 at head_dim D load the library of
    D's copy width, call its entry point of the narrowest instantiation at
    least as wide, with D and ``D ** -0.5``: the inputs go to the kernel as
    they are (no padded copy)."""
    width, m = tflash.instance(D), dict(dtype=torch.bfloat16, device="meta")
    monkeypatch.setattr(tflash.flash_prefill_attention, "launches", 0)
    monkeypatch.setattr(tflash.flash_prefill_attention, "variant_launches",
                        dict.fromkeys(tflash.flash_prefill_attention.variant_launches, 0))
    with _stubbed(monkeypatch, tflash) as (loaded, lib):
        q = torch.empty(1, 2, 64, D, **m)
        tflash.flash_prefill_attention(q, q, q, torch.empty(1, dtype=torch.int32,
                                                            device="meta"), 8)
    (name, args), = lib.calls
    assert loaded == [tflash.library(D)] and name == f"kvcf_flash_prefill_d{width}"
    assert args[0] == q.data_ptr() and args[-3] == D and args[-2] == D ** -0.5
    monkeypatch.setattr(tdecode.decode_attention_append, "launches", 0)
    monkeypatch.setattr(tdecode, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(tdecode, "_counters",
                        lambda dev, H: torch.zeros(H, dtype=torch.int32, device="meta"))
    with _stubbed(monkeypatch, tdecode) as (loaded, lib):
        kc = torch.empty(2, 16, D, **m)
        tdecode.decode_attention_append(
            torch.empty(2, 4, D, **m), kc, torch.empty(2, 16, D, **m),
            torch.empty(2, dtype=torch.int32, device="meta"), torch.empty(2, D, **m),
            torch.empty(2, D, **m))
    (name, args), = lib.calls
    assert loaded == [tdecode.library(D)] and name == f"kvcf_decode_attn_append_d{width}"
    assert args[1] == kc.data_ptr() and args[-3] == D and args[-2] == D ** -0.5


# --- K1 and K2's plain versions against JAX's XLA attention ---------------------

# (B, Hq, Hkv, S_q, S_k, true_len, row_offset, sliding_window, window)
K1_CASES = {
    "dense": (2, 4, 2, 160, 160, [160, 97], None, None, 8),
    "sliding_window": (1, 4, 2, 192, 192, [180], None, 40, 0),
    "chunk": (3, 4, 2, 32, 160, [160, 60, 0], [100, 37, 0], 24, 0),
}


@pytest.mark.parametrize("D", [100, 110])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_plain_matches_jax_xla(case, D):
    """K1's plain version at head_dim 100 and 110 (dense with window scores,
    sliding window, chunk) against the JAX package's XLA attention: every
    valid row, and the window scores on the scored columns."""
    B, Hq, Hkv, S_q, S_k, tls, offsets, sw, W = K1_CASES[case]
    rng = np.random.default_rng(D)
    q, k, v = normal(rng, B, Hq, S_q, D), normal(rng, B, Hkv, S_k, D), normal(rng, B, Hkv, S_k, D)
    tl = np.asarray(tls, np.int32)
    off = None if offsets is None else np.asarray(offsets, np.int32)
    out, scores = tflash.flash_prefill_attention(
        t(q), t(k), t(v), t(tl), W, sliding_window=sw,
        row_offset=None if off is None else t(off))
    out, scores = out.numpy(), scores.numpy()
    j_out = np.asarray(blocked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), sliding_window=sw,
        q_block=64, row_offset=None if off is None else jnp.asarray(off)))
    base = np.zeros(B, np.int64) if off is None else off
    valid = (base[:, None] + np.arange(S_q)[None]) < tl[:, None]
    assert np.isfinite(out).all()
    for b in range(B):
        np.testing.assert_allclose(out[b][:, valid[b]], j_out[b][:, valid[b]], **TOL)
        if W:
            j_sc = np.asarray(window_attention_scores(
                jnp.asarray(np.repeat(k[b], Hq // Hkv, axis=0)), jnp.asarray(q[b]),
                jnp.int32(tl[b]), W))
            np.testing.assert_allclose(scores[b, :, :tl[b] - W], j_sc[:, :tl[b] - W], **TOL)


# (C, G, lengths, lower): a full cache, a lower bound, G 4.
K2_CASES = {
    "g1": (48, 1, [40, 48, 1, 47], None),
    "g1-lower": (48, 1, [40, 20, 30, 47], [5, 0, 30, 46]),
    "g4": (40, 4, [3, 40, 39, 12], None),
}


@pytest.mark.parametrize("D", [100, 110])
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_plain_matches_jax_xla(case, D):
    """K2's plain version at head_dim 100 and 110 against the JAX package's
    XLA decode attention (``grouped_attention``) over the cache with the new
    token in slot ``min(len, C - 1)``: the output, and the appended cache
    bitwise."""
    C, G, lengths, lower = K2_CASES[case]
    H = 4
    rng = np.random.default_rng(D + 1)
    q, kc, vc = normal(rng, H, G, D), normal(rng, H, C, D), normal(rng, H, C, D)
    kn, vn = normal(rng, H, D), normal(rng, H, D)
    lens = np.asarray(lengths, np.int32)
    lo = None if lower is None else np.asarray(lower, np.int32)
    k_port, v_port = t(kc), t(vc)
    out = tdecode.decode_attention_append(t(q), k_port, v_port, t(lens), t(kn), t(vn),
                                          None if lo is None else t(lo)).numpy()
    L = np.minimum(lens, C - 1)
    k_app, v_app = kc.copy(), vc.copy()
    k_app[np.arange(H), L], v_app[np.arange(H), L] = kn, vn
    np.testing.assert_array_equal(k_port.numpy(), k_app)
    np.testing.assert_array_equal(v_port.numpy(), v_app)
    idx = np.arange(C)[None]
    low = np.zeros(H, np.int64) if lo is None else lo.astype(np.int64)
    keep = ((idx >= low[:, None]) & (idx < L[:, None])) | (idx == L[:, None])
    j_out = jllama.grouped_attention(
        jnp.asarray(q.reshape(1, H * G, 1, D)), jnp.asarray(k_app[None]),
        jnp.asarray(v_app[None]), jnp.asarray(keep[None, :, None]))
    np.testing.assert_allclose(out, np.asarray(j_out).reshape(H, G, D), **TOL)


# --- the slice end to end --------------------------------------------------------

# OpenLLaMA-3B v2's published config.json (openlm-research/open_llama_3b_v2):
# the fields the forward reads; it names neither num_key_value_heads nor
# rope_theta.
OPENLLAMA_3B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 32000,
    "hidden_size": 3200, "intermediate_size": 8640, "num_hidden_layers": 26,
    "num_attention_heads": 32, "max_position_embeddings": 2048, "rms_norm_eps": 1e-06,
    "tie_word_embeddings": False, "hidden_act": "silu", "bos_token_id": 1,
    "eos_token_id": 2}
# Its shape cut to size: MHA at head_dim 100, untied, rope_theta 1e4.
OPENLLAMA = dict(model_type="llama", vocab_size=512, hidden_size=400, intermediate_size=576,
                 num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                 head_dim=100, rope_theta=10000.0, rms_norm_eps=1e-6,
                 tie_word_embeddings=False, dtype="float32")
SNAPKV = dict(method="snapkv", max_capacity_prompt=48, window_size=8, kernel_size=7,
              pooling="maxpool", group_reduce="none")
BUCKET = 128
MAX_NEW = 6


def test_openllama_3b_config_has_head_dim_100_in_both_packages(tmp_path):
    """``ModelConfig.from_json`` on OpenLLaMA-3B v2's published values (a
    file under ``tmp_path``) gives head_dim 3200 / 32 = 100, MHA and
    rope_theta 1e4 in both packages."""
    path = tmp_path / "config.json"
    path.write_text(json.dumps(OPENLLAMA_3B_CONFIG))
    for mod in (jcfg, tcfg):
        c = mod.ModelConfig.from_json(str(path))
        assert (c.head_dim, c.num_key_value_heads, c.num_hidden_layers) == (100, 32, 26)
        assert (c.rope_theta, c.rms_norm_eps, c.tie_word_embeddings) == (10000.0, 1e-6, False)
    assert tflash.takes_head_dim(100) and tflash.copy_bytes(100) == 8


@pytest.fixture(scope="module")
def openllama():
    jc, tc = jcfg.ModelConfig(**OPENLLAMA), tcfg.ModelConfig(**OPENLLAMA)
    jp = jweights.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, OPENLLAMA["vocab_size"], size=n).tolist() for n in (100, 40)]
    toks = np.zeros((len(prompts), BUCKET), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, prompts=prompts, toks=toks, lens=lens)


@pytest.mark.parametrize("comp", ["snapkv", "fullkv"])
def test_openllama_shaped_engine_matches_jax(openllama, comp):
    """The tiny OpenLLaMA-shaped model (head_dim 100, MHA, untied; its
    weights carried across by ``params_from_jax``) through
    ``InferenceEngine`` against JAX's ``generate``: streams identical, cache
    lengths equal, first-token logits within 1e-4."""
    m = openllama
    comp_kw = SNAPKV if comp == "snapkv" else dict(method="fullkv")
    eng = tengine.InferenceEngine(m["tp"], tcfg.EngineConfig(
        model=m["tc"], compression=tcfg.CompressionConfig(**comp_kw),
        prefill_buckets=(BUCKET,)), device="cpu")
    ids, res = eng.generate_batch(m["prompts"], MAX_NEW, return_result=True)
    jcomp = jcfg.CompressionConfig(**comp_kw)
    cap = eng._cache_capacity(BUCKET, MAX_NEW)
    jres = jax_generate(m["jp"], m["jc"], jcomp, jcfg.GenerationConfig(max_new_tokens=MAX_NEW),
                        jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), cap)
    nums, toks = np.asarray(jres.num_tokens), np.asarray(jres.tokens)
    assert ids == [toks[i, :nums[i]].tolist() for i in range(len(ids))]
    np.testing.assert_array_equal(res.cache.lengths.numpy(), np.asarray(jres.cache.lengths))
    jpre = jllama.prefill(m["jp"], m["jc"], jcomp, jnp.asarray(m["toks"]),
                          jnp.asarray(m["lens"]), cap)
    np.testing.assert_allclose(res.logits[:, 0].numpy(), np.asarray(jpre.logits_last),
                               **LOGITS_TOL)


def test_openllama_shaped_chunked_prefill_matches_jax(openllama):
    """Chunked prefill (32-token chunks, snapkv) of the tiny OpenLLaMA-shaped
    model against JAX's ``prefill_chunked``: logits within 1e-4, cache
    lengths equal, every valid cache entry within 1e-4."""
    m = openllama
    cap = 80
    got = tchunked.prefill_chunked(m["tp"], m["tc"], tcfg.CompressionConfig(**SNAPKV),
                                   torch.tensor(m["toks"]), torch.tensor(m["lens"]), cap, 32)
    want = jchunked.prefill_chunked(m["jp"], m["jc"], jcfg.CompressionConfig(**SNAPKV),
                                    jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), cap, 32)
    np.testing.assert_allclose(got.logits_last.numpy(), np.asarray(want.logits_last),
                               **LOGITS_TOL)
    lens = np.asarray(want.cache.lengths)
    np.testing.assert_array_equal(got.cache.lengths.numpy(), lens)
    want_k, want_v = np.asarray(want.cache.k), np.asarray(want.cache.v)
    for li, b, h in np.ndindex(*lens.shape):
        n = lens[li, b, h]
        np.testing.assert_allclose(got.cache.k[li, b, h, :n].numpy(), want_k[li, b, h, :n],
                                   **LOGITS_TOL)
        np.testing.assert_allclose(got.cache.v[li, b, h, :n].numpy(), want_v[li, b, h, :n],
                                   **LOGITS_TOL)


def test_openllama_shaped_batching_engine_matches_jax(openllama):
    """Three requests through two slots of ``ContinuousBatchingEngine`` with
    32-token chunked admission (a slot refills mid-drain): the port's
    streams equal the JAX engine's."""
    m = openllama
    prompts = m["prompts"] + [np.random.default_rng(9).integers(
        0, OPENLLAMA["vocab_size"], size=70).tolist()]
    max_new = [MAX_NEW, 3, 4]
    kw = dict(n_slots=2, max_new_cap=MAX_NEW, chunk_size=4, prefill_chunk_tokens=32)
    eng = tbatching.ContinuousBatchingEngine(m["tp"], tcfg.EngineConfig(
        model=m["tc"], compression=tcfg.CompressionConfig(**SNAPKV),
        prefill_buckets=(BUCKET,)), device="cpu", **kw)
    rids = [eng.submit(p, n) for p, n in zip(prompts, max_new)]
    out = eng.run()
    jeng = jbatching.ContinuousBatchingEngine(m["jp"], jcfg.EngineConfig(
        model=m["jc"], compression=jcfg.CompressionConfig(**SNAPKV),
        prefill_buckets=(BUCKET,)), **kw)
    jrids = [jeng.submit(p, n) for p, n in zip(prompts, max_new)]
    jout = jeng.run()
    assert [out[r] for r in rids] == [jout[r] for r in jrids]
    assert [len(out[r]) for r in rids] == max_new
    assert eng.prefill_chunks_executed == jeng.prefill_chunks_executed


# --- chip_smoke.py's library yardstick -------------------------------------------

@pytest.mark.parametrize("keys,backend", [
    (["spin_kernel", "pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>"], "flash"),
    (["spin_kernel", "fmha_cutlassF_bf16_aligned_64x64_rf_sm80"], "memory-efficient"),
    (["spin_kernel", "cudnn_generated_fort_native_sdpa_sm90"], "cuDNN"),
    (["spin_kernel", "ampere_bf16_s16816gemm_bf16_128x64", "softmax_warp_forward"], "math"),
    (["spin_kernel"], "not measured"),
])
def test_sdpa_backend_reads_names_past_the_burst(keys, backend, monkeypatch):
    """``chip_smoke.sdpa_backend`` names the backend from the call's kernel
    records after the profiler burst (whose spin kernels it skips), and a
    window holding no record of the call is "not measured", not "math"
    (late in the script the profiler lost the call's few records)."""
    import chip_smoke

    class Window:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [mock.Mock(key=k, device_type=chip_smoke.DeviceType.CUDA) for k in keys]

    burst = []
    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    monkeypatch.setattr(chip_smoke, "profile_burst", lambda: burst.append(1))
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Window())
    assert chip_smoke.sdpa_backend(lambda: None) == backend
    assert burst == [1]
