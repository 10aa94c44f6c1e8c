"""K2-K4 at group sizes above 8 and K1 at observation windows above 64, and
a Mistral-Large-shaped model that runs them, against the JAX package on the
CPU.

The Pallas kernels run in interpret mode, as ``tests/test_torch_kernels.py``
and ``tests/test_torch_quant_decode.py`` run them; the JAX quantized cache
is carried across with ``quant_cache_from_jax``.  Inputs are fp32 numpy
arrays from ``np.random.default_rng``.

Tolerances, each with its reason:

- K1 and K2 in fp32 against fp32 with another summation order: ~1e-6 on
  values of order 1, checked at 2e-5 (the JAX kernel tests' own).
- K3 and K4 against the TPU kernels: as ``tests/test_torch_quant_decode.py``
  (K3 1e-5; K4 2^-9 of the value span, for the TPU K4's bf16 weights); the
  appended bytes equal.
- The model: token streams identical, first-token logits within 1e-4 (fp32
  summation order over two layers and the lm_head, as in
  ``tests/test_torch_generate.py``).
"""

import torch_threads  # noqa: F401  (torch's thread share, first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.cache import quant_cache as jq
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.ops.kernels import decode_attn as jdecode
from kvcache_factory_tpu.ops.kernels import decode_attn_quant as jdq
from kvcache_factory_tpu.ops.kernels import flash_prefill as jflash
from kvcache_factory_tpu.runtime.generate import generate as jax_generate
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.cache import quant_cache as tq
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.ops.kernels import decode_attn as tdecode
from kvcache_factory_tpu_torch.ops.kernels import decode_attn_quant as tdq
from kvcache_factory_tpu_torch.ops.kernels import flash_prefill as tflash
from kvcache_factory_tpu_torch.runtime import engine as tengine

D = 128
TOL = dict(rtol=2e-5, atol=2e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --- K1 at windows above 64 ------------------------------------------------------


@pytest.fixture(scope="module")
def k1_inputs():
    """B 2, Hq 4 / Hkv 2, S 384, true_len (300, 260): the windows' rows
    [300 - W, 300) and [260 - W, 260) cross the 128-row edge at 256."""
    rng = np.random.default_rng(61)
    B, Hq, Hkv, S = 2, 4, 2, 384
    return (normal(rng, B, Hq, S, D), normal(rng, B, Hkv, S, D), normal(rng, B, Hkv, S, D),
            np.asarray([300, 260], np.int32))


@pytest.mark.parametrize("W", [96, 128])
def test_k1_windows_above_64_plain_matches_pallas(k1_inputs, W):
    """K1's plain version at windows 96 and 128 against the Pallas kernel in
    interpret mode: the output on every valid row and the window scores on
    the scored columns."""
    q, k, v, tl = k1_inputs
    out, scores = tflash.flash_prefill_attention(t(q), t(k), t(v), t(tl), W)
    j_out, j_sc = jflash.flash_prefill_attention_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), W, q_block=128,
        kv_block=128, interpret=True)
    j_out, j_sc = np.asarray(j_out), np.asarray(j_sc)
    for b, n in enumerate(tl):
        np.testing.assert_allclose(out[b, :, :n].numpy(), j_out[b, :, :n], **TOL)
        np.testing.assert_allclose(scores[b, :, :n - W].numpy(), j_sc[b, :, :n - W], **TOL)


# The shapes the window-score pass's partition stresses (a CTA per 64-key
# tile and KV head, the group's heads in chunks of round_up(W, 8) rows):
# (Hq, S, W, true_len) at one KV head, so G = Hq.
SCORE_PASS_CASES = {
    "g12_w40": (12, 128, 40, [128, 97]),       # 3 heads of 40 rows a 128-row block
    "g16_w1": (16, 128, 1, [128, 1]),          # 16 one-row chunks; true_len 1
    "g4_w72_short": (4, 256, 72, [60, 200]),   # true_len below the window
}


@pytest.mark.parametrize("case", sorted(SCORE_PASS_CASES))
def test_k1_score_pass_shapes_plain_matches_pallas(case):
    """K1's plain version, window scores included, against the Pallas kernel
    in interpret mode at the shapes of ``SCORE_PASS_CASES`` (B 2, one KV
    head): the output on every valid row and the scores on every column
    below true_len (the scored ones and the window's own)."""
    Hq, S, W, tls = SCORE_PASS_CASES[case]
    rng = np.random.default_rng(71)
    q, k, v = normal(rng, 2, Hq, S, D), normal(rng, 2, 1, S, D), normal(rng, 2, 1, S, D)
    tl = np.asarray(tls, np.int32)
    out, scores = tflash.flash_prefill_attention(t(q), t(k), t(v), t(tl), W)
    j_out, j_sc = jflash.flash_prefill_attention_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), W, q_block=128,
        kv_block=128, interpret=True)
    j_out, j_sc = np.asarray(j_out), np.asarray(j_sc)
    for b, n in enumerate(tls):
        np.testing.assert_allclose(out[b, :, :n].numpy(), j_out[b, :, :n], **TOL)
        np.testing.assert_allclose(scores[b, :, :n].numpy(), j_sc[b, :, :n], **TOL)


@pytest.mark.parametrize("case", sorted(SCORE_PASS_CASES) + ["ashape_w8"])
def test_window_scores_plain_version_matches_k1_plain_scores(case):
    """The score pass's plain version (``window_scores_reference``), given
    each row's (m, l) from K1's plain version with ``return_ml``, against
    the scores K1's plain version emits: the same function (an a-shape
    block mask of 64-row blocks too)."""
    Hq, S, W, tls = SCORE_PASS_CASES.get(case, (4, 256, 8, [250, 131]))
    rng = np.random.default_rng(73)
    q, k, v = (t(normal(rng, 2, h, S, D)) for h in (Hq, 1, 1))
    tl = torch.tensor(tls, dtype=torch.int32)
    mask, block = (None, 0) if case != "ashape_w8" else \
        tflash.sparse_block_mask(q, k, tl, ("ashape", 1, 1, 2), q_block=64)
    kw = dict(block_mask=mask, block=block)
    _, scores = tflash.flash_prefill_attention_reference(q, k, v, tl, W, **kw)
    _, _, m, l = tflash.flash_prefill_attention_reference(q, k, v, tl, 0, return_ml=True, **kw)
    got = tflash.window_scores_reference(q, k, tl, W, m, l, **kw)
    np.testing.assert_allclose(got.numpy(), scores.numpy(), **TOL)


# --- K2 at G above 8 ---------------------------------------------------------------


@pytest.mark.parametrize("G,lengths,lower", [
    (12, [200, 256], [0, 37]),   # a lower bound, a full head (the clamp to C-1)
    (16, [0, 131], None),        # an empty head
])
def test_k2_groups_above_8_plain_matches_pallas(G, lengths, lower):
    """K2's plain version at G 12 and 16 (H 2, C 256) against the Pallas
    ``_decode_kernel`` in interpret mode (its block is (1, G, D)): the
    output, the appended cache and the lengths."""
    H, C = 2, 256
    rng = np.random.default_rng(67)
    q, kc, vc = normal(rng, H, G, D), normal(rng, H, C, D), normal(rng, H, C, D)
    kn, vn = normal(rng, H, D), normal(rng, H, D)
    lens = np.asarray(lengths, np.int32)
    lo = None if lower is None else np.asarray(lower, np.int32)
    k_port, v_port = t(kc), t(vc)
    out = tdecode.decode_attention_append(t(q), k_port, v_port, t(lens), t(kn), t(vn),
                                          None if lo is None else t(lo))
    j_out, j_k, j_v, j_lens = jdecode.decode_attention_append(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        jnp.asarray(kn), jnp.asarray(vn), interpret=True,
        lower=None if lo is None else jnp.asarray(lo))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_array_equal(k_port.numpy(), np.asarray(j_k))
    np.testing.assert_array_equal(v_port.numpy(), np.asarray(j_v))
    np.testing.assert_array_equal(np.minimum(lens + 1, C), np.asarray(j_lens))


# --- K3 and K4 at G above 8 --------------------------------------------------------

JAX_PREFILL = {8: jq.from_packed_prefill_tpu, 4: jq.from_packed_prefill_tpu4}
JAX_KERNEL = {8: jdq.quant_decode_attention_append_stacked,
              4: jdq.quant4_decode_attention_append_stacked}
PORT_KERNEL = {8: tdq.quant_decode_attention_append, 4: tdq.quant4_decode_attention_append}


def _carried(arrays, nbits):
    kc, vc, sc = arrays
    H = kc.shape[1]
    c = tq.quant_cache_from_jax(np.asarray(kc)[None], np.asarray(vc)[None],
                                np.asarray(sc)[None], np.zeros((1, 1, H)), np.zeros(1), nbits)
    return c.k_codes[0, 0], c.v_codes[0, 0], c.scales[0, 0]


@pytest.fixture(scope="module")
def kq_caches():
    """One JAX-built cache a code width (H 2, C 256, D 128), with the new
    token's K/V."""
    H, C = 2, 256
    rng = np.random.default_rng(71)
    k_fp, v_fp = normal(rng, H, C, D), 3.0 * normal(rng, H, C, D)
    kn, vn = normal(rng, H, D), 3.0 * normal(rng, H, D)
    out = {}
    for nbits in (8, 4):
        jc = JAX_PREFILL[nbits](jnp.asarray(k_fp)[None, None], jnp.asarray(v_fp)[None, None],
                                jnp.zeros((1, 1, H), jnp.int32), jnp.zeros((1,), jnp.int32))
        out[nbits] = (jc, kn, vn)
    return out


@pytest.mark.parametrize("G", [12, 16])
@pytest.mark.parametrize("nbits", [8, 4])
def test_kq_groups_above_8_plain_matches_pallas(kq_caches, nbits, G):
    """K3's and K4's plain versions at G 12 and 16 against the JAX kernels in
    interpret mode over one cache carried across (``quant_cache_from_jax``):
    the output, and the appended codes and scalars byte for byte."""
    jc, kn, vn = kq_caches[nbits]
    H, C = 2, 256
    rng = np.random.default_rng(73 + G)
    q = torch.from_numpy(normal(rng, H, G, D)).to(torch.bfloat16).float().numpy()
    lens, lo = np.asarray([200, 256], np.int32), np.asarray([0, 37], np.int32)
    arrays = (jc.k_codes[0], jc.v_codes[0], jc.scales[0])
    kc, vc, sc = _carried(arrays, nbits)
    out = PORT_KERNEL[nbits](t(q), kc, vc, sc, t(lens), t(kn), t(vn), t(lo)).numpy()
    j_out, j_kc, j_vc, j_sc, j_lens = JAX_KERNEL[nbits](
        jnp.asarray(q), *arrays, jnp.asarray(lens), jnp.zeros((1,), jnp.int32),
        jnp.asarray(kn), jnp.asarray(vn), interpret=True, lower=jnp.asarray(lo))
    if nbits == 8:
        atol = 1e-5
    else:
        _, v_deq = (np.asarray(a)[0, 0] for a in tq.dequantize_kv(
            tq.quant_cache_from_jax(*(np.asarray(a) for a in jc), nbits=nbits)))
        atol = 2.0 ** -9 * (v_deq.max(-1) - v_deq.min(-1)).max()
    np.testing.assert_allclose(out, np.asarray(j_out), rtol=0, atol=atol)
    for got, want in zip((kc, vc, sc), _carried((j_kc, j_vc, j_sc), nbits)):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(np.minimum(lens + 1, C), np.asarray(j_lens))


# --- the slice end to end ----------------------------------------------------------

# Mistral-Large-Instruct-2407's shape cut to size: G 12 (its 96 / 8 heads as
# 24 / 2), rope_theta 1e6, no sliding window, untied embeddings.
MISTRAL_LARGE = dict(model_type="mistral", vocab_size=512, hidden_size=256,
                     intermediate_size=512, num_hidden_layers=2, num_attention_heads=24,
                     num_key_value_heads=2, head_dim=32, rope_theta=1000000.0, dtype="float32")
SNAPKV = dict(method="snapkv", max_capacity_prompt=64, window_size=8, kernel_size=7,
              pooling="maxpool")
RUNS = {"fullkv": dict(method="fullkv"),
        "snapkv_mean": dict(SNAPKV, group_reduce="mean"),
        "snapkv_w96": dict(SNAPKV, max_capacity_prompt=128, window_size=96)}
BUCKET = 256
MAX_NEW = 6


@pytest.fixture(scope="module")
def mistral_large():
    jc, tc = jcfg.ModelConfig(**MISTRAL_LARGE), tcfg.ModelConfig(**MISTRAL_LARGE)
    jp = jweights.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MISTRAL_LARGE["vocab_size"], size=n).tolist() for n in (200, 40)]
    toks = np.zeros((len(prompts), BUCKET), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, prompts=prompts, toks=toks, lens=lens)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_mistral_large_shaped_engine_matches_jax(mistral_large, run):
    """A tiny Mistral-Large-shaped model (G 12) through the port's
    ``InferenceEngine`` against JAX's ``generate``: fullkv and snapkv with
    ``group_reduce="mean"`` decode over the KV heads (K2 at G 12), snapkv
    with a 96-row window scores with K1 at W 96.  Streams identical, cache
    lengths equal, first-token logits within 1e-4."""
    m = mistral_large
    kw = RUNS[run]
    eng = tengine.InferenceEngine(m["tp"], tcfg.EngineConfig(
        model=m["tc"], compression=tcfg.CompressionConfig(**kw), prefill_buckets=(BUCKET,)),
        device="cpu")
    ids, res = eng.generate_batch(m["prompts"], MAX_NEW, return_result=True)
    heads = res.cache.lengths.shape[-1]
    assert heads == (24 if run == "snapkv_w96" else 2)
    jcomp = jcfg.CompressionConfig(**kw)
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
