"""K1-K4 at head_dims above 512 and a model that runs them (4 query heads and
1 KV head of 1024, Meta-Llama-3-8B-Instruct's attention regrouped), against
the JAX package on the CPU.

On the card these head_dims run the wide kernels (``csrc/flash_prefill_wide.cu``,
``csrc/decode_attn_wide.cu``, ``csrc/decode_attn_quant_cluster.cu``), whose
CTAs each own one column slice of the output (K1 and K3 up to 2048 as one
thread-block cluster of them); here the wrappers run their plain versions.  At D % 128 == 0 (640,
1024) the Pallas kernels run in interpret mode, as
``tests/test_torch_head_dims.py`` runs them at 384 and 512; at 514 and 1004
the JAX package serves on its XLA path, and the plain versions are held to
``ops/attention.py::blocked_causal_attention``,
``policies/scoring.py::window_attention_scores`` and
``models/llama.py::grouped_attention``.  A stubbed library checks what the
wrappers hand the wide kernels: the library, the entry point, the column
slices (and the cluster they form), the head_dim and ``1/sqrt(D)``.  Inputs are fp32 numpy arrays from
``np.random.default_rng``.

Tolerances, each with its reason:

- Kernels in fp32 against fp32 with another summation order: ~1e-6 on
  values of order 1, checked at 2e-5 (the JAX kernel tests' own), 1e-5
  against XLA (``tests/test_torch_ragged_head_dims.py``); the appended cache
  rows bitwise.
- K3 and K4 against the TPU kernels: as ``tests/test_torch_quant_decode.py``
  (K3 1e-5; K4 2^-9 of the value span, for the TPU K4's bf16 weights); the
  appended bytes equal.
- Models: token streams identical, first-token logits within 1e-4 (fp32
  summation order over two layers and the lm_head, as in
  ``tests/test_torch_head_dims.py``).
"""

import torch_threads  # noqa: F401  (torch's thread share, first)
import contextlib
import re
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.cache import quant_cache as jq
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.ops.attention import blocked_causal_attention
from kvcache_factory_tpu.ops.kernels import decode_attn as jdecode
from kvcache_factory_tpu.ops.kernels import decode_attn_quant as jdq
from kvcache_factory_tpu.ops.kernels import flash_prefill as jflash
from kvcache_factory_tpu.policies.scoring import window_attention_scores
from kvcache_factory_tpu.runtime.generate import generate as jax_generate
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.cache import quant_cache as tq
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.ops.attention import NEG_INF
from kvcache_factory_tpu_torch.ops.kernels import decode_attn as tdecode
from kvcache_factory_tpu_torch.ops.kernels import decode_attn_quant as tdq
from kvcache_factory_tpu_torch.ops.kernels import flash_prefill as tflash
from kvcache_factory_tpu_torch.runtime import engine as tengine

TOL = dict(rtol=2e-5, atol=2e-5)
XLA_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
HEADS = (4, 1)  # 4 query heads and 1 KV head, as the regrouped Llama-3-8B
BLOCK = 64


def t(x):
    return torch.from_numpy(np.array(x))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def valid_rows(S_q, tls, offsets):
    off = np.zeros(len(tls), np.int64) if offsets is None else np.asarray(offsets)
    return (off[:, None] + np.arange(S_q)[None]) < np.asarray(tls)[:, None]


# --- K1 ------------------------------------------------------------------------

# (B, S_q, S_k, true_len, row_offset, sliding_window, window)
K1_CASES = {
    "dense": (2, 128, 128, [128, 97], None, None, 8),
    "sliding_window": (1, 192, 192, [180], None, 70, 0),
    "chunk": (2, 64, 192, [192, 100], [128, 37], 40, 0),
}


def _k1(case, D, seed):
    B, S_q, S_k, tls, offsets, sw, W = K1_CASES[case]
    Hq, Hkv = HEADS
    rng = np.random.default_rng(seed)
    q = normal(rng, B, Hq, S_q, D)
    k, v = normal(rng, B, Hkv, S_k, D), normal(rng, B, Hkv, S_k, D)
    tl = np.asarray(tls, np.int32)
    off = None if offsets is None else np.asarray(offsets, np.int32)
    out, scores = (x.numpy() for x in tflash.flash_prefill_attention(
        t(q), t(k), t(v), t(tl), W, sliding_window=sw, row_offset=None if off is None else t(off)))
    assert np.isfinite(out).all()
    return q, k, v, tl, off, sw, W, out, scores


@pytest.mark.parametrize("case,D", [("dense", 640), ("dense", 1024), ("sliding_window", 640),
                                    ("chunk", 1024)])
def test_k1_plain_matches_pallas(case, D):
    """K1's plain version above 512 (dense with window scores, sliding
    window, chunk; the plain version is one for every width, so the cases
    share 640 and 1024) against the Pallas kernel in interpret mode: the
    output on every valid row, the window scores on the scored columns."""
    q, k, v, tl, off, sw, W, out, scores = _k1(case, D, seed=61)
    j_out, j_sc = (np.asarray(x) for x in jflash.flash_prefill_attention_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), W, q_block=BLOCK,
        kv_block=BLOCK, interpret=True, sliding_window=sw,
        row_offset=None if off is None else jnp.asarray(off)))
    valid = valid_rows(q.shape[2], tl, off)
    for b in range(q.shape[0]):
        np.testing.assert_allclose(out[b][:, valid[b]], j_out[b][:, valid[b]], **TOL)
        if W:
            np.testing.assert_allclose(scores[b, :, :tl[b] - W], j_sc[b, :, :tl[b] - W], **TOL)


@pytest.mark.parametrize("pattern,D", [(("ashape", 1, 1, 2), 1024),
                                       (("vertical_slash", 8, 2, 16), 640)])
def test_k1_sparse_plain_matches_pallas(pattern, D):
    """The a-shape (at 1024) and vertical-slash (at 640) variants, window
    scores of the sparse softmax included, against the Pallas kernel in
    interpret mode on inputs with heavy key columns (else the
    vertical-slash mask keeps every block); the pattern drops something."""
    S, tls, window = 256, [256, 190], 8
    Hq, Hkv = HEADS
    rng = np.random.default_rng(67)
    q, k, v = normal(rng, 2, Hq, S, D), normal(rng, 2, Hkv, S, D), normal(rng, 2, Hkv, S, D)
    q[..., :8] = np.abs(q[..., :8]) + 0.5
    k[:, :, 70:78, :8] = 3.0
    tl = np.asarray(tls, np.int32)
    out, scores = tflash.flash_prefill_attention(t(q), t(k), t(v), t(tl), window,
                                                 sparse_pattern=pattern, q_block=BLOCK)
    j_out, j_sc = (np.asarray(x) for x in jflash.flash_prefill_attention_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), window,
        q_block=BLOCK, kv_block=BLOCK, interpret=True, sparse_pattern=pattern))
    for b, n in enumerate(tls):
        np.testing.assert_allclose(out[b, :, :n].numpy(), j_out[b, :, :n], **TOL)
        np.testing.assert_allclose(scores[b, :, :n - window].numpy(), j_sc[b, :, :n - window],
                                   **TOL)
    dense, _ = tflash.flash_prefill_attention(t(q), t(k), t(v), t(tl), window)
    assert not torch.allclose(dense[0, :, :tls[0]], out[0, :, :tls[0]], atol=1e-3)


@pytest.mark.parametrize("D", [1024])
def test_k1_ml_plain_matches_pallas(D):
    """K1-ml's plain version above 512 against the Pallas kernel's
    ``return_ml`` in interpret mode, on a ring hop whose upper rows see no
    column (rank 1 of a 384-row ring over shard 0 at SW 80): ``out``, ``m``
    and ``l`` where a row sees a column, ``m = NEG_INF`` on both sides where
    it sees none."""
    rng = np.random.default_rng(71)
    Hq, Hkv = HEADS
    q = normal(rng, 2, Hq, 192, D)
    k, v = normal(rng, 2, Hkv, 192, D), normal(rng, 2, Hkv, 192, D)
    tl, off = np.asarray([384, 350], np.int32), np.asarray([192, 192], np.int32)
    out, _, m, l = (x.numpy() for x in tflash.flash_prefill_attention(
        t(q), t(k), t(v), t(tl), 0, sliding_window=80, row_offset=t(off), return_ml=True))
    j_out, _, j_m, j_l = (np.asarray(x) for x in jflash.flash_prefill_attention_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), 0, q_block=BLOCK,
        kv_block=BLOCK, interpret=True, sliding_window=80, row_offset=jnp.asarray(off),
        return_ml=True))
    valid = np.broadcast_to(valid_rows(192, tl, off)[:, None], m.shape)
    seen = valid & (m > NEG_INF)
    np.testing.assert_array_equal(seen, valid & (j_m > NEG_INF))
    assert seen.any() and (valid & ~seen).any()
    np.testing.assert_allclose(out[seen], j_out[seen], **TOL)
    np.testing.assert_allclose(m[seen], j_m[seen], **TOL)
    np.testing.assert_allclose(l[seen], j_l[seen], rtol=2e-5)


@pytest.mark.parametrize("case,D", [("dense", 514), ("sliding_window", 514), ("chunk", 514),
                                    ("dense", 1004)])
def test_k1_plain_matches_jax_xla_off_the_lanes(case, D):
    """K1's plain version at head_dims above 512 that are no multiple of 128
    (514 a whole number of 4-byte pieces, 1004 of 8-byte ones) against the
    JAX package's XLA attention, which serves them: the output on every
    valid row, the window scores (``window_attention_scores`` over K
    repeated to the query heads) on the scored columns."""
    q, k, v, tl, off, sw, W, out, scores = _k1(case, D, seed=73)
    G = q.shape[1] // k.shape[1]
    j_out = np.asarray(blocked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), sliding_window=sw,
        q_block=BLOCK, row_offset=None if off is None else jnp.asarray(off)))
    valid = valid_rows(q.shape[2], tl, off)
    for b in range(q.shape[0]):
        np.testing.assert_allclose(out[b][:, valid[b]], j_out[b][:, valid[b]], **XLA_TOL)
        if W:
            j_sc = np.asarray(window_attention_scores(
                jnp.asarray(np.repeat(k[b], G, axis=0)), jnp.asarray(q[b]), jnp.int32(tl[b]), W))
            np.testing.assert_allclose(scores[b, :, :tl[b] - W], j_sc[:, :tl[b] - W], **XLA_TOL)


# --- K2 ------------------------------------------------------------------------

# C, G, lengths, lower
K2_SHAPES = {
    "g1-ragged": (96, 1, [0, 1, 50, 95], None),
    "g4-lower-full": (64, 4, [64, 10, 63, 40], [0, 0, 20, 41]),
}


def _k2(D, C, G, lengths, lower, seed):
    H = 4
    rng = np.random.default_rng(seed)
    q, kc, vc = normal(rng, H, G, D), normal(rng, H, C, D), normal(rng, H, C, D)
    kn, vn = normal(rng, H, D), normal(rng, H, D)
    lens = np.asarray(lengths, np.int32)
    lo = None if lower is None else np.asarray(lower, np.int32)
    k_port, v_port = t(kc), t(vc)
    out = tdecode.decode_attention_append(t(q), k_port, v_port, t(lens), t(kn), t(vn),
                                          None if lo is None else t(lo))
    return q, kc, vc, kn, vn, lens, lo, out.numpy(), k_port.numpy(), v_port.numpy()


@pytest.mark.parametrize("shape,D", [("g1-ragged", 640), ("g1-ragged", 1024),
                                     ("g4-lower-full", 1024)])
def test_k2_plain_matches_pallas(shape, D):
    """K2's plain version above 512 against the Pallas ``_decode_kernel`` in
    interpret mode: the output, the appended cache and the lengths."""
    C, G, lengths, lower = K2_SHAPES[shape]
    q, kc, vc, kn, vn, lens, lo, out, k_port, v_port = _k2(D, C, G, lengths, lower, 79)
    j_out, j_k, j_v, j_lens = jdecode.decode_attention_append(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        jnp.asarray(kn), jnp.asarray(vn), interpret=True,
        lower=None if lo is None else jnp.asarray(lo))
    np.testing.assert_allclose(out, np.asarray(j_out), **TOL)
    np.testing.assert_array_equal(k_port, np.asarray(j_k))
    np.testing.assert_array_equal(v_port, np.asarray(j_v))
    np.testing.assert_array_equal(np.minimum(lens + 1, C), np.asarray(j_lens))


@pytest.mark.parametrize("shape,D", [("g1-ragged", 514), ("g4-lower-full", 514),
                                     ("g4-lower-full", 1004)])
def test_k2_plain_matches_jax_xla_off_the_lanes(shape, D):
    """K2's plain version at 514 and 1004 against the JAX package's XLA
    decode attention (``grouped_attention``) over the cache with the new
    token in slot ``min(len, C - 1)``: the output, and the appended cache
    bitwise."""
    C, G, lengths, lower = K2_SHAPES[shape]
    q, kc, vc, kn, vn, lens, lo, out, k_port, v_port = _k2(D, C, G, lengths, lower, 83)
    H = q.shape[0]
    L = np.minimum(lens, C - 1)
    k_app, v_app = kc.copy(), vc.copy()
    k_app[np.arange(H), L], v_app[np.arange(H), L] = kn, vn
    np.testing.assert_array_equal(k_port, k_app)
    np.testing.assert_array_equal(v_port, v_app)
    idx = np.arange(C)[None]
    low = np.zeros(H, np.int64) if lo is None else lo.astype(np.int64)
    keep = ((idx >= low[:, None]) & (idx < L[:, None])) | (idx == L[:, None])
    j_out = jllama.grouped_attention(
        jnp.asarray(q.reshape(1, H * G, 1, D)), jnp.asarray(k_app[None]),
        jnp.asarray(v_app[None]), jnp.asarray(keep[None, :, None]))
    np.testing.assert_allclose(out, np.asarray(j_out).reshape(H, G, D), **XLA_TOL)


# --- K3 and K4 -----------------------------------------------------------------

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


@pytest.mark.parametrize("nbits,G,C,lengths,lower", [
    pytest.param(8, 4, 128, [3, 100, 128, 70], [0, 20, 90, 0], id="8-g4-lower-full"),
    pytest.param(4, 1, 256, [0, 5, 131, 254], None, id="4-ragged")])
def test_kq_plain_matches_pallas_at_640(nbits, G, C, lengths, lower):
    """K3's and K4's plain versions at head_dim 640 against the JAX kernels
    in interpret mode over one cache carried across
    (``quant_cache_from_jax``): the dequantized rows equal, the output, and
    the appended codes and scalars byte for byte."""
    D, H = 640, 4  # capacities as the TPU layouts need: int8 % 128, int4 % 256
    rng = np.random.default_rng(89)
    q = torch.from_numpy(normal(rng, H, G, D)).to(torch.bfloat16).float().numpy()
    k_fp, v_fp = normal(rng, H, C, D), 3.0 * normal(rng, H, C, D)
    kn, vn = normal(rng, H, D), 3.0 * normal(rng, H, D)
    lens = np.asarray(lengths, np.int32)
    lo = None if lower is None else np.asarray(lower, np.int32)
    jc = JAX_PREFILL[nbits](jnp.asarray(k_fp)[None, None], jnp.asarray(v_fp)[None, None],
                            jnp.zeros((1, 1, H), jnp.int32), jnp.zeros((1,), jnp.int32))
    arrays = (jc.k_codes[0], jc.v_codes[0], jc.scales[0])
    kc, vc, sc = _carried(arrays, nbits)
    # The dequantized rows: the port's cache against JAX's codes (int8
    # biased by -128; int4 two tokens a byte) times its bf16 scale and zero.
    k_deq, v_deq = (np.asarray(a)[0, 0] for a in tq.dequantize_kv(
        tq.quant_cache_from_jax(*(np.asarray(a) for a in jc), nbits=nbits)))
    j_sc = np.asarray(jc.scales[0, 0], np.float32)                  # [H, 4, C]
    for got, codes, col in ((k_deq, jc.k_codes, 0), (v_deq, jc.v_codes, 2)):
        c = np.asarray(codes[0, 0]).astype(np.int32) + 128 if nbits == 8 else \
            np.asarray(jq.unpack_tokens_int4(codes[0, 0]))
        want = c * j_sc[:, col, :, None] + j_sc[:, col + 1, :, None]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    out = PORT_KERNEL[nbits](t(q), kc, vc, sc, t(lens), t(kn), t(vn),
                             None if lo is None else t(lo)).numpy()
    j_out, j_kc, j_vc, j_sc, j_lens = JAX_KERNEL[nbits](
        jnp.asarray(q), *arrays, jnp.asarray(lens), jnp.zeros((1,), jnp.int32),
        jnp.asarray(kn), jnp.asarray(vn), interpret=True,
        lower=None if lo is None else jnp.asarray(lo))
    atol = 1e-5 if nbits == 8 else 2.0 ** -9 * (v_deq.max(-1) - v_deq.min(-1)).max()
    np.testing.assert_allclose(out, np.asarray(j_out), rtol=0, atol=atol)
    for got, want in zip((kc, vc, sc), _carried((j_kc, j_vc, j_sc), nbits)):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(np.minimum(lens + 1, C), np.asarray(j_lens))


# --- the slice end to end --------------------------------------------------------

# Meta-Llama-3-8B-Instruct's attention regrouped (4 query heads and 1 KV head
# of 1024, G 4, rope_theta 5e5, untied lm_head), cut to size elsewhere.
LLAMA3_WIDE = dict(model_type="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
                   head_dim=1024, rope_theta=500000.0, tie_word_embeddings=False,
                   dtype="float32")
SNAPKV = dict(method="snapkv", max_capacity_prompt=64, window_size=8, kernel_size=7,
              pooling="maxpool", group_reduce="none")
BUCKET = 128
MAX_NEW = 4


@pytest.fixture(scope="module")
def llama3_wide():
    jc, tc = jcfg.ModelConfig(**LLAMA3_WIDE), tcfg.ModelConfig(**LLAMA3_WIDE)
    jp = jweights.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, LLAMA3_WIDE["vocab_size"], size=n).tolist() for n in (120, 40)]
    toks = np.zeros((len(prompts), BUCKET), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, prompts=prompts, toks=toks, lens=lens)


@pytest.mark.parametrize("comp", ["snapkv", "fullkv"])
def test_llama3_wide_engine_matches_jax(llama3_wide, comp):
    """A two-layer model with 4 / 1 heads of 1024 through the port's
    ``InferenceEngine`` against JAX's ``generate``: snapkv (a cache per
    query head, K2 at G 1 on the card) and fullkv (K2 at G 4).  Streams
    identical, cache lengths equal, first-token logits within 1e-4."""
    m = llama3_wide
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
    assert res.cache.lengths.shape[-1] == (4 if comp == "snapkv" else 1)
    jpre = jllama.prefill(m["jp"], m["jc"], jcomp, jnp.asarray(m["toks"]),
                          jnp.asarray(m["lens"]), cap)
    np.testing.assert_allclose(res.logits[:, 0].numpy(), np.asarray(jpre.logits_last),
                               **LOGITS_TOL)


def test_per_token_rule_takes_every_multiple_of_128():
    """Both packages build the per-token cache (K3 / K4 on the card) at every
    head_dim % 128 == 0, 1024 and 2048 included, and the grouped one
    elsewhere."""
    for D in (128, 640, 1024, 2048, 514, 576, 1004):
        assert tcfg.QuantConfig(nbits=8).per_token(D) == (D % 128 == 0), D
        assert tcfg.QuantConfig(nbits=4).per_token(D) == (D % 128 == 0), D
        assert tdq.takes_head_dim(D) == (D % 128 == 0), D
    assert not tcfg.QuantConfig(nbits=8, residual_length=16).per_token(1024)


# --- what the wrappers hand the wide kernels on the card ------------------------


class _StubLib:
    """A kernel library whose entry points record their arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("kvcf_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@contextlib.contextmanager
def _stubbed(monkeypatch, mod):
    """Let a meta tensor through ``mod``'s kernel path to a stubbed library:
    no device check, no CUDA stream or device, 132 SMs, counters noted.
    Yields the libraries loaded, the stub and the counters asked for."""
    lib, loaded, asked = _StubLib(), [], []
    monkeypatch.setattr(tflash._build, "load", lambda name: loaded.append(name) or lib)
    monkeypatch.setattr(mod, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: mock.Mock(cuda_stream=0))
    monkeypatch.setattr(tdecode, "_sm_count", lambda dev: 132)
    counters = lambda dev, n: asked.append(n) or torch.zeros(n, dtype=torch.int32,  # noqa: E731
                                                                 device="meta")
    monkeypatch.setattr(tdecode, "_counters", counters)
    monkeypatch.setattr(tdq, "_counters", counters)
    monkeypatch.setattr(tdq, "_sm_count", lambda dev: 132)
    yield loaded, lib, asked


M = dict(dtype=torch.bfloat16, device="meta")
I32 = dict(dtype=torch.int32, device="meta")


@pytest.mark.parametrize("D,slices", [(514, 3), (576, 3), (640, 3), (768, 3), (1004, 4),
                                      (1024, 4), (2048, 8), (2050, 9), (4096, 16)])
def test_wide_stubs_take_the_wide_kernels_slices_and_true_scale(D, slices, monkeypatch):
    """On a tensor off the CPU, K1 and K2 at a head_dim above 512 load the
    wide library (one for every piece width), call its entry point with the
    column-slice count, D and ``D ** -0.5`` as the last numbers before the
    stream: K1's cluster kernel up to 2048 (a cluster of ``slices`` CTAs),
    its slice-recomputing kernel above; K2 its one entry point, asking for
    a counter per (head, query block, slice) and sizing its partials per
    slice of ``SLICE`` columns."""
    assert tflash.takes_head_dim(D) and tflash.slices(D) == slices == -(-D // tflash.SLICE)
    assert tflash.instance(D) == D
    monkeypatch.setattr(tflash.flash_prefill_attention, "launches", 0)
    monkeypatch.setattr(tflash.flash_prefill_attention, "variant_launches",
                        dict.fromkeys(tflash.flash_prefill_attention.variant_launches, 0))
    with _stubbed(monkeypatch, tflash) as (loaded, lib, _):
        q = torch.empty(1, 4, 64, D, **M)
        tflash.flash_prefill_attention(q, q[:, :1], q[:, :1], torch.empty(1, **I32), 8)
    (name, args), = lib.calls
    cluster = D <= 2048
    assert tflash.cluster_size(D) == (slices if cluster else 1)
    assert loaded == ["flash_prefill_wide"] and name == tflash.entry(D) == (
        "kvcf_flash_prefill_cluster" if cluster else "kvcf_flash_prefill_wide")
    assert args[-4:-1] == (slices, D, D ** -0.5) and len(args) == 23
    assert tflash.flash_prefill_attention.launches == 1
    monkeypatch.setattr(tdecode.decode_attention_append, "launches", 0)
    H, G, C = 2, 12, 16
    with _stubbed(monkeypatch, tdecode) as (loaded, lib, asked):
        kc = torch.empty(H, C, D, **M)
        tdecode.decode_attention_append(torch.empty(H, G, D, **M), kc, torch.empty(H, C, D, **M),
                                        torch.empty(H, **I32), torch.empty(H, D, **M),
                                        torch.empty(H, D, **M))
    (name, args), = lib.calls
    assert loaded == ["decode_attn_wide"] and name == "kvcf_decode_attn_append_wide"
    n_split = tdecode.splits(H, G, C, D, 132)
    assert n_split == tdecode.split_count(H * 2 * slices, C, 132, 2)
    assert args[10:16] == (H, G, C, n_split, slices, D) and args[-2] == D ** -0.5
    assert asked == [H * 2 * slices] and len(args) == 18


@pytest.mark.parametrize("D", [640, 1024, 2048, 2176, 4096])
@pytest.mark.parametrize("nbits", [8, 4])
def test_quant_stubs_take_the_wide_kernel(nbits, D, monkeypatch):
    """K3 above 512 loads ``decode_attn_quant_cluster`` up to 2048 (a
    cluster of one CTA a slice) and ``decode_attn_quant_wide`` above; K4
    ``decode_attn_quant_wide`` at every width.  Each calls its entry point
    for its bits with the split count, the slices, D and ``D ** -0.5``,
    asks for a counter per (head, query block, slice) and hands scratch of
    ``SLICE + 2`` floats a (head, query block, slice, split, query row)."""
    H, G, C = 2, 4, 16
    width = D if nbits == 8 else D // 2
    fn = tdq.quant_decode_attention_append if nbits == 8 else tdq.quant4_decode_attention_append
    monkeypatch.setattr(fn, "launches", 0)
    floats, real_empty = [], torch.empty

    def empty(*size, **kw):
        floats.append(size)
        return real_empty(*size, **kw)

    with _stubbed(monkeypatch, tdq) as (loaded, lib, asked):
        monkeypatch.setattr(torch, "empty", empty)
        fn(real_empty(H, G, D, **M), real_empty(H, C, width, dtype=torch.uint8, device="meta"),
           real_empty(H, C, width, dtype=torch.uint8, device="meta"),
           real_empty(H, C, 4, **M), real_empty(H, **I32), real_empty(H, D, **M),
           real_empty(H, D, **M))
    (name, args), = lib.calls
    slices = tflash.slices(D)
    kind = "cluster" if nbits == 8 and D <= 2048 else "wide"
    assert loaded == [f"decode_attn_quant_{kind}"] == [tdq.library(D, nbits)]
    assert name == f"kvcf_quant{nbits}_decode_attn_append_{kind}" == tdq.entry(nbits, D)
    n_split = tdq.splits(H, G, C, D, 132)
    assert args[11:17] == (H, G, C, n_split, slices, D)
    assert args[-2] == D ** -0.5 and asked == [H * slices] and fn.launches == 1
    assert (H * slices * n_split * G * (tflash.SLICE + 2),) in floats


def test_cluster_rule_for_every_head_dim_the_wrappers_take():
    """Above 512 a cluster holds one CTA per column slice, up to the
    portable 8 (D <= 2048): K1's entry point and K3's library follow it;
    above 2048 both run the slice-recomputing kernels, K2 and K4 run theirs at every
    width.  Odd head_dims stay refused, and K3 / K4 take only multiples of
    128."""
    assert tflash.CLUSTER_MAX == 8
    csrc = Path(tflash.__file__).resolve().parents[2] / "csrc"
    for source in ("flash_prefill_wide.cu", "decode_attn_quant_cluster.cu"):
        assert re.findall(r"constexpr int CLUSTER_MAX = (\d+);", (csrc / source).read_text()) \
            == [str(tflash.CLUSTER_MAX)]
    for D in range(2, 4100):
        if D % 2:
            assert not tflash.takes_head_dim(D)
            continue
        n = tflash.slices(D)
        cluster = 512 < D <= 2048
        assert tflash.cluster_size(D) == (n if cluster else 1) and n == (
            1 if D <= 512 else -(-D // 256))
        assert (tflash.entry(D) == "kvcf_flash_prefill_cluster") == cluster
        assert tdecode.entry(D) == ("kvcf_decode_attn_append_wide" if D > 512
                                    else f"kvcf_decode_attn_append_d{tflash.instance(D)}")
        if D % 128 == 0:
            assert tdq.takes_head_dim(D)
            assert (tdq.library(D, 8) == "decode_attn_quant_cluster") == cluster
            assert tdq.library(D, 4) == ("decode_attn_quant_wide" if D > 512
                                         else tdq.library(D, 8))
        else:
            assert not tdq.takes_head_dim(D)


@pytest.mark.parametrize("D", [513, 1025, 2047])
def test_wide_checks_refuse_odd_head_dims(D):
    """Above 512 only odd head_dims stay refused (RoPE needs even ones), and
    K3 / K4 refuse every head_dim that is no multiple of 128."""
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="odd head_dims"):
        tflash._check(torch.zeros(1, 4, 64, D, dtype=bf), torch.zeros(1, 1, 64, D, dtype=bf),
                      torch.zeros(1, 1, 64, D, dtype=bf), torch.zeros(1, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="odd head_dims"):
        tdecode._check(torch.zeros(2, 4, D, dtype=bf), torch.zeros(2, 16, D, dtype=bf),
                       torch.zeros(2, 16, D, dtype=bf), torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, D, dtype=bf), torch.zeros(2, D, dtype=bf), None)
    E = 2 * D  # even, and no multiple of 128
    with pytest.raises(ValueError, match="head_dim % 128 == 0"):
        tdq._check(8, torch.zeros(2, 4, E, dtype=bf), torch.zeros(2, 16, E, dtype=torch.uint8),
                   torch.zeros(2, 16, E, dtype=torch.uint8), torch.zeros(2, 16, 4, dtype=bf),
                   torch.zeros(2, dtype=torch.int32), torch.zeros(2, E, dtype=bf),
                   torch.zeros(2, E, dtype=bf), None)
