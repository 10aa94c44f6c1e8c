"""K1-K4 at head_dim 64, 80, 256, 384 and 512 (K3 / K4 at 256, 384 and
512), and the models that run them, against the JAX package on the CPU.

At head_dim 64 and 80 the JAX package runs its XLA attention (its Pallas
kernels take ``D % 128 == 0``): K1's plain version is held to
``ops/attention.py::blocked_causal_attention`` and
``policies/scoring.py::window_attention_scores``, K1-ml to the XLA fold of
``make_ring_attention``, K2's to ``models/llama.py::grouped_attention`` over
the appended cache.  At head_dim 256, 384 and 512 the Pallas kernels run in
interpret mode, as ``tests/test_torch_kernels.py`` and
``tests/test_torch_quant_decode.py`` run them (at 384 and 512 on the cases
of at most 256 rows).  The cases at the head_dims added after 64 and 256
carry ``-d<D>`` in their ids.  Inputs are fp32 numpy arrays from
``np.random.default_rng``.  On a CUDA tensor a head_dim that no kernel
instantiation has runs on the narrowest wider one with its own
``1/sqrt(D)``: a stubbed library checks the entry point and the scale.

Tolerances, each with its reason:

- Kernels in fp32 against fp32 with another summation order: ~1e-6 on
  values of order 1, checked at 2e-5 (the JAX kernel tests' own); the ring
  fold at 3e-5 (``tests/test_torch_ring_attention.py``).
- K3 and K4 against the TPU kernels: as ``tests/test_torch_quant_decode.py``
  (K3 1e-5, its range case 4e-6 of the largest output; K4 2^-9 of the
  value span, for the TPU K4's bf16 weights); the appended bytes equal.
- Models: token streams identical, first-token logits within 1e-4 (fp32
  summation order over two layers and the lm_head, as in
  ``tests/test_torch_generate.py``).
"""

import torch_threads  # noqa: F401  (torch's thread share, first)
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.cache import quant_cache as jq
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.ops.attention import blocked_causal_attention
from kvcache_factory_tpu.ops.kernels import decode_attn as jdecode
from kvcache_factory_tpu.ops.kernels import decode_attn_quant as jdq
from kvcache_factory_tpu.ops.kernels import flash_prefill as jflash
from kvcache_factory_tpu.parallel.ring_attention import make_ring_attention
from kvcache_factory_tpu.policies.scoring import window_attention_scores
from kvcache_factory_tpu.runtime.generate import generate as jax_generate
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.cache import quant_cache as tq
from kvcache_factory_tpu_torch.models import llama as tllama
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.ops.kernels import decode_attn as tdecode
from kvcache_factory_tpu_torch.ops.kernels import decode_attn_quant as tdq
from kvcache_factory_tpu_torch.ops.kernels import flash_prefill as tflash
from kvcache_factory_tpu_torch.parallel.ring_attention import ring_attention_emulated
from kvcache_factory_tpu_torch.runtime import engine as tengine
from kvcache_factory_tpu_torch.runtime import generate as tgenerate

TOL = dict(rtol=2e-5, atol=2e-5)
FOLD_TOL = dict(rtol=3e-5, atol=3e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def valid_rows(S_q, tls, offsets):
    off = np.zeros(len(tls), np.int64) if offsets is None else np.asarray(offsets)
    return (off[:, None] + np.arange(S_q)[None]) < np.asarray(tls)[:, None]


# --- K1 ------------------------------------------------------------------------

# (B, Hq, Hkv, S_q, S_k, true_len, row_offset, sliding_window, window)
K1_CASES = {
    "dense": (2, 8, 2, 256, 256, [256, 131], None, None, 8),
    "sliding_window": (1, 4, 2, 384, 384, [300], None, 100, 0),
    "chunk": (3, 4, 2, 32, 200, [200, 60, 0], [100, 37, 0], 24, 0),
    "chunk_dense": (2, 4, 2, 64, 256, [256, 190], [192, 130], None, 0),
}


def _k1_inputs(case, D, seed):
    B, Hq, Hkv, S_q, S_k, tls, offsets, sw, W = K1_CASES[case]
    rng = np.random.default_rng(seed)
    q = normal(rng, B, Hq, S_q, D)
    k, v = normal(rng, B, Hkv, S_k, D), normal(rng, B, Hkv, S_k, D)
    tl = np.asarray(tls, np.int32)
    off = None if offsets is None else np.asarray(offsets, np.int32)
    out, scores = tflash.flash_prefill_attention(
        t(q), t(k), t(v), t(tl), W, sliding_window=sw,
        row_offset=None if off is None else t(off))
    return q, k, v, tl, off, sw, W, out.numpy(), scores.numpy()


def _at(cases, first, more, small=()):
    """``(case, D)`` parameters: the cases at head_dim ``first`` under their
    own ids, then at each of ``more`` as ``<case>-d<D>`` (only the cases
    in ``small`` where that is given)."""
    return ([pytest.param(c, first, id=c) for c in cases]
            + [pytest.param(c, d, id=f"{c}-d{d}") for d in more for c in cases
               if not small or c in small])


# K1's cases of at most 256 rows, run at head_dim 384 and 512.
K1_SMALL = ("chunk", "chunk_dense", "dense")


@pytest.mark.parametrize("case,D", _at(sorted(K1_CASES), 64, (80,)))
def test_k1_head_dim_64_plain_matches_jax_xla(case, D):
    """K1's plain version at head_dim 64 and 80 (dense with window scores,
    sliding window, chunk) against the JAX package's XLA attention, which
    it runs at these head_dims: the output on every valid row, the window
    scores on the scored columns (``window_attention_scores`` over K
    repeated to the query heads; it marks the rest NEG_INF, K1 leaves them
    to the caller)."""
    q, k, v, tl, off, sw, W, out, scores = _k1_inputs(case, D, seed=31)
    G = q.shape[1] // k.shape[1]
    j_out = np.asarray(blocked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), sliding_window=sw,
        q_block=64, row_offset=None if off is None else jnp.asarray(off)))
    valid = valid_rows(q.shape[2], tl, off)
    assert np.isfinite(out).all()
    for b in range(q.shape[0]):
        np.testing.assert_allclose(out[b][:, valid[b]], j_out[b][:, valid[b]], **TOL)
        if W:
            j_sc = np.asarray(window_attention_scores(
                jnp.asarray(np.repeat(k[b], G, axis=0)), jnp.asarray(q[b]), jnp.int32(tl[b]), W))
            np.testing.assert_allclose(scores[b, :, :tl[b] - W], j_sc[:, :tl[b] - W], **TOL)


@pytest.mark.parametrize("D", [pytest.param(64, id="d64"), pytest.param(80, id="d80")])
def test_k1_ml_head_dim_64_fold_matches_jax_xla_ring(D):
    """K1-ml's plain version at head_dim 64 and 80, every hop of the ring
    folded in one process, against JAX ``make_ring_attention``'s XLA fold
    on 4 virtual CPU devices under a window (its kernel fold needs D % 128
    == 0)."""
    n, true_len, sw = 4, 230, 70
    rng = np.random.default_rng(37)
    q = normal(rng, 2, 4, 256, D)
    k, v = normal(rng, 2, 2, 256, D), normal(rng, 2, 2, 256, D)
    tl = np.asarray([true_len, true_len - 37], np.int32)
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    ring = make_ring_attention(mesh, "sp", sliding_window=sw, backend="xla")
    with mesh:
        want = np.asarray(ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl)))
    got = ring_attention_emulated(t(q), t(k), t(v), t(tl), n, sw).numpy()
    for b, length in enumerate(tl):
        np.testing.assert_allclose(got[b, :, :length], want[b, :, :length], **FOLD_TOL)


@pytest.mark.parametrize("case,D", _at(sorted(K1_CASES), 256, (384, 512), K1_SMALL))
def test_k1_head_dim_256_plain_matches_pallas(case, D):
    """K1's plain version at head_dim 256 (and at 384 and 512 on the cases
    of at most 256 rows) against the Pallas kernel in interpret mode
    (64-row blocks where a case needs them, as
    ``tests/test_torch_kernels.py``): output on every valid row, window
    scores on the scored columns."""
    q, k, v, tl, off, sw, W, out, scores = _k1_inputs(case, D, seed=41)
    blk = 128 if case == "dense" else 64
    j_out, j_sc = jflash.flash_prefill_attention_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), W, q_block=blk,
        kv_block=blk, interpret=True, sliding_window=sw,
        row_offset=None if off is None else jnp.asarray(off))
    j_out, j_sc = np.asarray(j_out), np.asarray(j_sc)
    valid = valid_rows(q.shape[2], tl, off)
    assert np.isfinite(out).all()
    for b in range(q.shape[0]):
        np.testing.assert_allclose(out[b][:, valid[b]], j_out[b][:, valid[b]], **TOL)
        if W:
            np.testing.assert_allclose(scores[b, :, :tl[b] - W], j_sc[b, :, :tl[b] - W], **TOL)


@pytest.mark.parametrize("D", [pytest.param(256, id="d256"), pytest.param(512, id="d512")])
def test_k1_ml_head_dim_256_plain_matches_pallas(D):
    """K1-ml's plain version at head_dim 256 and 512 against the Pallas
    kernel's ``return_ml`` in interpret mode, on a hop whose upper rows see
    no column (rank 1 of a 512-row ring over shard 0 at SW 80): ``out``,
    ``m`` and ``l`` where a row sees a column, ``m = NEG_INF`` on both sides
    where it sees none."""
    from kvcache_factory_tpu_torch.ops.attention import NEG_INF
    rng = np.random.default_rng(43)
    q = normal(rng, 2, 4, 256, D)
    k, v = normal(rng, 2, 2, 256, D), normal(rng, 2, 2, 256, D)
    tl, off = np.asarray([512, 470], np.int32), np.asarray([256, 256], np.int32)
    out, _, m, l = (x.numpy() for x in tflash.flash_prefill_attention(
        t(q), t(k), t(v), t(tl), 0, sliding_window=80, row_offset=t(off), return_ml=True))
    j_out, _, j_m, j_l = (np.asarray(x) for x in jflash.flash_prefill_attention_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), 0, q_block=64,
        kv_block=64, interpret=True, sliding_window=80, row_offset=jnp.asarray(off),
        return_ml=True))
    valid = np.broadcast_to(valid_rows(256, tl, off)[:, None], m.shape)
    seen = valid & (m > NEG_INF)
    np.testing.assert_array_equal(seen, valid & (j_m > NEG_INF))
    assert seen.any() and (valid & ~seen).any()
    np.testing.assert_allclose(out[seen], j_out[seen], **TOL)
    np.testing.assert_allclose(m[seen], j_m[seen], **TOL)
    np.testing.assert_allclose(l[seen], j_l[seen], rtol=2e-5)


# --- K2 ------------------------------------------------------------------------

# C, G, lengths, lower
K2_SHAPES = {
    "ragged": (96, 1, [0, 1, 50, 95], None),
    "g4-lower": (96, 4, [3, 40, 77, 12], [0, 0, 20, 5]),
    "full": (64, 1, [64, 10, 63, 64], None),
    "g7-lower-past-L": (50, 7, [0, 10, 49, 30], [0, 4, 0, 31]),
}


def _k2_cases(first, more):
    return [pytest.param(*K2_SHAPES[p.values[0]], p.values[1], id=p.id)
            for p in _at(list(K2_SHAPES), first, more)]


def _k2_inputs(D, C, G, lengths, lower, seed):
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


@pytest.mark.parametrize("C,G,lengths,lower,D", _k2_cases(64, (80,)))
def test_k2_head_dim_64_plain_matches_jax_xla(C, G, lengths, lower, D):
    """K2's plain version at head_dim 64 and 80 against the JAX package's
    XLA decode attention (``grouped_attention``, what its decode step runs
    at these head_dims) over the cache with the new token in slot
    ``min(len, C - 1)``: the output, and the appended cache."""
    q, kc, vc, kn, vn, lens, lo, out, k_port, v_port = _k2_inputs(D, C, G, lengths, lower, 47)
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
    np.testing.assert_allclose(out, np.asarray(j_out).reshape(H, G, D), **TOL)


@pytest.mark.parametrize("C,G,lengths,lower,D", _k2_cases(256, (384, 512)))
def test_k2_head_dim_256_plain_matches_pallas(C, G, lengths, lower, D):
    """K2's plain version at head_dim 256, 384 and 512 against the Pallas
    ``_decode_kernel`` in interpret mode: the output, the appended cache and
    the lengths."""
    q, kc, vc, kn, vn, lens, lo, out, k_port, v_port = _k2_inputs(D, C, G, lengths, lower, 53)
    j_out, j_k, j_v, j_lens = jdecode.decode_attention_append(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        jnp.asarray(kn), jnp.asarray(vn), interpret=True,
        lower=None if lo is None else jnp.asarray(lo))
    np.testing.assert_allclose(out, np.asarray(j_out), **TOL)
    np.testing.assert_array_equal(k_port, np.asarray(j_k))
    np.testing.assert_array_equal(v_port, np.asarray(j_v))
    np.testing.assert_array_equal(np.minimum(lens + 1, C), np.asarray(j_lens))


# --- K3 and K4 -----------------------------------------------------------------

JAX_PREFILL = {8: jq.from_packed_prefill_tpu, 4: jq.from_packed_prefill_tpu4}
JAX_KERNEL = {8: jdq.quant_decode_attention_append_stacked,
              4: jdq.quant4_decode_attention_append_stacked}
PORT_KERNEL = {8: tdq.quant_decode_attention_append, 4: tdq.quant4_decode_attention_append}
UNIT = (1.0, 1.0, 3.0)
RANGE = (3e4, 1e-4, 2e-4)  # tests/test_torch_quant_decode.py's range case


def _carried(arrays, nbits):
    kc, vc, sc = arrays
    H = kc.shape[1]
    c = tq.quant_cache_from_jax(np.asarray(kc)[None], np.asarray(vc)[None],
                                np.asarray(sc)[None], np.zeros((1, 1, H)), np.zeros(1), nbits)
    return c.k_codes[0, 0], c.v_codes[0, 0], c.scales[0, 0]


KQ_SHAPES = {
    # nbits, G, lengths, lower, amp
    "8-ragged": (8, 1, [0, 5, 131, 254], None, UNIT),
    "8-g4-lower-full": (8, 4, [3, 100, 256, 130], [0, 20, 150, 0], UNIT),
    "8-range": (8, 2, [200, 37, 256, 1], [0, 5, 0, 0], RANGE),
    "4-ragged": (4, 1, [0, 5, 131, 254], None, UNIT),
    "4-g4-lower-full": (4, 4, [3, 100, 256, 130], [0, 20, 150, 0], UNIT),
}


@pytest.mark.parametrize("nbits,G,lengths,lower,amp,D", [
    pytest.param(*KQ_SHAPES[p.values[0]], p.values[1], id=p.id)
    for p in _at(list(KQ_SHAPES), 256, (384, 512))])
def test_kq_head_dim_256_plain_matches_pallas(nbits, G, lengths, lower, amp, D):
    """K3's and K4's plain versions at head_dim 256, 384 and 512 against the
    JAX kernels in interpret mode over one cache carried across
    (``quant_cache_from_jax``): the output, and the appended codes and
    scalars byte for byte; the range case (q past fp16's range, tiny
    v_scale) for K3, whose card kernel runs fp16 products."""
    H, C = 4, 256
    rng = np.random.default_rng(59)
    q = torch.from_numpy((amp[0] * rng.standard_normal((H, G, D))).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    k_fp = (amp[1] * rng.standard_normal((H, C, D))).astype(np.float32)
    v_fp = (amp[2] * rng.standard_normal((H, C, D))).astype(np.float32)
    kn = (amp[1] * rng.standard_normal((H, D))).astype(np.float32)
    vn = (amp[2] * rng.standard_normal((H, D))).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    lo = None if lower is None else np.asarray(lower, np.int32)
    jc = JAX_PREFILL[nbits](jnp.asarray(k_fp)[None, None], jnp.asarray(v_fp)[None, None],
                            jnp.zeros((1, 1, H), jnp.int32), jnp.zeros((1,), jnp.int32))
    arrays = (jc.k_codes[0], jc.v_codes[0], jc.scales[0])
    kc, vc, sc = _carried(arrays, nbits)
    out = PORT_KERNEL[nbits](t(q), kc, vc, sc, t(lens), t(kn), t(vn),
                             None if lo is None else t(lo)).numpy()
    j_out, j_kc, j_vc, j_sc, j_lens = JAX_KERNEL[nbits](
        jnp.asarray(q), *arrays, jnp.asarray(lens), jnp.zeros((1,), jnp.int32),
        jnp.asarray(kn), jnp.asarray(vn), interpret=True,
        lower=None if lo is None else jnp.asarray(lo))
    j_out = np.asarray(j_out)
    top = 1.0 if amp == UNIT else np.abs(j_out).max()
    if nbits == 8:
        atol = 1e-5 if amp == UNIT else 4e-6 * top
    else:
        k_deq, v_deq = (np.asarray(a)[0, 0] for a in tq.dequantize_kv(
            tq.quant_cache_from_jax(*(np.asarray(a) for a in jc), nbits=nbits)))
        atol = 2.0 ** -9 * (v_deq.max(-1) - v_deq.min(-1)).max()
    np.testing.assert_allclose(out, j_out, rtol=0, atol=atol)
    for got, want in zip((kc, vc, sc), _carried((j_kc, j_vc, j_sc), nbits)):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(np.minimum(lens + 1, C), np.asarray(j_lens))


# --- the slice end to end --------------------------------------------------------

# Llama-3.2-1B-Instruct's shape, cut to size: head_dim 64, G 4, llama3 rope
# scaling, rope_theta 5e5, tied embeddings.
LLAMA32 = dict(model_type="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2, head_dim=64,
               rope_theta=500000.0, rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192),
               tie_word_embeddings=True, dtype="float32")
# h2o-danube2-1.8b's shape (MistralForCausalLM), cut to size: head_dim 80,
# G 4, rope_theta 1e4, no sliding window, untied lm_head.
DANUBE2 = dict(model_type="mistral", vocab_size=512, hidden_size=320, intermediate_size=576,
               num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2, head_dim=80,
               rope_theta=10000.0, tie_word_embeddings=False, dtype="float32")
# A head_dim 256 model for the per-token int8 cache (K1 and K3 at 256); the
# same at head_dim 384.
D256 = dict(model_type="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=256,
            rope_theta=10000.0, dtype="float32")
SNAPKV = dict(method="snapkv", max_capacity_prompt=64, window_size=8, kernel_size=7,
              pooling="maxpool", group_reduce="none")
BUCKET = 256
MAX_NEW = 8


def _model(cfg):
    jc, tc = jcfg.ModelConfig(**cfg), tcfg.ModelConfig(**cfg)
    jp = jweights.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    if cfg.get("tie_word_embeddings"):
        jp["lm_head"] = jp["embed"].T
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg["vocab_size"], size=n).tolist() for n in (200, 40)]
    toks = np.zeros((len(prompts), BUCKET), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, prompts=prompts, toks=toks, lens=lens)


@pytest.fixture(scope="module")
def llama32():
    return _model(LLAMA32)


@pytest.fixture(scope="module")
def danube2():
    return _model(DANUBE2)


ENGINE_RUNS = [("snapkv", None), ("fullkv", None), ("snapkv", 8)]


@pytest.mark.parametrize("comp,nbits", ENGINE_RUNS)
def test_llama32_shaped_engine_matches_jax(llama32, comp, nbits):
    """A tiny Llama-3.2-shaped model (head_dim 64, G 4, llama3 rope
    scaling, tied embeddings) through the port's ``InferenceEngine`` against
    JAX's ``generate``: snapkv and fullkv over the dense cache, and nbits 8,
    which builds the grouped cache in both packages at this head_dim.
    Streams identical, cache lengths equal, first-token logits within
    1e-4."""
    _engine_matches_jax(llama32, comp, nbits)


@pytest.mark.parametrize("comp,nbits", ENGINE_RUNS)
def test_danube2_shaped_engine_matches_jax(danube2, comp, nbits):
    """A tiny h2o-danube2-shaped model (head_dim 80, G 4) as
    :func:`test_llama32_shaped_engine_matches_jax`: K1 and K2 at 80 on the
    card; nbits 8 builds the grouped cache in both packages (80 % 128 !=
    0), in groups of 16 channels (both packages need groups that divide
    head_dim)."""
    assert not tcfg.QuantConfig(nbits=8).per_token(80)
    _engine_matches_jax(danube2, comp, nbits, q_group_size=16)


def _engine_matches_jax(m, comp, nbits, q_group_size=64):
    comp_kw = SNAPKV if comp == "snapkv" else dict(method="fullkv")
    quant = None if nbits is None else tcfg.QuantConfig(nbits=nbits, q_group_size=q_group_size)
    eng = tengine.InferenceEngine(m["tp"], tcfg.EngineConfig(
        model=m["tc"], compression=tcfg.CompressionConfig(**comp_kw), quant=quant,
        prefill_buckets=(BUCKET,)), device="cpu")
    ids, res = eng.generate_batch(m["prompts"], MAX_NEW, return_result=True)
    assert isinstance(res.cache, tq.QuantizedKVCache if nbits else tllama.KVCache)
    jcomp = jcfg.CompressionConfig(**comp_kw)
    cap = eng._cache_capacity(BUCKET, MAX_NEW)
    jres = jax_generate(m["jp"], m["jc"], jcomp, jcfg.GenerationConfig(max_new_tokens=MAX_NEW),
                        jnp.asarray(m["toks"]), jnp.asarray(m["lens"]), cap,
                        quant_cfg=None if nbits is None else jcfg.QuantConfig(
                            nbits=nbits, q_group_size=q_group_size))
    nums, toks = np.asarray(jres.num_tokens), np.asarray(jres.tokens)
    assert ids == [toks[i, :nums[i]].tolist() for i in range(len(ids))]
    np.testing.assert_array_equal(res.cache.lengths.numpy(), np.asarray(jres.cache.lengths))
    jpre = jllama.prefill(m["jp"], m["jc"], jcomp, jnp.asarray(m["toks"]),
                          jnp.asarray(m["lens"]), cap)
    np.testing.assert_allclose(res.logits[:, 0].numpy(), np.asarray(jpre.logits_last),
                               **LOGITS_TOL)


@contextlib.contextmanager
def jax_prefill_on_kernel_path():
    """JAX's prefill through its Pallas K1 in interpret mode (its TPU path,
    as ``tests/test_torch_minference.py`` runs it), 64-row blocks."""
    j_kernel, j_prefill = jflash.flash_prefill_attention_batched, jllama.prefill

    def j_interp(*a, **kw):
        kw.update(interpret=True, q_block=64, kv_block=64)
        return j_kernel(*a, **kw)

    def j_prefill_on_tpu_path(*a, **kw):
        with mock.patch.object(jax, "default_backend", lambda: "tpu"):
            return j_prefill(*a, **kw)

    with mock.patch.object(jflash, "flash_prefill_attention_batched", j_interp), \
            mock.patch.object(jllama, "prefill", j_prefill_on_tpu_path):
        yield


@pytest.mark.parametrize("D", [pytest.param(256, id="d256"), pytest.param(384, id="d384")])
def test_head_dim_256_int8_per_token_matches_jax(D):
    """A tiny head_dim 256 (and 384) model over the per-token int8 cache (K1
    and K3 at that head_dim) against JAX's per-token path: its prefill on
    the Pallas kernel in interpret mode, the cache quantized whole
    (``from_packed_prefill_tpu``), and its decode step with the Pallas K3
    in interpret mode; the port's ``generate`` builds ``Int8KVCache``, as
    the JAX rule (``head_dim % 128 == 0``) does.  Streams identical, lengths
    equal, first-token logits within 1e-4."""
    m = _model(dict(D256, head_dim=D))
    qcfg = tcfg.QuantConfig(nbits=8)
    assert qcfg.per_token(D)
    jcomp, tcomp = jcfg.CompressionConfig(**SNAPKV), tcfg.CompressionConfig(**SNAPKV)
    cap, max_new = 128, 5
    step = jax.jit(lambda p, tok, c: jllama.decode_step(
        p, m["jc"], tok, c, quant=jcfg.QuantConfig(nbits=8), pallas_interpret=True))
    with jax_prefill_on_kernel_path():
        res = jllama.prefill(m["jp"], m["jc"], jcomp, jnp.asarray(m["toks"]),
                             jnp.asarray(m["lens"]), cap)
    c = res.cache
    cache = jq.from_packed_prefill_tpu(c.k, c.v, c.lengths, c.positions)
    logits = [np.asarray(res.logits_last)]
    for _ in range(max_new - 1):
        tok = jnp.asarray(logits[-1].argmax(-1), jnp.int32)
        lg, cache = step(m["jp"], tok, cache)
        logits.append(np.asarray(lg))
    want = np.stack(logits, axis=1).argmax(-1)
    tres = tgenerate.generate(m["tp"], m["tc"], tcomp,
                              tcfg.GenerationConfig(max_new_tokens=max_new), m["toks"],
                              m["lens"], cap, quant_cfg=qcfg, device="cpu",
                              return_logits=True)
    assert isinstance(tres.cache, tq.Int8KVCache)
    np.testing.assert_array_equal(tres.tokens.numpy(), want)
    np.testing.assert_array_equal(tres.cache.lengths.numpy(), np.asarray(cache.lengths))
    np.testing.assert_allclose(tres.logits[:, 0].numpy(), logits[0], **LOGITS_TOL)


# --- the entry point and scale a head_dim takes on the card ---------------------


class _StubLib:
    """A kernel library whose entry points record their arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("kvcf_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def _stub_device(monkeypatch, mod):
    """Let a meta tensor through ``mod``'s kernel path to a stubbed library:
    no device check, no CUDA stream or device, 132 SMs.  Returns the stub."""
    lib = _StubLib()
    monkeypatch.setattr(tflash._build, "load", lambda name: lib)
    monkeypatch.setattr(mod, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: mock.Mock(cuda_stream=0))
    return lib


@pytest.mark.parametrize("D,width", [(80, 128), (16, 64), (160, 256), (392, 512)])
def test_k1_stub_takes_the_instantiation_and_the_true_scale(D, width, monkeypatch):
    """On a tensor off the CPU, K1 at head_dim ``D`` calls the entry point of
    the narrowest instantiation at least as wide, with ``D`` and ``D **
    -0.5`` (not the instantiation's scale) as its last two numbers."""
    lib = _stub_device(monkeypatch, tflash)
    monkeypatch.setattr(tflash.flash_prefill_attention, "launches", 0)
    monkeypatch.setattr(tflash.flash_prefill_attention, "variant_launches",
                        dict.fromkeys(tflash.flash_prefill_attention.variant_launches, 0))
    q = torch.empty(1, 2, 64, D, dtype=torch.bfloat16, device="meta")
    tflash.flash_prefill_attention(q, q, q, torch.empty(1, dtype=torch.int32, device="meta"), 8)
    (name, args), = lib.calls
    assert name == f"kvcf_flash_prefill_d{width}" and tflash.instance(D) == width
    assert args[-3] == D and args[-2] == D ** -0.5 and args[-2] != width ** -0.5


@pytest.mark.parametrize("D,width", [(80, 128), (16, 64), (160, 256), (392, 512)])
def test_k2_stub_takes_the_instantiation_and_the_true_scale(D, width, monkeypatch):
    """As K1's: K2 at head_dim ``D`` calls the narrowest wider instantiation
    with ``D`` and ``D ** -0.5``, and sizes its partials at the
    instantiation's width."""
    lib = _stub_device(monkeypatch, tdecode)
    monkeypatch.setattr(tdecode.decode_attention_append, "launches", 0)
    monkeypatch.setattr(tdecode, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(tdecode, "_counters",
                        lambda dev, H: torch.zeros(H, dtype=torch.int32, device="meta"))
    m = dict(dtype=torch.bfloat16, device="meta")
    H, G, C = 2, 4, 16
    tdecode.decode_attention_append(
        torch.empty(H, G, D, **m), torch.empty(H, C, D, **m), torch.empty(H, C, D, **m),
        torch.empty(H, dtype=torch.int32, device="meta"), torch.empty(H, D, **m),
        torch.empty(H, D, **m))
    (name, args), = lib.calls
    assert name == f"kvcf_decode_attn_append_d{width}"
    assert args[-3] == D and args[-2] == D ** -0.5
    n_split = args[-4]
    assert n_split == tdecode.split_count(H, C, 132, tdecode.CTAS_PER_SM_AT[width])
