"""K3 and K4's plain versions, and the quantized decode path, against the
JAX package.

Kernel level: the port's wrappers run their plain versions on CPU tensors;
the JAX kernels run in interpret mode, as ``tests/test_kernels.py`` runs
them; ``quant_cache_from_jax`` carries one cache across, so both read the
same codes and scalars.  Model level: a 2-layer fp32 model (as in
``tests/test_torch_generate.py``), with the JAX cache built by
``from_packed_prefill_tpu*`` from a JAX ``prefill(quant=None)`` and
``decode_step(..., quant=..., pallas_interpret=True)``, as
``tests/test_decode_tp.py`` does.

Tolerances, each with its reason:

- The port's plain versions against a float64 oracle over the same
  dequantized cache: fp32 against fp64, 1e-5 on outputs of order 1; a key
  range off by one moves a head's output by more than 1e-3 here (checked).
- K3 against the TPU kernel: both compute in fp32 from the same codes; the
  TPU kernel folds the affine into the dots (``(q . c) ks + sum(q) kz``
  over codes up to 255), so the two differ by a few fp32 ulps of terms of
  order 10: 1e-5.
- The range case (q up to about 1e5, keys of 1e-4, values spanning 1e-3:
  outputs of order 1e-4) holds the same relations relative to its largest
  output: 1e-6 of it against the oracle (fp32 against fp64), 4e-6 of it
  for K3 against the TPU kernel, whose folded affine there adds terms of
  order 100 (ks (q . c) and kz sum(q)) that cancel to logits of order 3, so
  fp32 rounding of those terms moves a logit by a few 1e-6; an off-by-one
  range must move a head by ten times the oracle's limit.  K4's limit below
  is relative to the value span already.
- K4 against the TPU kernel: the TPU kernel also rounds the probability
  weights ``p * v_scale`` to bf16 before its value dot
  (``decode_attn_quant.py:692-693``), a relative error of at most 2^-9 per
  weight, and q to bf16 (:615), which these tests avoid by giving
  bf16-exact q.  The weight roundings move an output channel by at most
  2^-9 * sum_j p_j |vs_j c_j| <= 2^-9 * the largest value span (about 18
  here, so 0.035).
- The appended codes and bf16 scalars are the same IEEE operations on both
  sides and must agree byte for byte.
- Model logits, int8: 1e-4, as the dense path's (fp32 summation order over
  two layers and the lm_head); token streams are exact.
- Model logits, int4: the TPU K4 rounds q (not bf16-exact inside a model)
  and the weights ``p * v_scale`` to bf16, 2^-9 relative each, in every
  layer, and the second layer starts from the first one's error: the
  limit is 2e-2 relative L2 per logits row (10 x 2^-9) and 0.03 on any
  one logit.  Token streams agree up to the first step where the JAX
  logits' top two are within 0.06 of each other (twice that 0.03); past
  such a near-tie the two loops feed back different tokens and are not
  compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.cache import quant_cache as jq
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.ops.kernels import decode_attn_quant as jdq
from kvcache_factory_tpu.runtime import engine as jengine
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.cache import quant_cache as tq
from kvcache_factory_tpu_torch.models import llama as tllama
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.ops.kernels import decode_attn_quant as tdq
from kvcache_factory_tpu_torch.runtime import engine as tengine
from kvcache_factory_tpu_torch.runtime import generate as tgenerate

D = 128
JAX_PREFILL = {8: jq.from_packed_prefill_tpu, 4: jq.from_packed_prefill_tpu4}
JAX_KERNEL = {8: jdq.quant_decode_attention_append_stacked,
              4: jdq.quant4_decode_attention_append_stacked}
PORT_KERNEL = {8: tdq.quant_decode_attention_append, 4: tdq.quant4_decode_attention_append}
V_SPAN = 3.0  # values are 3 x N(0, 1): spans of about 18


def t(x):
    return torch.from_numpy(np.array(x))


def bf16_exact(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def carried(jax_arrays, nbits):
    """Layer 0 of a carried-across cache: codes and scales [H, C, ...]."""
    kc, vc, sc = jax_arrays
    H = kc.shape[1]
    c = tq.quant_cache_from_jax(np.asarray(kc)[None], np.asarray(vc)[None],
                                np.asarray(sc)[None], np.zeros((1, 1, H)), np.zeros(1),
                                nbits)
    return c.k_codes[0, 0], c.v_codes[0, 0], c.scales[0, 0]


def oracle(q, k, v, lens, lower, k_new, v_new):
    """float64 attention over dequantized keys ``lower <= idx < min(len,
    C-1)`` plus the new token."""
    H, G, _ = q.shape
    C = k.shape[1]
    out = np.zeros((H, G, D))
    for h in range(H):
        L = min(int(lens[h]), C - 1)
        lo = 0 if lower is None else int(lower[h])
        keys = np.concatenate([k[h, lo:L], k_new[h][None]]).astype(np.float64)
        vals = np.concatenate([v[h, lo:L], v_new[h][None]]).astype(np.float64)
        s = q[h].astype(np.float64) @ keys.T / np.sqrt(D)
        p = np.exp(s - s.max(-1, keepdims=True))
        out[h] = (p / p.sum(-1, keepdims=True)) @ vals
    return out


# Standard deviations of q, K and V in the cases below.
UNIT = (1.0, 1.0, V_SPAN)
# The range the CUDA K3 must survive: q entries up to about 1e5, beyond
# fp16's 65504; keys of about 1e-4, so that logits stay of order 3 (with
# O(1) keys a q this large would test fp32 rounding in the softmax, not
# range); values spanning about 1e-3, so that v_scale is about 4e-6 and
# p * v_scale falls below fp16's smallest normal, 6.1e-5.
RANGE = (3e4, 1e-4, 2e-4)

CASES = [
    # G, lengths (C = 256), lower, (q, K, V) standard deviations
    pytest.param(1, [0, 5, 131, 254], None, UNIT,    # empty, ragged, int4 high half, C-2
                 id="1-lengths0-None"),
    pytest.param(4, [3, 100, 200, 130], [0, 20, 150, 0], UNIT,  # grouped queries, lower bounds
                 id="4-lengths1-lower1"),
    pytest.param(1, [256, 10, 255, 256], None, UNIT,  # full heads: slot C-1 overwritten
                 id="1-lengths2-None"),
    pytest.param(3, [40, 256, 7, 199], [0, 100, 6, 30], UNIT,  # G 3 (K3/K4 take 1-8), one key
                 id="3-lengths3-lower3"),
    pytest.param(6, [255, 64, 0, 128], [200, 0, 0, 127], UNIT,  # G 6, a lower bound near L
                 id="6-lengths4-lower4"),
    pytest.param(2, [200, 37, 256, 1], [0, 5, 0, 0], RANGE, id="range"),
]


@pytest.mark.parametrize("G,lengths,lower,amp", CASES)
@pytest.mark.parametrize("nbits", [8, 4])
def test_plain_matches_pallas(nbits, G, lengths, lower, amp):
    H, C = 4, 256
    rng = np.random.default_rng(5)
    q_amp, k_amp, v_amp = amp
    q = bf16_exact((q_amp * rng.standard_normal((H, G, D))).astype(np.float32))
    k_fp = (k_amp * rng.standard_normal((H, C, D))).astype(np.float32)
    v_fp = (v_amp * rng.standard_normal((H, C, D))).astype(np.float32)
    kn = (k_amp * rng.standard_normal((H, D))).astype(np.float32)
    vn = (v_amp * rng.standard_normal((H, D))).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    lo = None if lower is None else np.asarray(lower, np.int32)
    jc = JAX_PREFILL[nbits](jnp.asarray(k_fp)[None, None], jnp.asarray(v_fp)[None, None],
                            jnp.zeros((1, 1, H), jnp.int32), jnp.zeros((1,), jnp.int32))
    arrays = (jc.k_codes[0], jc.v_codes[0], jc.scales[0])  # [Lyr=1, H, ...]
    k_deq, v_deq = (np.asarray(a)[0, 0] for a in tq.dequantize_kv(
        tq.quant_cache_from_jax(*(np.asarray(a) for a in jc), nbits=nbits)))

    kc, vc, sc = carried(arrays, nbits)
    out = PORT_KERNEL[nbits](t(q), kc, vc, sc, t(lens), t(kn), t(vn),
                             None if lo is None else t(lo))
    j_out, j_kc, j_vc, j_sc, j_lens = JAX_KERNEL[nbits](
        jnp.asarray(q), *arrays, jnp.asarray(lens), jnp.zeros((1,), jnp.int32),
        jnp.asarray(kn), jnp.asarray(vn), interpret=True,
        lower=None if lo is None else jnp.asarray(lo))

    want = oracle(q, k_deq, v_deq, lens, lo, kn, vn)
    # The range case's outputs are of order 1e-4: its limits are relative to
    # the largest output (see the module docstring).
    top = 1.0 if amp == UNIT else np.abs(want).max()
    tol = 1e-5 if amp == UNIT else 1e-6 * top
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=tol)
    span = (v_deq.max(-1) - v_deq.min(-1)).max()
    atol = (1e-5 if amp == UNIT else 4e-6 * top) if nbits == 8 else 2.0 ** -9 * span
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=atol)
    # The append: the new token's codes and scalars in slot min(len, C-1),
    # byte for byte, and nothing else touched.
    for got, j in zip((kc, vc, sc), carried((j_kc, j_vc, j_sc), nbits)):
        assert torch.equal(got, j)
    np.testing.assert_array_equal(np.minimum(lens + 1, C), np.asarray(j_lens))
    # The oracle's tolerance is far tighter than what a key range off by
    # one shows (heads that read no key, or a full head, are left out).
    off = oracle(q, k_deq, v_deq, lens - 1, lo, kn, vn)
    moved = np.abs(off - want).max(axis=(1, 2))
    assert (moved[(lens > 0) & (lens < C)] > (1e-3 if amp == UNIT else 10 * tol)).all()


MODEL = dict(model_type="llama", vocab_size=512, hidden_size=256,
             intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=128, rope_theta=10000.0, dtype="float32")
COMP = dict(method="snapkv", max_capacity_prompt=64, window_size=8, kernel_size=7,
            pooling="maxpool", group_reduce="none")
S = 256  # prompt bucket
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
INT4_ROW_REL_L2 = 2e-2
INT4_MAX_ABS = 0.03
INT4_TIE_MARGIN = 2 * INT4_MAX_ABS


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"], size=n) for n in (200, 40)]
    toks = np.zeros((2, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    steps = {nbits: jax.jit(lambda p, tok, c, nbits=nbits: jllama.decode_step(
        p, jc, tok, c, quant=jcfg.QuantConfig(nbits=nbits), pallas_interpret=True))
        for nbits in (8, 4)}
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, toks=toks, lens=lens, steps=steps,
                jcomp=jcfg.CompressionConfig(**COMP), tcomp=tcfg.CompressionConfig(**COMP))


def _jax_prefill(s, nbits, toks, lens, cap):
    """The JAX package's quantized cache: dense prefill, quantized whole."""
    res = jllama.prefill(s["jp"], s["jc"], s["jcomp"], jnp.asarray(toks),
                         jnp.asarray(lens), cap)
    c = res.cache
    return res.logits_last, JAX_PREFILL[nbits](c.k, c.v, c.lengths, c.positions)


def _jax_greedy(s, nbits, toks, lens, cap, max_new):
    """Greedy tokens [B, max_new], the logits each was chosen from, and the
    final cache."""
    logits, cache = _jax_prefill(s, nbits, toks, lens, cap)
    all_logits = [np.asarray(logits)]
    for _ in range(max_new - 1):
        tok = jnp.asarray(all_logits[-1].argmax(-1), jnp.int32)
        logits, cache = s["steps"][nbits](s["jp"], tok, cache)
        all_logits.append(np.asarray(logits))
    all_logits = np.stack(all_logits, axis=1)
    return all_logits.argmax(-1), all_logits, cache


def assert_logits_match(got, want, nbits):
    if nbits == 8:
        np.testing.assert_allclose(got, want, **LOGITS_TOL)
    else:
        rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
        assert rel.max() < INT4_ROW_REL_L2, rel.max()
        assert np.abs(got - want).max() < INT4_MAX_ABS


def assert_same_stream(got, want, want_logits, nbits):
    """Token for token (int8), or up to the first JAX near-tie (int4)."""
    got = np.asarray(got)
    if nbits == 8:
        np.testing.assert_array_equal(got, want)
        return
    for b in range(want.shape[0]):
        apart = np.nonzero(got[b] != want[b])[0]
        if len(apart):
            top2 = np.sort(want_logits[b, apart[0]])[-2:]
            assert top2[1] - top2[0] < INT4_TIE_MARGIN, (b, apart[0], top2)


@pytest.mark.parametrize("nbits", [8, 4])
def test_teacher_forced_decode_matches_jax(setup, nbits):
    """Eight steps of forced tokens, each from the same cache on both sides
    (the JAX one carried across before the step): logits, lengths, and the
    cache after the step.  At int8 the two sides' new K/V agree to ~1e-6,
    so an appended code may move by one step where a value sits that close
    to a rounding edge.  At int4, from the second layer on, they differ by
    what the TPU K4's bf16 roundings did upstream (~1e-3 relative), which
    can also move a token's bf16 scale and zero by an ulp: two steps.
    Everything else in the cache is left as it was."""
    s = setup
    cap = 128 if nbits == 8 else 256
    _, jcache = _jax_prefill(s, nbits, s["toks"], s["lens"], cap)
    qcfg = tcfg.QuantConfig(nbits=nbits)
    forced = np.random.default_rng(1).integers(0, MODEL["vocab_size"], size=(8, 2))
    for tok in forced:
        tcache = tq.quant_cache_from_jax(*(np.asarray(a) for a in jcache), nbits=nbits)
        slot = torch.arange(cap) == tcache.lengths.clamp(max=cap - 1)[..., None]
        jlogits, jcache = s["steps"][nbits](s["jp"], jnp.asarray(tok, jnp.int32), jcache)
        tlogits, tcache = tllama.decode_step(s["tp"], s["tc"], torch.tensor(tok), tcache,
                                             quant=qcfg)
        assert_logits_match(tlogits.numpy(), np.asarray(jlogits), nbits)
        want = tq.quant_cache_from_jax(*(np.asarray(a) for a in jcache), nbits=nbits)
        np.testing.assert_array_equal(tcache.lengths.numpy(), want.lengths.numpy())
        np.testing.assert_array_equal(tcache.positions.numpy(), want.positions.numpy())
        for got, ref, col in zip(tq.dequantize_kv(tcache), tq.dequantize_kv(want), (0, 2)):
            diff = (got - ref).abs()
            step = want.scales[..., col, None].float()
            assert (diff <= (1.01 if nbits == 8 else 2) * step + 1e-6).all()
            assert not diff[~slot].any()


@pytest.mark.parametrize("nbits", [8, 4])
def test_generate_matches_jax_greedy_loop(setup, nbits):
    """The port's own quantized prefill and decode, token for token."""
    s = setup
    max_new, cap = 10, 128 if nbits == 8 else 256
    want, want_logits, jcache = _jax_greedy(s, nbits, s["toks"], s["lens"], cap, max_new)
    res = tgenerate.generate(s["tp"], s["tc"], s["tcomp"],
                             tcfg.GenerationConfig(max_new_tokens=max_new), s["toks"],
                             s["lens"], cap, quant_cfg=tcfg.QuantConfig(nbits=nbits),
                             device="cpu")
    assert isinstance(res.cache, tq.Int8KVCache if nbits == 8 else tq.Int4KVCache)
    assert_same_stream(res.tokens.numpy(), want, want_logits, nbits)
    np.testing.assert_array_equal(res.cache.lengths.numpy(), np.asarray(jcache.lengths))


@pytest.mark.parametrize("nbits", [8, 4])
def test_engine_matches_jax(setup, nbits):
    """The engine rounds the capacity as the JAX engine does, and its
    greedy streams match the JAX loop at that capacity."""
    s = setup
    kw = dict(prefill_buckets=(128, 256))
    qj, qt = jcfg.QuantConfig(nbits=nbits), tcfg.QuantConfig(nbits=nbits)
    jeng = jengine.InferenceEngine(
        s["jp"], jcfg.EngineConfig(model=s["jc"], compression=s["jcomp"], quant=qj, **kw))
    teng = tengine.InferenceEngine(
        s["tp"], tcfg.EngineConfig(model=s["tc"], compression=s["tcomp"], quant=qt, **kw),
        device="cpu")
    max_new = 8
    cap = jeng._cache_capacity(S, max_new)
    assert teng._cache_capacity(S, max_new) == cap == (128 if nbits == 8 else 256)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, MODEL["vocab_size"], size=n).tolist() for n in (230, 90)]
    toks = np.zeros((2, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    want, want_logits, _ = _jax_greedy(s, nbits, toks, np.asarray([230, 90], np.int32),
                                       cap, max_new)
    assert_same_stream(teng.generate_batch(prompts, max_new), want, want_logits, nbits)


@pytest.mark.parametrize("nbits", [8, 4])
def test_quantized_decode_logits_near_fp32_reference(nbits):
    """What quantization alone does to the logits, which sets the limits
    ``chip_smoke.py`` holds the card's quantized paths to: the port's fp32
    plain path, with a Mistral-shaped model cut to 2 layers and hidden 1024
    (8 query heads, 2 KV heads, head_dim 128), one 600-token prompt on the
    no-compress branch and 16 greedy steps, against the fp32 reference
    forward over the same tokens with an unquantized cache.  Each limit is
    at least 1.5 times the worst row seen here (printed with ``-s``)."""
    import chip_smoke
    from kvcache_factory_tpu_torch.models.reference import forward_logits
    from kvcache_factory_tpu_torch.models.weights import init_params

    cfg = tcfg.ModelConfig(model_type="mistral", vocab_size=2048, hidden_size=1024,
                           intermediate_size=3584, num_hidden_layers=2,
                           num_attention_heads=8, num_key_value_heads=2,
                           rope_theta=1e6, dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    eng = tengine.InferenceEngine(
        params, tcfg.EngineConfig(model=cfg, compression=tcfg.CompressionConfig(**{
            **COMP, "max_capacity_prompt": 2048}), quant=tcfg.QuantConfig(nbits=nbits),
            prefill_buckets=(1024,)), device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=600).tolist()
    steps = 16
    ids, res = eng.generate_batch([prompt], steps + 1, return_result=True)
    ref = forward_logits(params, cfg, torch.tensor([prompt + ids[0][:steps]]))[0, len(prompt) - 1:]
    rel = (res.logits[0] - ref).norm(dim=-1) / ref.norm(dim=-1)
    print(f"int{nbits}: prefill row rel L2 {rel[0].item():.3e}, decode worst "
          f"{rel[1:].max().item():.4f}, mean {rel[1:].mean().item():.4f}")
    assert rel[0] < 1e-5  # prefill is not quantized
    assert rel[1:].max() < chip_smoke.E2E_QUANT_REL_L2_TOL[nbits] / 1.5
