"""MInference sparse prefill in the port against the JAX package.

On the CPU the port's K1 wrapper runs its plain version with the block mask;
the JAX package runs its Pallas kernel in interpret mode with 64-row blocks,
as ``tests/test_flash_prefill.py`` runs it (inside ``prefill`` the backend
reads ``"tpu"`` so that the kernel path, not the dense XLA one, is taken;
decode is left as it is).  The port's prefill then runs the pattern in the
same 64-row blocks.  Inputs are fp32 numpy arrays from
``np.random.default_rng``.  Tolerances: kernel outputs 2e-5 (fp32 against
fp32 in another summation order, the JAX kernel tests' own); logits 1e-4
(two layers and a 512-way lm_head sum); block masks and token streams
exact.

The vertical-slash masks rank columns and diagonals by fp32 sums that the
two frameworks add in different orders (~1e-7 relative).  The inputs plant
heavy key columns, so the ranks that decide a block stand far apart; random
inputs alone make every block dense at these sizes.
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
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.ops.kernels import flash_prefill as jflash
from kvcache_factory_tpu.policies import minference as jmin
from kvcache_factory_tpu.runtime import batching as jbatching
from kvcache_factory_tpu.runtime import engine as jengine
from kvcache_factory_tpu.runtime.generate import generate as jax_generate
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.models import llama as tllama
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.ops.kernels import _build
from kvcache_factory_tpu_torch.ops.kernels import flash_prefill as tflash
from kvcache_factory_tpu_torch.policies import minference as tmin
from kvcache_factory_tpu_torch.runtime import batching as tbatching
from kvcache_factory_tpu_torch.runtime import engine as tengine
from kvcache_factory_tpu_torch.runtime import generate as tgenerate

D = 128
BLOCK = 64
TOL = dict(rtol=2e-5, atol=2e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
VS = ("vertical_slash", 8, 2, 16)
BUDGETS = np.asarray([[2, 1], [8, 2], [1, 0], [4, 1]], np.int32)  # [Hq, 2] (v, s)


def t(x):
    return torch.from_numpy(np.array(x))


def planted(seed, B, Hq, Hkv, S):
    """q, k, v with eight heavy key columns (70..77) that every query
    favours: the vertical ranks and the diagonals through those columns
    stand far above the rest."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    q[..., :8] = np.abs(q[..., :8]) + 0.5
    k[:, :, 70:78, :8] = 3.0
    return q, k, v


# --- the budget loader -------------------------------------------------------

def test_load_sparse_budgets_matches_jax(tmp_path):
    """Clipping to the static sizes, and the full budget for a missing head,
    a missing layer and a pattern other than vertical_and_slash."""
    cfg = [{"0": ["vertical_and_slash", 1000, 6096, 1], "1": ["vertical_and_slash", 30, 7, 1],
            "2": ["stream_llm", 4, 64, 1], "7": ["vertical_and_slash", 5, 5, 1]},
           {"1": ["vertical_and_slash", 5, 5, 1], "3": ["block_sparse", 9]}]
    path = tmp_path / "pattern.json"
    path.write_text(json.dumps(cfg))
    for L, H, v_cap, s_cap in ((3, 4, 64, 32), (1, 2, 8, 2)):
        got = tmin.load_sparse_budgets(str(path), L, H, v_cap, s_cap)
        want = jmin.load_sparse_budgets(str(path), L, H, v_cap, s_cap)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    bad = tmp_path / "bad.json"
    bad.write_text('{"not": "a list"}')
    with pytest.raises(ValueError, match="best-pattern schema"):
        tmin.load_sparse_budgets(str(bad), 1, 1, 8, 8)
    assert tmin.default_pattern() == jmin.default_pattern()


# --- the block mask -----------------------------------------------------------

@pytest.mark.parametrize("S,tls,budgets", [
    (512, [512, 512], None),
    (512, [512, 390], BUDGETS),   # per-head budgets, a true_len short of S
    (456, [456, 300], None),      # S no multiple of the block: padded to 512
    (456, [231, 456], BUDGETS),
])
def test_vertical_slash_block_mask_matches_jax(S, tls, budgets):
    """Eight 64-row blocks (at four, the planted diagonals meet every causal
    block pair); the masks keep 58-73% of the causal block pairs."""
    B, Hq, Hkv = 2, 4, 2
    q, k, _ = planted(3, B, Hq, Hkv, S)
    hb = None if budgets is None else t(budgets)
    got, block = tflash.sparse_block_mask(t(q), t(k), t(np.asarray(tls, np.int32)), VS, hb,
                                          q_block=BLOCK)
    assert block == BLOCK and got.dtype == torch.int32 and got.shape == (B, Hq, 8, 8)
    pad = ((0, 0), (0, 512 - S), (0, 0))
    for b in range(B):
        want = jflash.vertical_slash_block_mask(
            jnp.asarray(np.pad(q[b], pad)), jnp.asarray(np.pad(k[b], pad)), jnp.int32(tls[b]),
            BLOCK, BLOCK, *VS[1:], head_budgets=None if budgets is None else jnp.asarray(budgets))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    # Sparse: some causal block pair is dropped; without budgets the planted
    # columns' block is kept for every q block.
    causal = np.tril(np.ones((8, 8), bool))
    assert (got.numpy()[:, :, causal] == 0).any()
    if budgets is None:
        assert (got.numpy()[:, :, :, 1] == 1).all()


def test_vertical_slash_block_mask_estimation_rows_past_the_prompt():
    """``last_q`` longer than the prompt (120 > S = 100, padded to 128): the
    estimation rows past S are JAX's zero rows, which the port never reads
    (they lie at or past ``true_len`` and give no mass)."""
    S, tls, pattern = 100, [100, 70], ("vertical_slash", 8, 2, 120)
    q, k, _ = planted(5, 2, 4, 2, S)
    got, _ = tflash.sparse_block_mask(t(q), t(k), t(np.asarray(tls, np.int32)), pattern,
                                      q_block=BLOCK)
    pad = ((0, 0), (0, 128 - S), (0, 0))
    for b in range(2):
        want = jflash.vertical_slash_block_mask(
            jnp.asarray(np.pad(q[b], pad)), jnp.asarray(np.pad(k[b], pad)), jnp.int32(tls[b]),
            BLOCK, BLOCK, *pattern[1:])
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_ashape_block_mask_rule():
    """Both tuple forms give JAX's a-shape rule (``flash_prefill.py:230``)
    with the q block's own index as the diagonal, the same for every head."""
    q = torch.zeros(2, 4, 256, D)
    for pattern in (("ashape", 1, 2, 3), (1, 2, 3)):
        mask, block = tflash.sparse_block_mask(q, q[:, :2], torch.tensor([256, 100]), pattern,
                                               q_block=BLOCK)
        i, j = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
        want = (j < 1) | (j > i - 2) | (j % 3 == 0)
        assert block == BLOCK
        np.testing.assert_array_equal(mask.numpy(), np.broadcast_to(want, (2, 4, 4, 4)))
    # The default pattern block is 1024, clipped to S.
    assert tflash.sparse_block_mask(q, q, torch.tensor([256, 100]), (1, 2, 3))[1] == 256


# --- K1-sparse's plain version against the Pallas kernel -----------------------

@pytest.mark.parametrize("S,tls,G,pattern,window,sw,budgets", [
    (256, [256, 181], 2, ("ashape", 1, 1, 2), 8, None, None),
    (256, [256, 181], 2, (1, 1, 2), 0, None, None),               # the bare form
    (256, [256, 190], 2, VS, 8, None, BUDGETS),                   # scores of the sparse softmax
    (256, [256, 200], 1, ("ashape", 1, 2, 3), 0, 100, None),      # with a sliding window
    (256, [240, 256], 2, VS, 0, 90, None),
    (200, [200, 130], 2, ("ashape", 1, 1, 2), 8, None, None),     # S no multiple of the block
])
def test_sparse_plain_matches_pallas(S, tls, G, pattern, window, sw, budgets):
    """The wrapper (plain version on the CPU, its own mask) and the plain
    version fed the JAX mask agree with the JAX kernel on each example's
    valid rows and scored columns."""
    B, Hq = 2, 4
    q, k, v = planted(5, B, Hq, Hq // G, S)
    tl = np.asarray(tls, np.int32)
    hb = None if budgets is None else t(budgets)
    out, scores = tflash.flash_prefill_attention(
        t(q), t(k), t(v), t(tl), window, sliding_window=sw, sparse_pattern=pattern,
        sparse_head_budgets=hb, q_block=BLOCK)
    j_out, j_scores = jflash.flash_prefill_attention_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), window,
        q_block=BLOCK, kv_block=BLOCK, interpret=True, sparse_pattern=pattern,
        sliding_window=sw, sparse_head_budgets=None if budgets is None else jnp.asarray(budgets))
    outs = [out]
    if pattern[0] == "vertical_slash":
        pad = ((0, 0), (0, 0), (0, 256 - S), (0, 0))
        jmask = jax.vmap(lambda qe, ke, te: jflash.vertical_slash_block_mask(
            qe, ke, te, BLOCK, BLOCK, *pattern[1:],
            head_budgets=None if budgets is None else jnp.asarray(budgets)))(
            jnp.asarray(np.pad(q, pad)), jnp.asarray(np.pad(k, pad)), jnp.asarray(tl))
        outs.append(tflash.flash_prefill_attention_reference(
            t(q), t(k), t(v), t(tl), window, sliding_window=sw,
            block_mask=t(np.asarray(jmask)), block=BLOCK)[0])
    for o in outs:
        for b, n in enumerate(tls):
            np.testing.assert_allclose(o[b, :, :n].numpy(), np.asarray(j_out)[b, :, :n], **TOL)
    for b, n in enumerate(tls):
        np.testing.assert_allclose(scores[b, :, :n - window].numpy(),
                                   np.asarray(j_scores)[b, :, :n - window], **TOL)
    # The pattern dropped something: the dense call differs.
    dense, _ = tflash.flash_prefill_attention(t(q), t(k), t(v), t(tl), window,
                                              sliding_window=sw)
    assert not torch.allclose(dense[0, :, :tls[0]], out[0, :, :tls[0]], atol=1e-3)


@pytest.mark.parametrize("call,match", [
    (dict(window=0, row_offset=0), "whole-sequence"),           # no sparse chunk mode
    (dict(window=0, sparse_pattern=("diagonal", 1, 2, 3)), "unknown sparse pattern"),
    (dict(window=0, sparse_pattern=("vertical_slash", 8, 2, 128)), "last_q"),
])
def test_sparse_contract(call, match):
    """JAX's asserts: no sparse pattern in chunk mode; and the patterns the
    port knows, with an estimation window inside the padded sequence."""
    call.setdefault("sparse_pattern", ("ashape", 1, 1, 2))
    q = torch.zeros(1, 2, 64, D)
    with pytest.raises(ValueError, match=match):
        tflash.flash_prefill_attention(q, q, q, torch.tensor([64], dtype=torch.int32), **call)


def test_sparse_call_on_the_card_never_falls_back(monkeypatch):
    """A sparse call off the CPU builds its mask and then reaches the
    kernel: a failed build raises, and no launch is counted."""
    def failing_load(name):
        raise _build.KernelBuildError(f"stubbed build failure for {name}")

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("the wrapper fell back to its plain version")

    monkeypatch.setattr(_build, "load", failing_load)
    monkeypatch.setattr(tflash, "flash_prefill_attention_reference", plain_must_not_run)
    q = torch.empty(1, 2, 128, D, dtype=torch.bfloat16, device="meta")
    before = dict(tflash.flash_prefill_attention.variant_launches)
    with pytest.raises(_build.KernelBuildError, match="stubbed"):
        tflash.flash_prefill_attention(q, q, q, torch.empty(1, dtype=torch.int32, device="meta"),
                                       0, sparse_pattern=("ashape", 1, 1, 2), q_block=BLOCK)
    assert tflash.flash_prefill_attention.variant_launches == before


# --- the model path ------------------------------------------------------------

MODEL = dict(model_type="llama", vocab_size=512, hidden_size=256,
             intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=128, rope_theta=10000.0, dtype="float32")
S = 256


@contextlib.contextmanager
def sparse_blocks():
    """JAX's prefill through the Pallas kernel in interpret mode with 64-row
    blocks (as ``tests/test_flash_prefill.py:307-356``), its decode left as
    it is; the port's prefill with the pattern in 64-row blocks too."""
    j_kernel, j_prefill, t_kernel = (jflash.flash_prefill_attention_batched, jllama.prefill,
                                     tllama.flash_prefill_attention)

    def j_interp(*a, **kw):
        kw.update(interpret=True, q_block=BLOCK, kv_block=BLOCK)
        return j_kernel(*a, **kw)

    def j_prefill_on_tpu_path(*a, **kw):
        with mock.patch.object(jax, "default_backend", lambda: "tpu"):
            return j_prefill(*a, **kw)

    def t_blocks(*a, **kw):
        return t_kernel(*a, **dict(kw, q_block=BLOCK))

    with mock.patch.object(jflash, "flash_prefill_attention_batched", j_interp), \
            mock.patch.object(jllama, "prefill", j_prefill_on_tpu_path), \
            mock.patch.object(tllama, "flash_prefill_attention", t_blocks):
        yield


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    lens = np.asarray([256, 170], np.int32)
    toks = np.zeros((2, S), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, MODEL["vocab_size"], size=n)
    budgets = np.stack([BUDGETS, BUDGETS[::-1]])  # [L, Hq, 2]
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, toks=toks, lens=lens, budgets=budgets)


def comps(method, pattern, **kw):
    return (jcfg.CompressionConfig(method=method, sparse_prefill=pattern, **kw),
            tcfg.CompressionConfig(method=method, sparse_prefill=pattern, **kw))


@pytest.mark.parametrize("method,pattern,with_budgets", [
    ("minference", ("ashape", 1, 1, 2), False),
    ("minference", ("vertical_slash", 2, 1, 16), False),
    ("minference", ("vertical_slash", 16, 4, 16), True),
    ("snapkv", ("vertical_slash", 2, 1, 16), False),  # window scores of the sparse softmax
])
def test_prefill_matches_jax(model, method, pattern, with_budgets):
    """Logits and the cache against JAX, and unlike the dense prefill's.  At
    four 64-row blocks this model's vertical-slash masks keep 90-95% of the
    causal block pairs; the closest vertical ranks at a kept boundary stand
    4.4e-3 apart (relative), far above the frameworks' fp32 differences."""
    m = model
    kw = dict(max_capacity_prompt=64, window_size=8, kernel_size=7, pooling="maxpool") \
        if method == "snapkv" else {}
    jcomp, tcomp = comps(method, pattern, **kw)
    cap = jcomp.layer_capacity(2, S) + 9
    sb = m["budgets"] if with_budgets else None
    with sparse_blocks():
        jres = jllama.prefill(m["jp"], m["jc"], jcomp, jnp.asarray(m["toks"]),
                              jnp.asarray(m["lens"]), cap,
                              sparse_budgets=None if sb is None else jnp.asarray(sb))
        tflash.reset_launches()
        tres = tllama.prefill(m["tp"], m["tc"], tcomp, t(m["toks"]), t(m["lens"]), cap,
                              sparse_budgets=None if sb is None else t(sb))
        dense = tllama.prefill(m["tp"], m["tc"], tcfg.CompressionConfig(**dict(
            kw, method=method)), t(m["toks"]), t(m["lens"]), cap)
    np.testing.assert_allclose(tres.logits_last.numpy(), np.asarray(jres.logits_last),
                               **LOGITS_TOL)
    assert not np.allclose(dense.logits_last.numpy(), tres.logits_last.numpy(), atol=1e-3)
    lens = np.asarray(jres.cache.lengths)
    np.testing.assert_array_equal(tres.cache.lengths.numpy(), lens)
    jk = np.asarray(jres.cache.k)
    for li in range(2):
        for b in range(2):
            for h in range(lens.shape[2]):
                n = lens[li, b, h]
                np.testing.assert_allclose(tres.cache.k[li, b, h, :n].numpy(),
                                           jk[li, b, h, :n], rtol=1e-5, atol=1e-5)
    if method == "minference":  # the full KV, at the KV heads
        assert lens.shape[2] == 2 and (lens[:, 0] == 256).all() and (lens[:, 1] == 170).all()


def test_generate_and_engine_match_jax(model):
    """Greedy streams of ``generate`` and of ``InferenceEngine`` with
    per-layer budgets, token for token."""
    m = model
    jcomp, tcomp = comps("minference", ("vertical_slash", 2, 1, 16))
    max_new = 6
    cap = S + max_new + 1
    gen_j, gen_t = jcfg.GenerationConfig(max_new_tokens=max_new), \
        tcfg.GenerationConfig(max_new_tokens=max_new)
    prompts = [m["toks"][i, :n].tolist() for i, n in enumerate(m["lens"])]
    kw = dict(prefill_buckets=(128, 256))
    with sparse_blocks():
        jres = jax_generate(m["jp"], m["jc"], jcomp, gen_j, jnp.asarray(m["toks"]),
                            jnp.asarray(m["lens"]), cap)
        tres = tgenerate.generate(m["tp"], m["tc"], tcomp, gen_t, m["toks"], m["lens"], cap,
                                  device="cpu")
        jeng = jengine.InferenceEngine(m["jp"], jcfg.EngineConfig(model=m["jc"],
                                                                  compression=jcomp, **kw),
                                       sparse_budgets=m["budgets"])
        teng = tengine.InferenceEngine(m["tp"], tcfg.EngineConfig(model=m["tc"],
                                                                  compression=tcomp, **kw),
                                       device="cpu", sparse_budgets=m["budgets"])
        want = jeng.generate_batch(prompts, max_new)
        got = teng.generate_batch(prompts, max_new)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.cache.lengths.numpy(), np.asarray(jres.cache.lengths))
    assert got == want


def test_batching_one_shot_matches_jax_and_chunked_refuses(model):
    """One-shot admission runs minference, token for token with the JAX
    engine (after ``tests/test_batching.py:141``); chunked admission refuses
    it, as the JAX engine does."""
    m = model
    jcomp, tcomp = comps("minference", ("ashape", 1, 1, 2))
    kw = dict(n_slots=2, max_new_cap=5, chunk_size=4)
    buckets = (128, 256)
    prompts = [m["toks"][0].tolist(), m["toks"][1, :170].tolist(), m["toks"][1, :90].tolist()]
    with sparse_blocks():
        jeng = jbatching.ContinuousBatchingEngine(
            m["jp"], jcfg.EngineConfig(model=m["jc"], compression=jcomp,
                                       prefill_buckets=buckets), **kw)
        jr = [jeng.submit(p, 5) for p in prompts]
        jout = jeng.run()
        teng = tbatching.ContinuousBatchingEngine(
            m["tp"], tcfg.EngineConfig(model=m["tc"], compression=tcomp,
                                       prefill_buckets=buckets), device="cpu", **kw)
        tr = [teng.submit(p, 5) for p in prompts]
        tout = teng.run()
    assert [tout[r] for r in tr] == [jout[r] for r in jr]
    with pytest.raises(NotImplementedError, match="one-shot path"):
        tbatching.ContinuousBatchingEngine(
            m["tp"], tcfg.EngineConfig(model=m["tc"], compression=tcomp,
                                       prefill_buckets=buckets), device="cpu",
            prefill_chunk_tokens=64, **kw)
