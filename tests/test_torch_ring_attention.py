"""K1-ml (``flash_prefill_attention(..., return_ml=True)``) and the port's
ring attention against the JAX package.

On the CPU K1-ml runs its plain version; the JAX kernel runs in interpret
mode and JAX's ring on the virtual CPU mesh, as ``tests/test_ring_attention.py``
runs them.  Inputs are fp32 numpy arrays from ``np.random.default_rng``.
fp32 against fp32 in another summation order agrees to ~1e-6: ``out`` and
``m`` are held to 2e-5 and ``l`` (a sum of up to a few hundred terms of
order 1) to 2e-5 relative, the JAX kernel tests' tolerance; the folds to
3e-5, the JAX ring tests' own.  The ring over spawned gloo ranks runs the
single-process fold's arithmetic rank by rank; only the ranks' BLAS
threading may reorder a sum, so it is held to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_sp_worker
from kvcache_factory_tpu.ops.kernels import flash_prefill as jflash
from kvcache_factory_tpu.parallel.ring_attention import make_ring_attention
from kvcache_factory_tpu_torch.ops.attention import NEG_INF
from kvcache_factory_tpu_torch.ops.kernels import _build
from kvcache_factory_tpu_torch.ops.kernels import flash_prefill as tflash
from kvcache_factory_tpu_torch.parallel.ring_attention import (hop_visible,
                                                                ring_attention_emulated,
                                                                ring_hop_fold)

D = 128
TOL = dict(rtol=2e-5, atol=2e-5)
FOLD_TOL = dict(rtol=3e-5, atol=3e-5)


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


# (B, Hq, Hkv, S_q, S_k, true_len, row_offset, sliding_window, kernel block)
ML_CASES = {
    # whole-sequence queries, true_len 200 of 256
    "whole": (1, 4, 2, 256, 256, [200], None, None, 64),
    # chunk mode: offsets off the tile, a short example
    "chunk": (2, 4, 2, 64, 256, [256, 190], [100, 37], None, 64),
    # rank 1's hop over shard 0 of a 512-row ring at SW 80 and 64-row
    # blocks (tests/test_ring_attention.py:123-149): its upper rows' windows
    # start past the shard, so they see no column at all
    "sw_hop": (2, 4, 2, 256, 256, [512, 470], [256, 256], 80, 64),
}


@pytest.mark.parametrize("case", sorted(ML_CASES))
def test_return_ml_plain_matches_pallas(case):
    """K1-ml's plain version against the Pallas kernel's ``return_ml`` in
    interpret mode: ``out``, ``m`` and ``l`` on every valid row that sees a
    column.  A row that sees none reads ``m = NEG_INF`` on both sides;
    there the port gives ``l = 0`` and a zero output (JAX: the folded
    column count and their mean value), which the fold weighs to zero
    either way."""
    B, Hq, Hkv, S_q, S_k, tls, offsets, sw, blk = ML_CASES[case]
    rng = np.random.default_rng(23)
    q = normal(rng, B, Hq, S_q, D)
    k, v = normal(rng, B, Hkv, S_k, D), normal(rng, B, Hkv, S_k, D)
    tl = np.asarray(tls, np.int32)
    off = None if offsets is None else np.asarray(offsets, np.int32)
    out, _, m, l = tflash.flash_prefill_attention(
        t(q), t(k), t(v), t(tl), 0, sliding_window=sw,
        row_offset=None if off is None else t(off), return_ml=True)
    j_out, _, j_m, j_l = jflash.flash_prefill_attention_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl), 0, q_block=blk,
        kv_block=blk, interpret=True, sliding_window=sw,
        row_offset=None if off is None else jnp.asarray(off), return_ml=True)
    j_out, j_m, j_l = np.asarray(j_out), np.asarray(j_m), np.asarray(j_l)
    out, m, l = out.numpy(), m.numpy(), l.numpy()
    rows = (np.zeros(B, np.int64) if off is None else off)[:, None] + np.arange(S_q)[None]
    valid = np.broadcast_to((rows < tl[:, None])[:, None], m.shape)
    seen = valid & (m > NEG_INF)
    np.testing.assert_array_equal(seen, valid & (j_m > NEG_INF))
    np.testing.assert_allclose(out[seen], j_out[seen], **TOL)
    np.testing.assert_allclose(m[seen], j_m[seen], **TOL)
    np.testing.assert_allclose(l[seen], j_l[seen], rtol=2e-5)
    empty = valid & ~seen
    assert (l[empty] == 0).all() and (out[empty] == 0).all()
    if case == "sw_hop":
        assert empty.any() and seen.any()
    else:
        assert not empty.any()


@pytest.mark.parametrize("call,match", [
    (dict(window=8), "dense-attention feature"),
    (dict(window=0, sparse_pattern=("ashape", 1, 1, 2)), "dense-attention feature"),
])
def test_return_ml_keeps_the_jax_contract(call, match):
    """``return_ml`` needs ``window=0`` and no sparse pattern
    (``flash_prefill.py:505-507``), on every device."""
    q = torch.zeros(1, 2, 64, D)
    with pytest.raises(ValueError, match=match):
        tflash.flash_prefill_attention(q, q, q, torch.tensor([64], dtype=torch.int32),
                                       return_ml=True, **call)


def test_return_ml_on_the_card_never_falls_back(monkeypatch):
    """A tensor off the CPU reaches the kernel: when the library fails to
    build, K1-ml raises instead of running the plain version, and counts
    no launch."""
    def failing_load(name):
        raise _build.KernelBuildError(f"stubbed build failure for {name}")

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("the wrapper fell back to its plain version")

    monkeypatch.setattr(_build, "load", failing_load)
    monkeypatch.setattr(tflash, "flash_prefill_attention_reference", plain_must_not_run)
    q = torch.empty(1, 2, 64, D, dtype=torch.bfloat16, device="meta")
    before = dict(tflash.flash_prefill_attention.variant_launches)
    with pytest.raises(_build.KernelBuildError, match="stubbed"):
        tflash.flash_prefill_attention(q, q, q, torch.empty(1, dtype=torch.int32, device="meta"),
                                       0, row_offset=64, return_ml=True)
    assert tflash.flash_prefill_attention.variant_launches == before
    assert tflash.variant(None, 64, None, True) == tflash.variant(80, None, None, True) == "ring"


def test_hop_visible_skips_later_and_out_of_window_shards():
    """JAX ``ring_attention.py:203-214``: at S_loc 64 and SW 70, rank 3's
    lowest window starts at 123, so shard 0 (columns up to 63) is skipped,
    shard 1 (up to 127) is not; shards after a rank's own never count."""
    assert not hop_visible(3, 0, 64, 70) and hop_visible(3, 1, 64, 70)
    assert hop_visible(2, 0, 64, 70) and hop_visible(3, 0, 64, None)
    assert not hop_visible(1, 2, 64, None)


def test_ring_hop_fold_of_two_halves_is_the_whole_softmax():
    """Folding two hops' (out, m, l) gives the softmax over both column
    sets, and a hop whose rows saw nothing (m = NEG_INF, l = 0) leaves the
    running state unchanged."""
    rng = np.random.default_rng(5)
    s = t(normal(rng, 3, 40))
    vals = t(normal(rng, 40, 8))
    m = torch.full((3,), NEG_INF)
    l, acc = torch.zeros(3), torch.zeros(3, 8)
    for cols in (slice(0, 25), slice(25, 40)):
        mh = s[:, cols].amax(-1)
        p = torch.exp(s[:, cols] - mh[:, None])
        m, l, acc = ring_hop_fold(m, l, acc, (p @ vals[cols]) / p.sum(-1, keepdim=True),
                                  mh, p.sum(-1))
    want = torch.softmax(s, -1) @ vals
    np.testing.assert_allclose((acc / l[:, None]).numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    again = ring_hop_fold(m, l, acc, torch.zeros(3, 8), torch.full((3,), NEG_INF),
                          torch.zeros(3))
    for a, b in zip(again, (m, l, acc)):
        assert torch.equal(a, b)


# (n, true_len, sliding_window): tests/test_ring_attention.py's geometries.
FOLD_CASES = [(4, 256, None), (8, 256, None), (4, 200, None), (4, 230, 70), (2, 470, 80)]


def _fold_inputs(true_len):
    """B 2, Hq 4, Hkv 2, D 128; 512 rows when the prompt needs them."""
    S = 512 if true_len > 256 else 256
    rng = np.random.default_rng(11)
    q = normal(rng, 2, 4, S, D)
    k, v = normal(rng, 2, 2, S, D), normal(rng, 2, 2, S, D)
    return q, k, v, np.asarray([true_len, true_len - 37], np.int32)


@pytest.mark.parametrize("backend", ["xla", "kernel"])
@pytest.mark.parametrize("n,true_len,sw", FOLD_CASES)
def test_emulated_fold_matches_jax_ring(n, true_len, sw, backend):
    """The port's fold (K1-ml's plain version per hop, every rank in one
    process) against JAX ``make_ring_attention`` on n virtual CPU devices,
    with its einsum fold and with its kernel fold in interpret mode, on
    each example's valid rows."""
    q, k, v, tl = _fold_inputs(true_len)
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    if backend == "xla":
        ring = make_ring_attention(mesh, "sp", sliding_window=sw, backend="xla")
    else:
        blocks = dict(kernel_q_block=64, kernel_kv_block=64) if q.shape[2] > 256 else {}
        ring = make_ring_attention(mesh, "sp", sliding_window=sw, interpret=True, **blocks)
    with mesh:
        want = np.asarray(ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl)))
    got = ring_attention_emulated(t(q), t(k), t(v), t(tl), n, sw).numpy()
    for b, length in enumerate(tl):
        np.testing.assert_allclose(got[b, :, :length], want[b, :, :length], **FOLD_TOL)


# Cases of the ring over spawned ranks, by rank count.
GLOO_CASES = {2: [(256, None), (470, 80)], 4: [(256, None), (200, None), (230, 70)]}


@pytest.fixture(scope="module")
def gloo_rings(tmp_path_factory):
    """One spawn of n gloo ranks per n, each running its cases."""
    runs = {}

    def run(n):
        if n not in runs:
            cases = []
            for true_len, sw in GLOO_CASES[n]:
                q, k, v, tl = _fold_inputs(true_len)
                cases.append(dict(q=q, k=k, v=v, true_len=tl, sw=sw))
            runs[n] = (cases, torch_sp_worker.spawn(
                n, tmp_path_factory.mktemp(f"ring{n}"), "ring", cases))
        return runs[n]
    return run


@pytest.mark.parametrize("n,i", [(n, i) for n in sorted(GLOO_CASES)
                                 for i in range(len(GLOO_CASES[n]))])
def test_gloo_ring_matches_emulated_fold(gloo_rings, n, i):
    """``ring_attention`` over n spawned gloo ranks (K/V shards shifted
    with ``batch_isend_irecv``) gives the single-process fold's rows on
    every rank, and hands back the global K/V; the ranks import no JAX."""
    cases, ranks = gloo_rings(n)
    c = cases[i]
    want = ring_attention_emulated(t(c["q"]), t(c["k"]), t(c["v"]), t(c["true_len"]), n,
                                   c["sw"]).numpy()
    got = np.concatenate([r["out"][i] for r in ranks], axis=2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert all(r["kv_global"][i] for r in ranks)
    assert all(r["banned_modules"] == [] for r in ranks)
