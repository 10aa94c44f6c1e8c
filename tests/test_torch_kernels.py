"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain version; the JAX kernels run in
interpret mode, as ``tests/test_flash_prefill.py`` and
``tests/test_kernels.py`` run them.  Inputs are fp32 numpy arrays from
``np.random.default_rng``; fp32 against fp32 with another summation order
agrees to ~1e-6, so the tolerance is 2e-5 (the JAX kernel tests' own).
The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu.ops.kernels import decode_attn as jdecode
from kvcache_factory_tpu.ops.kernels import flash_prefill as jflash
from kvcache_factory_tpu_torch.ops.kernels import _build
from kvcache_factory_tpu_torch.ops.kernels import decode_attn as tdecode
from kvcache_factory_tpu_torch.ops.kernels import decode_attn_quant as tquant
from kvcache_factory_tpu_torch.ops.kernels import flash_prefill as tflash

D = 128
TOL = dict(rtol=2e-5, atol=2e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("S,true_len,G", [(256, 256, 1), (384, 300, 2)])
def test_flash_prefill_plain_matches_pallas(S, true_len, G):
    Hq, W = 4, 8
    rng = np.random.default_rng(0)
    q, k, v = normal(rng, Hq, S, D), normal(rng, Hq // G, S, D), normal(rng, Hq // G, S, D)
    out, scores = tflash.flash_prefill_attention(
        t(q)[None], t(k)[None], t(v)[None], torch.tensor([true_len], dtype=torch.int32), W)
    j_out, j_scores = jflash.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(true_len), window=W,
        q_block=128, kv_block=128, interpret=True)
    np.testing.assert_allclose(out[0, :, :true_len].numpy(),
                               np.asarray(j_out)[:, :true_len], **TOL)
    np.testing.assert_allclose(scores[0, :, :true_len - W].numpy(),
                               np.asarray(j_scores)[:, :true_len - W], **TOL)


def test_flash_prefill_plain_matches_pallas_batched_ragged():
    B, Hq, G, S, W = 2, 4, 2, 256, 8
    rng = np.random.default_rng(1)
    q, k, v = normal(rng, B, Hq, S, D), normal(rng, B, Hq // G, S, D), normal(rng, B, Hq // G, S, D)
    tls = np.asarray([256, 131], np.int32)
    out, scores = tflash.flash_prefill_attention(t(q), t(k), t(v), t(tls), W)
    j_out, j_scores = jflash.flash_prefill_attention_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tls), W,
        q_block=128, kv_block=128, interpret=True)
    for b, tl in enumerate(tls):
        np.testing.assert_allclose(out[b, :, :tl].numpy(), np.asarray(j_out)[b, :, :tl], **TOL)
        np.testing.assert_allclose(scores[b, :, :tl - W].numpy(),
                                   np.asarray(j_scores)[b, :, :tl - W], **TOL)


@pytest.mark.parametrize("S,true_len,G,window", [
    (256, 256, 1, 64),    # window spans several 64-key tiles
    (384, 300, 2, 100),   # padded tail, GQA, a window no multiple of a tile
    (256, 256, 1, 17),    # window shorter than one tile
    (256, 200, 2, 1000),  # window longer than the sequence: dense
])
def test_flash_prefill_plain_sliding_window_matches_pallas(S, true_len, G, window):
    """K1-SW's plain version against the Pallas kernel's sliding-window
    variant in interpret mode, as ``tests/test_sliding_window_kernels.py``
    runs it."""
    Hq = 4
    rng = np.random.default_rng(13)
    q, k, v = normal(rng, Hq, S, D), normal(rng, Hq // G, S, D), normal(rng, Hq // G, S, D)
    out, scores = tflash.flash_prefill_attention(
        t(q)[None], t(k)[None], t(v)[None], torch.tensor([true_len], dtype=torch.int32), 0,
        sliding_window=window)
    j_out, _ = jflash.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(true_len), window=0,
        q_block=64, kv_block=64, interpret=True, sliding_window=window)
    np.testing.assert_allclose(out[0, :, :true_len].numpy(),
                               np.asarray(j_out)[:, :true_len], **TOL)
    assert not scores.any()


@pytest.mark.parametrize("S_q,S_k,offsets,true_lens,window", [
    (64, 256, [0, 64], [256, 101], None),         # tile-aligned chunks
    (32, 200, [100, 37, 0], [200, 60, 0], None),  # offsets off the tile, S_k off 64, an inert row
    (32, 200, [100, 37, 0], [200, 60, 0], 24),    # the same under a window
    (64, 256, [192, 130], [256, 190], 50),        # the last chunk, a window across tiles
])
def test_flash_prefill_plain_chunk_mode_matches_pallas(S_q, S_k, offsets, true_lens, window):
    """K1-chunk's plain version against the Pallas kernel's chunk mode
    (``row_offset``) in interpret mode, as ``tests/test_chunked_prefill.py``
    drives it: each row's valid q rows (global id < true_len) agree, and
    every row, an inert one (true_len 0) included, is finite."""
    B, Hq, G = len(offsets), 4, 2
    rng = np.random.default_rng(17)
    q = normal(rng, B, Hq, S_q, D)
    k, v = normal(rng, B, Hq // G, S_k, D), normal(rng, B, Hq // G, S_k, D)
    off, tls = np.asarray(offsets, np.int32), np.asarray(true_lens, np.int32)
    out, _ = tflash.flash_prefill_attention(t(q), t(k), t(v), t(tls), 0,
                                            sliding_window=window, row_offset=t(off))
    j_out, _ = jflash.flash_prefill_attention_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tls), 0, q_block=64,
        kv_block=64, interpret=True, sliding_window=window, row_offset=jnp.asarray(off))
    assert torch.isfinite(out).all()
    for b in range(B):
        valid = off[b] + np.arange(S_q) < tls[b]
        np.testing.assert_allclose(out[b][:, valid].numpy(), np.asarray(j_out)[b][:, valid],
                                   **TOL)


@pytest.mark.parametrize("call,match", [
    (dict(window=8, sliding_window=16), "dense causal softmax"),  # scores need a dense softmax
    (dict(window=8, row_offset=0), "dense causal softmax"),       # ... of whole-sequence queries
    (dict(window=0, k_len=32), "only in chunk mode"),            # q/k lengths differ
    (dict(window=0, row_offset=-1, k_len=32), "row_offset"),     # offsets are >= 0
    (dict(window=0, sliding_window=0), "sliding_window"),        # a window holds a key
])
def test_flash_prefill_keeps_the_jax_contract(call, match):
    """The JAX wrapper's asserts (``flash_prefill.py:495-507``) hold for the
    plain version and the kernel alike: checked before dispatch."""
    call = dict(call)
    q = torch.zeros(1, 2, 64, D)
    k = torch.zeros(1, 2, call.pop("k_len", 64), D)
    with pytest.raises(ValueError, match=match):
        tflash.flash_prefill_attention(q, k, k, torch.tensor([64], dtype=torch.int32),
                                       **call)


def test_flash_prefill_counts_launches_by_variant():
    assert tflash.variant(None, None) == "dense"
    assert tflash.variant(4096, None) == "sliding_window"
    assert tflash.variant(None, 0) == tflash.variant(4096, torch.zeros(2)) == "chunk"
    assert tflash.variant(None, None, ("ashape", 1, 2, 8)) == "ashape"
    assert tflash.variant(4096, None, (1, 2, 8)) == "ashape"
    assert tflash.variant(None, None, ("vertical_slash", 64, 16, 16)) == "vertical_slash"
    assert tflash.variant(None, 0, None, True) == tflash.variant(4096, None, None, True) == "ring"
    assert set(tflash.flash_prefill_attention.variant_launches) == {
        "dense", "sliding_window", "chunk", "ashape", "vertical_slash", "ring"}
    tflash.flash_prefill_attention.variant_launches["chunk"] = 3
    tflash.flash_prefill_attention.launches = 3
    tflash.reset_launches()
    assert tflash.flash_prefill_attention.launches == 0
    assert not any(tflash.flash_prefill_attention.variant_launches.values())


@pytest.mark.parametrize("C,G,lengths,lower", [
    (96, 1, [0, 1, 50, 95], None),             # ragged, C a multiple of 16
    (96, 4, [3, 40, 77, 12], [0, 0, 20, 5]),   # grouped queries, lower bounds
    (64, 1, [64, 10, 63, 64], None),           # full heads: the clamp to C-1
    (50, 2, [0, 10, 49, 30], None),            # any capacity
    (96, 3, [3, 40, 77, 12], [0, 0, 20, 5]),   # G 3 with lower bounds
    (64, 6, [64, 10, 63, 64], None),           # G 6 at a full cache
    (50, 7, [0, 10, 49, 30], [0, 4, 0, 31]),   # G 7, one lower bound past L
])
def test_decode_plain_matches_pallas(C, G, lengths, lower):
    H = 4
    rng = np.random.default_rng(2)
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
    # The in-place append wrote the new token where the TPU kernel does,
    # and nothing else.
    np.testing.assert_array_equal(k_port.numpy(), np.asarray(j_k))
    np.testing.assert_array_equal(v_port.numpy(), np.asarray(j_v))
    np.testing.assert_array_equal(np.minimum(lens + 1, C), np.asarray(j_lens))


def _decode_check_args(G):
    bf = torch.bfloat16
    return [torch.zeros(2, G, D, dtype=bf), torch.zeros(2, 16, D, dtype=bf),
            torch.zeros(2, 16, D, dtype=bf), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, D, dtype=bf), torch.zeros(2, D, dtype=bf), None]


@pytest.mark.parametrize("G", [3, 5, 6, 7])
def test_decode_check_takes_every_group_up_to_8(G):
    """Every shape check passes; only the device stops a CPU tensor."""
    with pytest.raises(ValueError, match="unsupported device"):
        tdecode._check(*_decode_check_args(G))


@pytest.mark.parametrize("G,shape", [(9, (2, 9, D)), (1, (2, 1, 64))])
def test_decode_check_refuses_g_above_8_or_other_head_dims(G, shape):
    args = _decode_check_args(G)
    args[0] = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP.md queue 2"):
        tdecode._check(*args)


@pytest.mark.parametrize("sm_count", [1, 16, 114, 132])
def test_decode_split_count_stays_in_bounds(sm_count):
    """At least one CTA per head, at most one per MIN_KEYS_PER_SPLIT slots,
    and one wave of CTAS_PER_SM per SM unless H alone is larger, at every H
    from 1 to 128."""
    for H in range(1, 129):
        for C in (1, 2, 17, 63, 64, 65, 2113, 32801, 1 << 20):
            n = tdecode.split_count(H, C, sm_count)
            assert 1 <= n <= -(-C // tdecode.MIN_KEYS_PER_SPLIT)
            assert H * n <= max(H, tdecode.CTAS_PER_SM * sm_count)


@pytest.mark.parametrize("n_split", [1, 2, 4, 7, 33, 264])
def test_decode_split_bounds_cover_the_valid_keys_in_order(n_split):
    """The splits of [lo, L) are disjoint, in order and cover it; each is
    within one key of the others, so a range shorter than n_split leaves
    some splits empty and none larger than one key."""
    for lo, L in ((0, 0), (0, 1), (5, 5), (3, 40), (0, 2079), (1000, 32031), (0, 255)):
        parts = [tdecode.split_bounds(lo, L, sp, n_split) for sp in range(n_split)]
        assert parts[0][0] == lo and parts[-1][1] == L
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        sizes = [e - s for s, e in parts]
        assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


def _quant_check_args(nbits, G, q_shape=None):
    """K3/K4 ``_check`` arguments for 2 heads of G query rows, C 16, on the
    CPU."""
    bf, width = torch.bfloat16, D if nbits == 8 else D // 2
    q = torch.zeros(q_shape or (2, G, D), dtype=bf)
    return [nbits, q, torch.zeros(2, 16, width, dtype=torch.uint8),
            torch.zeros(2, 16, width, dtype=torch.uint8), torch.zeros(2, 16, 4, dtype=bf),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2, D, dtype=bf),
            torch.zeros(2, D, dtype=bf), None]


@pytest.mark.parametrize("G", range(1, 9))
@pytest.mark.parametrize("nbits", [8, 4])
def test_quant_check_takes_every_group_up_to_8(nbits, G):
    """K3 and K4 take G 1-8: every shape check passes; only the device stops
    a CPU tensor."""
    with pytest.raises(ValueError, match="unsupported device"):
        tquant._check(*_quant_check_args(nbits, G))


@pytest.mark.parametrize("G,shape", [(9, (2, 9, D)), (1, (2, 1, 64))])
@pytest.mark.parametrize("nbits", [8, 4])
def test_quant_check_refuses_g_above_8_or_other_head_dims(nbits, G, shape):
    with pytest.raises(ValueError, match="ROADMAP.md queue 2"):
        tquant._check(*_quant_check_args(nbits, G, shape))


def test_cpu_tensors_never_count_a_launch():
    rng = np.random.default_rng(3)
    wrappers = (tflash.flash_prefill_attention, tdecode.decode_attention_append,
                tquant.quant_decode_attention_append, tquant.quant4_decode_attention_append)
    before = [w.launches for w in wrappers]
    variants = dict(tflash.flash_prefill_attention.variant_launches)
    q = t(normal(rng, 1, 2, 64, D))
    tflash.flash_prefill_attention(q, q, q, torch.tensor([64], dtype=torch.int32), 8)
    tflash.flash_prefill_attention(q, q, q, torch.tensor([64], dtype=torch.int32), 0,
                                   sliding_window=16, row_offset=0)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    tdecode.decode_attention_append(t(normal(rng, 2, 1, D)), t(normal(rng, 2, 16, D)),
                                    t(normal(rng, 2, 16, D)), lens,
                                    t(normal(rng, 2, D)), t(normal(rng, 2, D)))
    for wrapper, width in ((tquant.quant_decode_attention_append, D),
                           (tquant.quant4_decode_attention_append, D // 2)):
        codes = torch.zeros(2, 16, width, dtype=torch.uint8)
        wrapper(t(normal(rng, 2, 1, D)), codes, codes.clone(),
                torch.ones(2, 16, 4, dtype=torch.bfloat16), lens,
                t(normal(rng, 2, D)), t(normal(rng, 2, D)))
    assert [w.launches for w in wrappers] == before
    assert tflash.flash_prefill_attention.variant_launches == variants


def _quant_args(which, make):
    """K3/K4 arguments (q, codes, codes, scales, lengths, k_new, v_new),
    each tensor from ``make(shape, dtype)``."""
    width = D if which == "quant8" else D // 2
    bf = torch.bfloat16
    return [make((2, 1, D), bf), make((2, 16, width), torch.uint8),
            make((2, 16, width), torch.uint8), make((2, 16, 4), bf),
            make((2,), torch.int32), make((2, D), bf), make((2, D), bf)]


def _meta_args(which):
    m = dict(device="meta")
    if which == "flash":
        q = torch.empty(1, 2, 64, D, dtype=torch.bfloat16, **m)
        return (q, q, q, torch.empty(1, dtype=torch.int32, **m), 8)
    if which.startswith("quant"):
        return _quant_args(which, lambda shape, dtype: torch.empty(shape, dtype=dtype, **m))
    return (torch.empty(2, 1, D, dtype=torch.bfloat16, **m),
            torch.empty(2, 16, D, dtype=torch.bfloat16, **m),
            torch.empty(2, 16, D, dtype=torch.bfloat16, **m),
            torch.empty(2, dtype=torch.int32, **m),
            torch.empty(2, D, dtype=torch.bfloat16, **m),
            torch.empty(2, D, dtype=torch.bfloat16, **m))


WRAPPERS = {
    "flash": (tflash, "flash_prefill_attention", "flash_prefill_attention_reference"),
    "decode": (tdecode, "decode_attention_append", "decode_attention_append_reference"),
    "quant8": (tquant, "quant_decode_attention_append",
               "quant_decode_attention_append_reference"),
    "quant4": (tquant, "quant4_decode_attention_append",
               "quant4_decode_attention_append_reference"),
}


@pytest.mark.parametrize("which", sorted(WRAPPERS))
def test_failed_build_raises_and_never_falls_back(which, monkeypatch):
    """A tensor off the CPU must reach the kernel: when its library fails to
    build, the wrapper raises instead of running the plain version."""
    mod, wrapper_name, plain_name = WRAPPERS[which]

    def failing_load(name):
        raise _build.KernelBuildError(f"stubbed build failure for {name}")

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("the wrapper fell back to its plain version")

    monkeypatch.setattr(_build, "load", failing_load)
    monkeypatch.setattr(mod, plain_name, plain_must_not_run)
    wrapper = getattr(mod, wrapper_name)
    before = wrapper.launches
    with pytest.raises(_build.KernelBuildError, match="stubbed"):
        wrapper(*_meta_args(which))
    assert wrapper.launches == before


@pytest.mark.parametrize("which", sorted(WRAPPERS))
def test_non_cuda_device_is_refused(which, monkeypatch):
    mod, wrapper_name, _ = WRAPPERS[which]
    monkeypatch.setattr(_build, "load", lambda name: object())
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(mod, wrapper_name)(*_meta_args(which))


def _offset_view(shape, dtype, elements):
    """A contiguous tensor of ``shape`` that starts ``elements`` in."""
    n = int(np.prod(shape))
    return torch.zeros(n + elements, dtype=dtype)[elements:].view(shape)


def _cpu_check_args(which):
    """The arguments of ``mod._check``: K3/K4's take the width first."""
    bf = torch.bfloat16
    if which == "flash":
        q = torch.zeros(1, 2, 64, D, dtype=bf)
        return [q, q, q, torch.zeros(1, dtype=torch.int32), 8]
    if which.startswith("quant"):
        return [int(which[5:])] + _quant_args(
            which, lambda shape, dtype: torch.zeros(shape, dtype=dtype)) + [None]
    return [torch.zeros(2, 1, D, dtype=bf), torch.zeros(2, 16, D, dtype=bf),
            torch.zeros(2, 16, D, dtype=bf), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, D, dtype=bf), torch.zeros(2, D, dtype=bf), None]


# Argument index of an int32 vector, and of an input read with 16-byte loads.
INT32_ARG = {"flash": 3, "decode": 3, "quant8": 5, "quant4": 5}
VECTOR_LOADED_ARG = {"flash": 1, "decode": 1, "quant8": 2, "quant4": 2}


@pytest.mark.parametrize("which", sorted(WRAPPERS))
def test_int32_vectors_need_only_4_byte_alignment(which):
    """``decode_step`` passes ``cache.lengths[li]``, which starts li*B*H*4
    bytes in: 8 bytes at B=1 and 2 cache heads.  The checks accept it and
    stop only at the device."""
    mod = WRAPPERS[which][0]
    args = _cpu_check_args(which)
    args[INT32_ARG[which]] = _offset_view(args[INT32_ARG[which]].shape, torch.int32, 2)
    assert args[INT32_ARG[which]].data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="unsupported device"):
        mod._check(*args)


@pytest.mark.parametrize("which", sorted(WRAPPERS))
def test_vector_loaded_inputs_need_16_byte_alignment(which):
    mod = WRAPPERS[which][0]
    args = _cpu_check_args(which)
    arg = args[VECTOR_LOADED_ARG[which]]
    args[VECTOR_LOADED_ARG[which]] = _offset_view(arg.shape, arg.dtype, 8 // arg.element_size())
    with pytest.raises(ValueError, match="must be 16-byte aligned"):
        mod._check(*args)


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_names_library_by_source_hash_and_replaces_atomically(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "flash_prefill.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    # A stand-in compiler that writes its -o target.
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    first = _build._lib_path("flash_prefill")
    _build.build_all(["flash_prefill"])
    assert first.exists() and sorted(os.listdir(tmp_path / "build")) == [first.name]
    (src / "flash_prefill.cu").write_text("// v2\n")
    second = _build._lib_path("flash_prefill")
    assert second != first
    _build.build_all(["flash_prefill"])
    assert second.exists()


def test_build_failure_raises_and_leaves_no_library(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "decode_attn.cu").write_text("broken\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: _fake_nvcc(tmp_path, "echo 'error: broken'; exit 2\n"))
    with pytest.raises(_build.KernelBuildError, match="broken"):
        _build.build_all(["decode_attn"])
    assert not _build._lib_path("decode_attn").exists()
