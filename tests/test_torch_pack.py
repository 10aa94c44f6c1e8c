"""K5 (``ops/kernels/pack.py``) against the JAX package's Pallas pack.

``tools/bench_select.py`` is loaded by its path and its ``pallas_pack`` runs
in interpret mode.  Inputs are numpy arrays from ``np.random.default_rng``.
A gather moves values and computes nothing: the one-hot products there
add exact zeros to one value, so the port's plain version must agree bit
for bit, out-of-range ids (a zero row) included.  The CUDA kernel runs only
on the card (``chip_smoke.py``).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu_torch.ops.kernels import _build
from kvcache_factory_tpu_torch.ops.kernels import pack as tpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench_select():
    spec = importlib.util.spec_from_file_location(
        "bench_select", os.path.join(REPO, "tools", "bench_select.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ranked_ids(rng, H, S, C, n_out):
    """Top-C ids of random scores by a stable descending sort (the probe's
    ranking), with ``n_out`` ids per head replaced by ids outside [0, S)."""
    scores = rng.standard_normal((H, S)).astype(np.float32)
    idx = np.argsort(-scores, axis=-1, kind="stable")[:, :C].astype(np.int32)
    for h in range(H):
        at = rng.choice(C, size=n_out, replace=False)
        idx[h, at] = rng.choice([-1, S, S + 7, -100], size=n_out)
    return idx


@pytest.mark.parametrize("H,S,C,D2,CB,SB,dtype", [
    (2, 256, 64, 256, 32, 128, np.float32),
    (4, 512, 128, 256, 128, 256, jnp.bfloat16),  # the probe's K|V rows, bf16
    (3, 128, 32, 128, 32, 64, np.float32),
])
def test_pack_plain_matches_pallas(bench_select, H, S, C, D2, CB, SB, dtype):
    rng = np.random.default_rng(0)
    kv = np.array(jnp.asarray(rng.standard_normal((H, S, D2)), dtype).astype(jnp.float32))
    idx = ranked_ids(rng, H, S, C, 3)
    want = np.asarray(bench_select.pallas_pack(jnp.asarray(kv, dtype), jnp.asarray(idx), CB=CB,
                                               SB=SB, interpret=True).astype(jnp.float32))
    tdtype = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = tpack.pack_rows(torch.from_numpy(kv).to(tdtype), torch.from_numpy(idx))
    assert got.dtype == tdtype and got.shape == (H, C, D2)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got.float().numpy()[(idx < 0) | (idx >= S)].any()


@pytest.mark.parametrize("S,C", [(100, 37), (7, 20), (1, 1)])
def test_pack_any_shape(S, C):
    """Any C and S, C larger than S and ids repeated among them: each row is
    the named source row or zeros."""
    rng = np.random.default_rng(1)
    kv = torch.from_numpy(rng.standard_normal((3, S, 24)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-2, S + 2, size=(3, C)).astype(np.int32))
    got = tpack.pack_rows(kv, idx)
    for h in range(3):
        for c in range(C):
            i = int(idx[h, c])
            want = kv[h, i] if 0 <= i < S else torch.zeros(24)
            assert torch.equal(got[h, c], want)


def test_pack_cpu_counts_no_launch_and_card_never_falls_back(monkeypatch):
    before = tpack.pack_rows.launches
    tpack.pack_rows(torch.zeros(1, 4, 8), torch.zeros(1, 2, dtype=torch.int32))
    assert tpack.pack_rows.launches == before

    def failing_load(name):
        raise _build.KernelBuildError(f"stubbed build failure for {name}")

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("the wrapper fell back to its plain version")

    monkeypatch.setattr(_build, "load", failing_load)
    monkeypatch.setattr(tpack, "pack_rows_reference", plain_must_not_run)
    with pytest.raises(_build.KernelBuildError, match="stubbed"):
        tpack.pack_rows(torch.empty(2, 8, 256, dtype=torch.bfloat16, device="meta"),
                        torch.empty(2, 4, dtype=torch.int32, device="meta"))
    assert tpack.pack_rows.launches == before


@pytest.mark.parametrize("kv,idx,match", [
    (torch.zeros(2, 8, 256, dtype=torch.bfloat16), torch.zeros(2, 4, dtype=torch.int32),
     "unsupported device"),
    (torch.zeros(2, 8, 12, dtype=torch.bfloat16), torch.zeros(2, 4, dtype=torch.int32),
     "multiple of 16"),      # 24-byte rows
    (torch.zeros(2, 8, 256, dtype=torch.bfloat16), torch.zeros(2, 4, dtype=torch.int64),
     "int32"),
    (torch.zeros(2, 8, 256, dtype=torch.bfloat16), torch.zeros(3, 4, dtype=torch.int32),
     "int32"),               # one id row per head
    (torch.zeros(2, 8, 256, dtype=torch.bfloat16)[:, ::2], torch.zeros(2, 4, dtype=torch.int32),
     "contiguous"),
])
def test_pack_checks(kv, idx, match):
    """What the kernel cannot take is refused before a launch (checked on
    CPU tensors: the device check comes after the layout ones)."""
    with pytest.raises(ValueError, match=match):
        tpack._check(kv, idx)
