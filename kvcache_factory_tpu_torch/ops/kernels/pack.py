"""K5: row gather ``out[h, c] = kv[h, idx[h, c]]``, a zero row for an id
outside ``[0, S)``.

The CUDA kernel (``csrc/pack.cu``) replaces the Pallas TPU kernel
``tools/bench_select.py::_pack_kernel`` (``pallas_pack``), the one-hot
pack that the JAX package's selection probe holds against XLA's gather.
As in the JAX package, the port's ``select_and_pack`` keeps the library
gather (``torch.gather``, standing for XLA's ``take_along_axis``); this
kernel is driven by the probe phase of ``chip_smoke.py``.  Its source
header says what bounds it on the card and how the design answers that.

Dispatch is one rule: a CPU tensor goes to the plain version
(:func:`pack_rows_reference`); a CUDA tensor goes to the kernel, or
raises.  ``pack_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "kvcache_factory_tpu_torch/csrc/pack.cu"
REPLACES = "tools/bench_select.py:44"


def pack_rows(kv: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``kv [H, S, D2]``, ``idx [H, C]`` int32 -> ``[H, C, D2]`` with
    ``out[h, c] = kv[h, idx[h, c]]``, zeros where ``idx`` is outside
    ``[0, S)``.  Any H, S and C; the card needs rows of a whole number of
    16-byte vectors."""
    if kv.device.type == "cpu":
        return pack_rows_reference(kv, idx)
    lib = _build.load("pack")
    _check(kv, idx)
    H, S, D2 = kv.shape
    C = idx.shape[1]
    out = torch.empty((H, C, D2), dtype=kv.dtype, device=kv.device)
    with torch.cuda.device(kv.device):
        code = lib.kvcf_pack_rows(kv.data_ptr(), idx.data_ptr(), out.data_ptr(), H, S, C,
                                  D2 * kv.element_size() // 16,
                                  torch.cuda.current_stream(kv.device).cuda_stream)
    _build.check(code, "pack")
    pack_rows.launches += 1
    return out


pack_rows.launches = 0


def _check(kv, idx):
    # kv and out move as 16-byte vectors; idx is read one int at a time.
    for name, t, align in (("kv", kv, 16), ("idx", idx, 4)):
        if t.device != kv.device:
            raise ValueError(f"pack: {name} is on {t.device}, kv on {kv.device}")
        if not t.is_contiguous():
            raise ValueError(f"pack: {name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"pack: {name} must be {align}-byte aligned")
    if kv.dim() != 3 or kv.shape[1] < 1 or (kv.shape[2] * kv.element_size()) % 16:
        raise ValueError(f"pack: kv must be [H, S, D2] with rows of a multiple of 16 "
                         f"bytes, got {tuple(kv.shape)} {kv.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != kv.shape[0] \
            or idx.shape[1] < 1:
        raise ValueError(f"pack: idx must be int32 [H, C] with H = {kv.shape[0]}, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if kv.device.type != "cuda":
        raise ValueError(f"pack: unsupported device {kv.device}")


def pack_rows_reference(kv: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pack_rows`: the explicit zero-row gather."""
    H, S, D2 = kv.shape
    valid = (idx >= 0) & (idx < S)
    safe = torch.where(valid, idx, 0).to(torch.int64)
    rows = torch.gather(kv, 1, safe[:, :, None].expand(H, idx.shape[1], D2))
    return torch.where(valid[:, :, None], rows, torch.zeros((), dtype=kv.dtype,
                                                             device=kv.device))
