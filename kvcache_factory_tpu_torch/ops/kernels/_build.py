"""Build and load the port's CUDA kernels.

Each ``kvcache_factory_tpu_torch/csrc/<name>.cu`` is compiled on first use
with ``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, placed in ``build/kernels/`` at the repository root, and loaded
with ``ctypes``.  The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  Nothing here includes PyTorch's headers: a file builds in seconds.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a non-zero code.  A failed build raises
:class:`KernelBuildError`; no caller falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signatures of every C entry point, by library.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "flash_prefill": {
        # q, k, v, true_len, row_offset, block_mask, out, win_ml, scores,
        # row_ml, B, Hq, Hkv, S_q, S_k, W, SW, P, n_blk, scale, stream
        "kvcf_flash_prefill": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    },
    "decode_attn": {
        # q, k_cache, v_cache, lengths, lower, k_new, v_new, out,
        # part, counters, H, G, C, n_split, scale, stream
        "kvcf_decode_attn_append": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _F, _P),
    },
    "decode_attn_quant": {
        # K3 and K4: q, k_codes, v_codes, scales, lengths, lower, k_new, v_new,
        # out, part, counters, H, G, C, n_split, scale, stream
        "kvcf_quant8_decode_attn_append": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                           _I, _I, _I, _I, _F, _P),
        "kvcf_quant4_decode_attn_append": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                           _I, _I, _I, _I, _F, _P),
    },
    "pack": {
        # kv, idx, out, H, S, C, vecs, stream
        "kvcf_pack_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError("nvcc not found (looked on PATH and in "
                               "/usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one nvcc
    process per source, all started together.  Returns each library's
    ptxas report (registers, shared memory, spills); empty when cached."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"{what}: CUDA error {code}")
