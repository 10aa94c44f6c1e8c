"""Build and load the port's CUDA kernels.

Each ``kvcache_factory_tpu_torch/csrc/<name>.cu`` is compiled on first use
with ``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, placed in ``build/kernels/`` at the repository root, and loaded
with ``ctypes``; a library of ``VARIANTS`` compiles another library's source
with extra flags.  The library's file name carries a hash of the source,
the local headers it includes (``#include "..."``, under ``csrc/``) and
the flags, so an edited source or header is rebuilt and a stale library is
never loaded.  Nothing here includes PyTorch's headers: a file builds in seconds.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a non-zero code.  A failed build raises
:class:`KernelBuildError`; no caller falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signatures of every C entry point, by library.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# K1 and K2 export one entry point per instantiation width (``..._d64``,
# ``_d128``, ``_d256``, ``_d384``, ``_d512``), in each of their libraries
# (``_p8`` and ``_p4`` copy rows in 8- and 4-byte pieces), K3 and K4 one per
# code width and head_dim (``_d128`` ... ``_d512``); above 512 the ``_wide``
# libraries one per kernel, for every width (K1 two: the cluster kernel up
# to 2048, the slice-recomputing one above), and K3 up to 2048 the
# ``decode_attn_quant_cluster`` library.
_K1 = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P)
_K2 = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)
_WIDTHS = (64, 128, 256, 384, 512)
_KQ = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P)
# Above head_dim 512 one entry point each takes any width: the column-slice
# count comes before the head_dim (K3 / K4 take the head_dim too).
_K1W = _K1[:19] + (_I,) + _K1[19:]
_K2W = _K2[:14] + (_I,) + _K2[14:]
_KQW = _KQ[:15] + (_I, _I) + _KQ[15:]
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    # q, k, v, true_len, row_offset, block_mask, out, win_ml, scores,
    # row_ml, B, Hq, Hkv, S_q, S_k, W, SW, P, n_blk, head_dim, scale, stream
    **{f"flash_prefill{p}": {f"kvcf_flash_prefill_d{d}": _K1 for d in _WIDTHS}
       for p in ("", "_p8", "_p4")},
    # q, k_cache, v_cache, lengths, lower, k_new, v_new, out,
    # part, counters, H, G, C, n_split, head_dim, scale, stream
    **{f"decode_attn{p}": {f"kvcf_decode_attn_append_d{d}": _K2 for d in _WIDTHS}
       for p in ("", "_p8", "_p4")},
    # K3 and K4: q, k_codes, v_codes, scales, lengths, lower, k_new, v_new,
    # out, part, counters, H, G, C, n_split, scale, stream
    "decode_attn_quant": {f"kvcf_quant{nbits}_decode_attn_append_d{d}": _KQ
                          for nbits in (8, 4) for d in (128, 256)},
    **{f"decode_attn_quant_d{d}": {f"kvcf_quant{nbits}_decode_attn_append_d{d}": _KQ
                                   for nbits in (8, 4)} for d in (384, 512)},
    # q, k, v, true_len, row_offset, block_mask, out, win_ml, scores,
    # row_ml, B, Hq, Hkv, S_q, S_k, W, SW, P, n_blk, n_slice, head_dim,
    # scale, stream
    # ..._cluster_info(n_slice, int[2]): the cluster kernel's dynamic
    # shared memory and the clusters the device holds at once.
    "flash_prefill_wide": {"kvcf_flash_prefill_cluster": _K1W, "kvcf_flash_prefill_wide": _K1W,
                           "kvcf_flash_prefill_cluster_info": (_I, _P)},
    # q, k_cache, v_cache, lengths, lower, k_new, v_new, out, part,
    # counters, H, G, C, n_split, n_slice, head_dim, scale, stream
    "decode_attn_wide": {"kvcf_decode_attn_append_wide": _K2W},
    # q, k_codes, v_codes, scales, lengths, lower, k_new, v_new, out, part,
    # counters, H, G, C, n_split, n_slice, head_dim, scale, stream
    "decode_attn_quant_wide": {f"kvcf_quant{nbits}_decode_attn_append_wide": _KQW
                               for nbits in (8, 4)},
    # K3 from 640 to 2048 (one cluster of CTAs a logit): the same arguments.
    "decode_attn_quant_cluster": {"kvcf_quant8_decode_attn_append_cluster": _KQW,
                                  "kvcf_quant8_decode_cluster_info": (_I, _P)},
    "pack": {
        # kv, idx, out, H, S, C, vecs, stream
        "kvcf_pack_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    },
}

# Libraries built from another library's source, with the flags that pick
# their entry points.  K3 / K4 at head_dim 384 and at 512 each compile apart
# from 128 and 256, so the three nvcc processes run side by side: 384 and
# 512 in one process took 61 s on an H100's host, the build's longest.
# K1 and K2 for head_dims that are no multiple of 8 build apart too, with
# the width of their row copies (bytes) as a flag: a head_dim that is a
# multiple of 8 runs the library built without it, whose code that flag
# leaves as it was.
VARIANTS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    **{f"decode_attn_quant_d{d}": ("decode_attn_quant", (f"-DKVCF_QUANT_D={d}",))
       for d in (384, 512)},
    **{f"{name}_p{w}": (name, (f"-DKVCF_PIECE={w}",))
       for name in ("flash_prefill", "decode_attn") for w in (8, 4)},
    # K3 / K4 above 512 share K2's wide source, built apart so that the
    # two compile side by side.
    "decode_attn_quant_wide": ("decode_attn_wide", ("-DKVCF_WIDE_QUANT",)),
}

_loaded: Dict[str, ctypes.CDLL] = {}
# Wall seconds of each library's nvcc in the last build_all that compiled it.
BUILD_SECONDS: Dict[str, float] = {}


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


def _source(name: str) -> Tuple[Path, Tuple[str, ...]]:
    """The source file and the extra flags of library ``name``."""
    source, defines = VARIANTS.get(name, (name, ()))
    return CSRC / f"{source}.cu", defines


def _local_includes(path: Path, seen: Tuple[Path, ...] = ()) -> Tuple[Path, ...]:
    """``path`` and every file it includes by ``#include "..."`` from its own
    directory, depth first, each once."""
    if path in seen:
        return seen
    seen = seen + (path,)
    for name in re.findall(r'^\s*#\s*include\s*"([^"]+)"', path.read_text(), re.M):
        seen = _local_includes(path.parent / name, seen)
    return seen


def _lib_path(name: str) -> Path:
    source, defines = _source(name)
    flags = " ".join(NVCC_FLAGS + defines).encode()
    text = b"".join(p.read_bytes() for p in _local_includes(source))
    digest = hashlib.sha256(text + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one nvcc
    process per source, all started together.  Returns each library's
    ptxas report (registers, shared memory, spills); empty when cached."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        source, defines = _source(name)
        cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    def finish(name):
        log, _ = procs[name][0].communicate()
        return log, time.perf_counter() - t0

    with ThreadPoolExecutor(max(len(procs), 1)) as pool:
        done = dict(zip(procs, pool.map(finish, procs)))
    reports = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, BUILD_SECONDS[name] = done[name]
        reports[name] = log
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{log}")
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
