"""Host-side native components: ctypes bindings of the framework-free C++
in ``csrc/`` (shared with the JAX package), each with a pure-Python twin
of the same semantics (port of ``kvcache_factory_tpu/runtime/native.py``):

* the continuous-batching scheduler, ``csrc/scheduler.cpp``
  (:class:`NativeScheduler`, twin :class:`PyScheduler`);
* the safetensors reader, ``csrc/safetensors_reader.cpp`` (mmap plus a
  parallel copy), behind :class:`SafetensorsFile`, whose twin is a plain
  ``mmap`` read.

The port's loader compiles each source with ``g++`` on first use into
``build/native/`` at the repository root (git-ignored), under a name that
carries a hash of the source and the flags, and never writes into
``csrc/``.  Where no compiler is found or the build fails, the twin
serves.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import mmap
import os
import shutil
import subprocess
import threading
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

REPO = Path(__file__).resolve().parents[2]
SCHED_SOURCE = REPO / "csrc" / "scheduler.cpp"
ST_SOURCE = REPO / "csrc" / "safetensors_reader.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_sched_lib = None
_st_lib = None


# The library each source builds, as the JAX package's Makefile names it.
_LIB_NAMES = {SCHED_SOURCE: "libkvcf_sched", ST_SOURCE: "libkvcf_st"}


def _lib_path(source: Path = SCHED_SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{_LIB_NAMES[source]}-{digest}.so"


def _build(source: Path) -> Optional[Path]:
    """The library of ``source``, compiled first if needed; None where it
    cannot be built."""
    path = _lib_path(source)
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def _open(source: Path) -> Optional[ctypes.CDLL]:
    path = _build(source)
    if path is None:
        return None
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        return None


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------


def _sched():
    global _sched_lib
    if _sched_lib is None:
        lib = _open(SCHED_SOURCE)
        if lib is not None:
            lib.kvcf_sched_create.restype = ctypes.c_void_p
            lib.kvcf_sched_create.argtypes = [
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
            lib.kvcf_sched_destroy.argtypes = [ctypes.c_void_p]
            lib.kvcf_sched_submit.restype = ctypes.c_int64
            lib.kvcf_sched_submit.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                              ctypes.c_int32]
            lib.kvcf_sched_admit.restype = ctypes.c_int32
            lib.kvcf_sched_admit.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_int64)]
            lib.kvcf_sched_step.restype = ctypes.c_int32
            lib.kvcf_sched_step.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                            ctypes.c_int32]
            lib.kvcf_sched_stats.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_int64)]
        _sched_lib = lib if lib is not None else False
    return _sched_lib or None


class NativeScheduler:
    """Continuous-batching scheduler backed by the C++ core: a FIFO of
    requests, a fixed pool of decode slots, and each prompt's bucket."""

    def __init__(self, n_slots: int, buckets: List[int]):
        lib = _sched()
        if lib is None:
            raise RuntimeError("the native scheduler could not be built (g++)")
        self._lib = lib
        arr = (ctypes.c_int32 * len(buckets))(*sorted(buckets))
        self._h = lib.kvcf_sched_create(n_slots, arr, len(buckets))
        self.n_slots = n_slots

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.kvcf_sched_destroy(self._h)
            self._h = None

    def submit(self, prompt_len: int, max_new_tokens: int) -> int:
        """The request's id (> 0), or -1 if the prompt fits no bucket."""
        return int(self._lib.kvcf_sched_submit(self._h, prompt_len, max_new_tokens))

    def admit(self) -> Optional[Tuple[int, int, int, int]]:
        """``(slot, request_id, bucket, max_new_tokens)`` of the oldest
        queued request, now in a free slot; None without either."""
        out = (ctypes.c_int64 * 4)()
        if self._lib.kvcf_sched_admit(self._h, out):
            return int(out[0]), int(out[1]), int(out[2]), int(out[3])
        return None

    def step(self, slot: int, hit_eos: bool) -> bool:
        """Record one token for ``slot``; True when that finished it."""
        return bool(self._lib.kvcf_sched_step(self._h, slot, int(hit_eos)))

    def stats(self) -> dict:
        out = (ctypes.c_int64 * 4)()
        self._lib.kvcf_sched_stats(self._h, out)
        return {"queued": int(out[0]), "active": int(out[1]),
                "free": int(out[2]), "completed": int(out[3])}


class PyScheduler:
    """Pure-Python twin of :class:`NativeScheduler`, same semantics."""

    def __init__(self, n_slots: int, buckets: List[int]):
        self.n_slots = n_slots
        self._buckets = sorted(buckets)
        self._queue: deque = deque()
        self._free = list(range(n_slots - 1, -1, -1))
        self._slots = [None] * n_slots  # [request_id, generated, max_new]
        self._next_id = 1
        self._completed = 0
        self._mu = threading.Lock()

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return -1

    def submit(self, prompt_len: int, max_new_tokens: int) -> int:
        with self._mu:
            if self._bucket_for(prompt_len) < 0:
                return -1
            rid = self._next_id
            self._next_id += 1
            self._queue.append((rid, prompt_len, max_new_tokens))
            return rid

    def admit(self) -> Optional[Tuple[int, int, int, int]]:
        with self._mu:
            if not self._queue or not self._free:
                return None
            rid, plen, mnt = self._queue.popleft()
            slot = self._free.pop()
            self._slots[slot] = [rid, 0, mnt]
            return slot, rid, self._bucket_for(plen), mnt

    def step(self, slot: int, hit_eos: bool) -> bool:
        with self._mu:
            # Out-of-range slots are refused, as the C++ core refuses them
            # (negative Python indexing would reach the last slot).
            if not 0 <= slot < len(self._slots):
                return False
            st = self._slots[slot]
            if st is None:
                return False
            st[1] += 1
            if hit_eos or st[1] >= st[2]:
                self._slots[slot] = None
                self._free.append(slot)
                self._completed += 1
                return True
            return False

    def stats(self) -> dict:
        with self._mu:
            return {"queued": len(self._queue),
                    "active": sum(s is not None for s in self._slots),
                    "free": len(self._free), "completed": self._completed}


def make_scheduler(n_slots: int, buckets: List[int]):
    """The native scheduler where it builds, else the Python one."""
    try:
        return NativeScheduler(n_slots, buckets)
    except RuntimeError:
        return PyScheduler(n_slots, buckets)


# ---------------------------------------------------------------------------
# Safetensors reader
# ---------------------------------------------------------------------------


def _st():
    global _st_lib
    if _st_lib is None:
        lib = _open(ST_SOURCE)
        if lib is not None:
            lib.kvcf_st_open.restype = ctypes.c_void_p
            lib.kvcf_st_open.argtypes = [ctypes.c_char_p]
            lib.kvcf_st_close.argtypes = [ctypes.c_void_p]
            lib.kvcf_st_size.restype = ctypes.c_int64
            lib.kvcf_st_size.argtypes = [ctypes.c_void_p]
            lib.kvcf_st_read.restype = ctypes.c_int32
            lib.kvcf_st_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                         ctypes.c_uint64, ctypes.c_void_p,
                                         ctypes.c_int32]
        _st_lib = lib if lib is not None else False
    return _st_lib or None


# safetensors dtype tags -> torch dtypes (BF16 straight from the bytes).
ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


class SafetensorsFile:
    """One safetensors shard, read into CPU torch tensors: by the native
    reader (mmap plus ``threads`` parallel copies) where it builds, else by
    a plain ``mmap`` read.  ``reader`` says which serves this file, and
    the class counter ``bytes_read`` adds each tensor's bytes under that
    name, so a caller can show which reader a load went through."""

    bytes_read: Dict[str, int] = {"native": 0, "python": 0}

    def __init__(self, path: str, threads: int = 0):
        self.path = str(path)
        self.threads = threads or (os.cpu_count() or 1)
        self._lib = _st()
        self._h = self._mm = self._f = None
        if self._lib is not None:
            self._h = self._lib.kvcf_st_open(self.path.encode())
            if not self._h:
                raise OSError(f"cannot map {self.path}")
            self.reader = "native"
            size = int(self._lib.kvcf_st_size(self._h))
        else:
            self._f = open(self.path, "rb")
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
            self.reader = "python"
            size = len(self._mm)
        if size < 8:
            self.close()
            raise OSError(f"{self.path} is not a safetensors file ({size} bytes)")
        header_len = int.from_bytes(self._read(0, 8), "little")
        if header_len > size - 8:
            self.close()
            raise OSError(f"{self.path}: header length {header_len} past the file's end")
        self.header = json.loads(self._read(8, header_len).decode())
        self._data_off = 8 + header_len
        self.tensors = {k: v for k, v in self.header.items() if k != "__metadata__"}

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _read_into(self, off: int, n: int, dst: torch.Tensor, threads: int) -> None:
        """Copy bytes ``[off, off + n)`` of the file into the uint8 tensor ``dst``."""
        if self._h is not None:
            if self._lib.kvcf_st_read(self._h, off, n, dst.data_ptr(), threads) != 0:
                raise OSError(f"{self.path}: read of {n} bytes at {off} out of range")
        else:
            if off + n > len(self._mm):
                raise OSError(f"{self.path}: read of {n} bytes at {off} out of range")
            dst.numpy()[:] = memoryview(self._mm)[off:off + n]

    def _read(self, off: int, n: int) -> bytes:
        buf = torch.empty(n, dtype=torch.uint8)
        self._read_into(off, n, buf, 1)
        return buf.numpy().tobytes()

    def keys(self):
        return self.tensors.keys()

    def tensor(self, name: str) -> torch.Tensor:
        """The named tensor, a new CPU tensor of its stored dtype and shape."""
        info = self.tensors[name]
        dtype = ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        n = end - begin
        shape = tuple(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for d in shape:
            numel *= d
        if n != numel * itemsize or begin < 0:
            raise OSError(f"{self.path}: {name} holds {n} bytes, its shape and dtype "
                          f"need {numel * itemsize}")
        out = torch.empty(n, dtype=torch.uint8)
        if n:
            self._read_into(self._data_off + begin, n, out, self.threads)
        SafetensorsFile.bytes_read[self.reader] += n
        return out.view(dtype).reshape(shape)

    def close(self) -> None:
        if self._h is not None:
            self._lib.kvcf_st_close(self._h)
            self._h = None
        if self._mm is not None:
            self._mm.close()
            self._f.close()
            self._mm = self._f = None
