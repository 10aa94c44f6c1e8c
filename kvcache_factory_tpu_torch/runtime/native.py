"""The continuous-batching scheduler: a ctypes binding of the framework-free
C++ core ``csrc/scheduler.cpp`` (shared with the JAX package) and a
pure-Python twin with the same semantics (port of the scheduler half of
``kvcache_factory_tpu/runtime/native.py``).

The port's loader compiles ``csrc/scheduler.cpp`` with ``g++`` on first use
into ``build/native/`` at the repository root (git-ignored), under a name
that carries a hash of the source and the flags, and never writes into
``csrc/``.  Where no compiler is found or the build fails,
:func:`make_scheduler` falls back to :class:`PyScheduler`.  The safetensors
reader stays with ROADMAP.md queue 1 item 12.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import deque
from pathlib import Path
from typing import List, Optional, Tuple

REPO = Path(__file__).resolve().parents[2]
SCHED_SOURCE = REPO / "csrc" / "scheduler.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_sched_lib = None


def _lib_path() -> Path:
    digest = hashlib.sha256(SCHED_SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libkvcf_sched-{digest}.so"


def _build_sched() -> Optional[Path]:
    """The scheduler library, compiled first if needed; None where it
    cannot be built."""
    path = _lib_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SCHED_SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def _sched():
    global _sched_lib
    if _sched_lib is None:
        path = _build_sched()
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                lib = None
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
