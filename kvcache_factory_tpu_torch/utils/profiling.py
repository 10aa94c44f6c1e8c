"""Profiling and phase timing (port of ``kvcache_factory_tpu/utils/profiling.py``).

 * :func:`trace` runs ``torch.profiler`` over the host and, where CUDA is
   available, the card, and writes a Chrome trace (open it in
   ``chrome://tracing`` or Perfetto) into a directory;
 * :func:`annotate` adds a named region to that trace (a
   ``record_function`` span on the host timeline, whose kernels the trace
   links to it) and an NVTX range once CUDA is initialised;
 * :class:`PhaseTimer` records per-phase wall time and derived tokens/s,
   synchronising the device of a phase's CUDA outputs before it stops the
   clock (kernel launches return before the kernels finish).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch


# Small kernels run at the start of a device trace.  The profiler drops the
# first device records of each session, more the longer the process has
# run (torch 2.11 on an H100: one more every 13-17 s of process age, 62
# fifteen minutes in, which was the first layer of a traced prefill); the
# burst takes that loss in place of the traced block.
_DEVICE_WARMUP_KERNELS = 1024


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a trace: ``with trace('/tmp/trace'): run()``.  The Chrome
    trace lands in ``log_dir`` as ``trace-<pid>-<ns>.json`` when the block
    exits.  With CUDA, ``_DEVICE_WARMUP_KERNELS`` small kernels run and
    finish before the block, and the block's kernels finish before the
    trace stops."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        warm = torch.zeros(1, device="cuda")
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        if cuda:
            for _ in range(_DEVICE_WARMUP_KERNELS):
                warm.add_(1)
            torch.cuda.synchronize()
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (host span; an NVTX range once CUDA is
    initialised, for tools that read NVTX)."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _cuda_devices(outputs: Any, found: set) -> set:
    """The CUDA devices of the tensors in a nest of lists, tuples and dicts."""
    if isinstance(outputs, torch.Tensor):
        if outputs.is_cuda:
            found.add(outputs.device)
    elif isinstance(outputs, dict):
        for v in outputs.values():
            _cuda_devices(v, found)
    elif isinstance(outputs, (list, tuple)):
        for v in outputs:
            _cuda_devices(v, found)
    return found


@dataclass
class PhaseTimer:
    phases: Dict[str, List[float]] = field(default_factory=dict)
    tokens: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, outputs: Any = None, num_tokens: int = 0):
        """Times a phase; pass the phase's tensors via a mutable list (or
        dict) filled inside the block: the devices of its CUDA tensors are
        synchronised before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if outputs is not None:
                for dev in _cuda_devices(outputs, set()):
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.phases.setdefault(name, []).append(dt)
            if num_tokens:
                self.tokens[name] = self.tokens.get(name, 0) + num_tokens

    def record(self, name: str, seconds: float, num_tokens: int = 0):
        self.phases.setdefault(name, []).append(seconds)
        if num_tokens:
            self.tokens[name] = self.tokens.get(name, 0) + num_tokens

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in self.phases.items():
            total = sum(times)
            entry = {"count": len(times), "total_s": round(total, 4),
                     "mean_s": round(total / len(times), 4)}
            if name in self.tokens and total > 0:
                entry["tokens_per_s"] = round(self.tokens[name] / total, 2)
            out[name] = entry
        return out

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s
