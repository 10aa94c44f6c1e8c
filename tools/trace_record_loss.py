#!/usr/bin/env python3
"""How many device records a ``torch.profiler`` session drops as the process
ages, and which warm-up keeps a traced block whole, on one CUDA card.

    python3 tools/trace_record_loss.py [--seconds 180]

Every step it opens one profiler session per variant over the same block of
300 small kernels (one ``add_`` each on its own tensor), and lists, by
launch order, the launches whose kernel record is missing from the Chrome
trace; between steps it ages the process by 15 s of matrix products and ten
other profiler sessions.  Variants: no warm-up; one kernel and 0.1 s of
idle before the block; the same with 0.1 s of idle after it too; a burst
of 512 kernels before the block; and ``kvcache_factory_tpu_torch.utils.trace``
itself (lost records counted in the block only).  Imports only torch and
the port.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from kvcache_factory_tpu_torch.utils import trace  # noqa: E402

OUT = ROOT / "build" / "trace_record_loss"


def lost_launches(events):
    """(launches in the trace, positions by launch order of those whose
    kernel record is missing)."""
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and "Launch" in e.get("name", "") and "correlation" in e.get("args", {}))
    kernels = {e["args"].get("correlation") for e in events if e.get("cat") == "kernel"}
    return len(launches), [i for i, (_, c) in enumerate(launches) if c not in kernels]


def session(xs, warm, lead, tail):
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    w = torch.zeros(1, device="cuda")
    prof.start()
    for _ in range(warm):
        w.add_(1)
    torch.cuda.synchronize()
    time.sleep(lead)
    for x in xs:
        x.add_(1)
    torch.cuda.synchronize()
    time.sleep(tail)
    prof.stop()
    path = OUT / "session.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return lost_launches(events)


def utils_trace(xs):
    shutil.rmtree(OUT / "utils", ignore_errors=True)
    with trace(str(OUT / "utils")):
        for x in xs:
            x.add_(1)
    events = json.loads(next((OUT / "utils").glob("*.json")).read_text())["traceEvents"]
    n, lost = lost_launches(events)
    return n, [i for i in lost if i >= n - len(xs)]  # the block is the last launches


def age(a, b, sessions=10, seconds=15.0):
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                a @ b
            torch.cuda.synchronize()
        prof.key_averages()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            a @ b
        torch.cuda.synchronize()


VARIANTS = {"none": (0, 0.0, 0.0), "1 kernel, idle 0.1 s before": (1, 0.1, 0.0),
            "1 kernel, idle 0.1 s before and after": (1, 0.1, 0.1),
            "512 kernels before": (512, 0.0, 0.0)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=180.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_record_loss: no CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()
    xs = [torch.zeros(1024, device="cuda") for _ in range(300)]
    a, b = (torch.randn(2048, 2048, device="cuda") for _ in range(2))
    torch.cuda.synchronize()
    step = 0
    while time.perf_counter() - t_start < args.seconds:
        runs = {name: session(xs, *v) for name, v in VARIANTS.items()}
        runs["utils.trace (block only)"] = utils_trace(xs)
        for name, (n, lost) in runs.items():
            where = f" at {lost[:2]}..{lost[-2:]}" if lost else ""
            print(f"[{time.perf_counter() - t_start:6.1f} s] step {step} {name}: {n} launches, "
                  f"{len(lost)} lost{where}", flush=True)
        age(a, b)
        step += 1
    shutil.rmtree(OUT, ignore_errors=True)


if __name__ == "__main__":
    main()
