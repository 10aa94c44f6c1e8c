#!/usr/bin/env python3
"""Time K3 or K4, the port's int8 and int4 decode-attention kernels, on one
NVIDIA H100.

    python3 tools/time_kq.py [--nbits 8|4] [--label NAME] [--reps N]

Run it from the root of a checkout of this repository, or of an older copy
of it: a git-ignored directory such as ``build/old/`` holding an earlier
commit's ``kvcache_factory_tpu_torch/`` and ``chip_smoke.py`` (for example
``git archive <commit> kvcache_factory_tpu_torch chip_smoke.py | tar -x -C
build/old``; then ``cd build/old && python3 ../../tools/time_kq.py``).  It
imports ``chip_smoke`` and the port from the working directory, so the
kernel it builds and times is that copy's, and it uses only helpers every
version of ``chip_smoke.py`` since K3 and K4 were ported has
(``kq_inputs``, ``kq_case``, ``graph_ms``).  To compare two versions on one
card, run both in one call, in turns: old, new, new, old.

It prints one JSON line: the card's name and power limit; the kernel's
device time per call by CUDA-graph replay, with the codes rotated through
copies that hold three times the 50 MB L2, at the three shapes ``PERF.md``
reports (64 cache heads at 2079 / 1531 keys; 32 heads at 2080, both at the
main path's capacity, 2176 for int8 and 2304 for int4; 8 heads of G 4 at
32031 keys, C 32801), each beside its bound; a length sweep with its
least-squares fixed cost and streaming rate; each shape's worst head
against the plain version (``chip_smoke.kq_case``); the ptxas lines of the
library's kernels; and, where the toolkit has ``cuobjdump``, the I2F/I2FP
instructions of each kernel and the opcode counts of the key loop of the
one-launch kernel at G 1.  Imports only torch, numpy and the copy under
test.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kvcache_factory_tpu_torch.ops.kernels import _build, decode_attn_quant  # noqa: E402

# nbits -> (the wrapper's name, the main path's capacity, the head_dim 128, G 1
# kernel's mangled name fragment)
KERNELS = {8: ("quant_decode_attention_append", 2176, "quant8_decode_kernelILi128ELi1EE"),
           4: ("quant4_decode_attention_append", 2304, "quant4_decode_kernelILi128ELi1EE")}
SWEEP = (0, 256, 1024, 2079)  # keys a head, 64 heads, the main path's capacity


def shapes(C):
    """(label, H, G, C, keys of each head)"""
    return (("64h", 64, 1, C, [2079] * 32 + [1531] * 32),
            ("32h", 32, 1, C, [2080] * 32),
            ("32k", 8, 4, 32801, [32031] * 8))


def kernel_ms(rng, nbits, H, G, C, keys, reps):
    """Device time per call and the bound of one call at this shape."""
    kernel = getattr(decode_attn_quant, KERNELS[nbits][0])
    q, kc, vc, sc, kn, vn = cs.kq_inputs(rng, nbits, H, G, C)
    n = max(4, -(-150_000_000 // (2 * kc.numel() + 2 * sc.numel())))
    copies = [(kc.clone(), vc.clone(), sc.clone()) for _ in range(n)]
    lens = torch.tensor(keys, dtype=torch.int32, device="cuda")
    calls = [lambda c=c: kernel(q, *c, lens, kn, vn) for c in copies]
    ms = [cs.graph_ms(calls * max(1, 20 // n)) for _ in range(reps)]
    D, W = 128, kc.shape[2]
    n_keys = int(np.minimum(keys, C - 1).sum())
    nbytes = n_keys * (2 * W + 8) + H * (2 * D * (2 * G + 2) + 2 * W + 8 + 4)
    return ms, nbytes


def sass(lib, loop_fn):
    """I2F/I2FP instructions of each kernel in ``lib``, and the opcodes of
    the key loop of the function whose name holds ``loop_fn`` (the backward
    branch whose body holds the most HMMA); None where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    i2f, fn, body_ops = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            i2f[fn] = []
        elif fn and (m := re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?(\S+)(.*?);", line)):
            addr, op, args = int(m.group(1), 16), m.group(2), m.group(3)
            if op.startswith("I2F"):
                i2f[fn].append(op)
            if loop_fn in fn:
                body_ops.append((addr, op, args))
    loops = [(int(b.group(1), 16), a) for a, op, args in body_ops
             if op == "BRA" and (b := re.search(r"0x([0-9a-f]+)", args)) and int(b.group(1), 16) < a]
    body = max(([op for a, op, _ in body_ops if lo <= a <= hi] for lo, hi in loops),
               key=lambda ops: sum(o.startswith("HMMA") for o in ops), default=[])
    ops = {}
    for op in body:
        ops[op] = ops.get(op, 0) + 1
    return {"i2f": {f: v for f, v in i2f.items() if v or "quant" in f},
            "loop": {"function": loop_fn, "instructions": len(body),
                     "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:16])}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nbits", type=int, choices=(8, 4), default=4,
                    help="8 times K3 (int8), 4 times K4 (int4)")
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=2, help="timings of each shape")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the check against the plain version (a copy edited to time "
                         "one part of the kernel alone computes the wrong output)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kq: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    report = _build.build_all(["decode_attn_quant"]).get("decode_attn_quant", "")
    ptxas = [line.strip() for line in report.splitlines()
             if any(k in line for k in ("Function properties", "spill", "registers"))]
    nbits, (_, C_main, loop_fn) = args.nbits, KERNELS[args.nbits]
    label = f"{args.label} int{nbits}"
    rng = np.random.default_rng(0)
    timed = {}
    for name, H, G, C, keys in shapes(C_main):
        # Held to the plain version first (chip_smoke.kq_case raises if not).
        rel = None if args.no_check else cs.kq_case(rng, nbits, H, G, C, keys,
                                                     np.zeros(H, np.int64))[8]
        ms, nbytes = kernel_ms(rng, nbits, H, G, C, keys, args.reps)
        timed[name] = {"us": [t * 1e3 for t in ms], "rel_l2": rel, "bytes": nbytes,
                       "bound_us": nbytes / cs.HBM_BYTES_PER_S * 1e6}
        print(f"{label} {name}: {[round(t * 1e3, 2) for t in ms]} us, bound "
              f"{timed[name]['bound_us']:.2f} us", file=sys.stderr, flush=True)
    points = []
    for k in SWEEP:
        ms, _ = kernel_ms(rng, nbits, 64, 1, C_main, [k] * 64, 1)
        points.append((k * 64 * (2 * 128 * nbits // 8 + 8), ms[0]))
    nbytes, ms = np.array(points, dtype=np.float64).T
    slope, fixed_ms = np.polyfit(nbytes, ms, 1)
    print(json.dumps({"label": label, "card": card, "shapes": timed,
                      "sweep": {"keys": list(SWEEP), "us": [t * 1e3 for t in ms],
                                "fixed_us": fixed_ms * 1e3, "stream_tb_s": 1 / slope / 1e9},
                      "ptxas": ptxas, "sass": sass(_build._lib_path("decode_attn_quant"), loop_fn)}))


if __name__ == "__main__":
    main()
