#!/usr/bin/env python3
"""Time the port's kernels above head_dim 512, K1 (dense with window scores,
and the chunk pool) and K3, at the shapes of ``chip_smoke.py``'s phases 3i
and 4j, on one NVIDIA H100.

    python3 tools/time_wide.py [--label NAME] [--k1-dims 514,1004,1024,2048]
                               [--kq-dims 640,1024,2048]

Run it from the root of a checkout of this repository, or of an older copy
of it: a git-ignored directory such as ``build/old/`` holding an earlier
commit's ``kvcache_factory_tpu_torch/`` and ``chip_smoke.py`` (``git
archive <commit> kvcache_factory_tpu_torch chip_smoke.py | tar -x -C
build/old``; then ``cd build/old && python3 ../../tools/time_wide.py``).  It
imports ``chip_smoke`` and the port from the working directory, so the
kernels it builds and times are that copy's, through helpers every
``chip_smoke.py`` since head_dims above 512 were ported has (``k1_case``,
``time_k1``, ``k1v_case``, ``time_k1v``, ``kq_case``, ``time_kq`` on a
``DeviceDraws(21)`` generator), each of which holds the kernel to its plain
version before it is timed.  To compare two versions on one card, run both
in one call, in turns: old, new, new, old.

Shapes: K1 at B=2, 4 / 1 heads, S 4096, w 8, true_len (4096, 3000); the
chunk pool 4 x 2048 q rows over 4096-row buffers, offsets (0, 2048, 2048,
0), true_len (4096, 4096, 3000, 0); K3 at G 1, 8 heads (B 2 x 4) with 2079
/ 1531 keys, C 2176.  It prints one JSON line: the label, the card's name
and power limit, and for each kernel and width the device time (``ms``),
the bound, the plain version's time and the library call's (K1: SDPA) or
the dequantize + SDPA composite's (K3).  Imports only torch, numpy and the
copy under test.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    parser.add_argument("--k1-dims", default="514,1004,1024,2048")
    parser.add_argument("--kq-dims", default="640,1024,2048")
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke
    from kvcache_factory_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("time_wide: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    wanted = ("flash_prefill_wide", "decode_attn_quant_wide", "decode_attn_quant_cluster")
    _build.build_all([name for name in wanted if name in _build.SIGNATURES])
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "composite_ms")
    pick = lambda t: {key: t[key] for key in keys if t.get(key) is not None}  # noqa: E731
    rng = chip_smoke.DeviceDraws(21)
    rows = {}
    tls = [4096, 3000]
    for D in map(int, args.k1_dims.split(",")):
        q, k, v, tl, sc = chip_smoke.k1_case(rng, 2, 4, 1, 4096, 8, tls, D, tail=True)[:5]
        rows[f"K1 d{D}"] = pick(chip_smoke.time_k1(q, k, v, tl, 8, tls, sc))
        del q, k, v, sc
        offsets = [0, 2048, 2048, 0]
        c = chip_smoke.k1v_case(rng, 4, 4, 1, 2048, 4096, [4096, 4096, 3000, 0], None, offsets,
                                D, tail=True)
        rows[f"K1-chunk d{D}"] = pick(chip_smoke.time_k1v(c, None, offsets))
        del c
        torch.cuda.empty_cache()
    lens = [2048 + 31] * 4 + [1500 + 31] * 4
    for D in map(int, args.kq_dims.split(",")):
        q, kc, vc, sc, kn, vn, lt = chip_smoke.kq_case(rng, 8, 8, 1, 2176, lens,
                                                       np.zeros(8, np.int64), D=D, tail=True)[:7]
        rows[f"K3 d{D}"] = pick(chip_smoke.time_kq(8, q, kc, vc, sc, kn, vn, lt))
        del q, kc, vc, sc
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "card": card, "kernels": rows}), flush=True)


if __name__ == "__main__":
    main()
