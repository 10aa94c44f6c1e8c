#!/usr/bin/env python3
"""Time K1, the port's flash-prefill kernel, at the shapes of
``chip_smoke.py``'s phases 3, 3b and 3c, on one NVIDIA H100.

    python3 tools/time_k1.py [--label NAME]

Run it from the root of a checkout of this repository, or of an older copy
of it: a git-ignored directory such as ``build/old/`` holding an earlier
commit's ``kvcache_factory_tpu_torch/`` and ``chip_smoke.py`` (``git
archive <commit> kvcache_factory_tpu_torch chip_smoke.py | tar -x -C
build/old``; then ``cd build/old && python3 ../../tools/time_k1.py``).  It
imports ``chip_smoke`` and the port from the working directory, so the
kernel it builds and times is that copy's, and it calls only the phase
functions every version of ``chip_smoke.py`` since K1's variants were
ported has (``phase_k1``, ``phase_k1_variants``, ``phase_k1_sparse``, on
one generator seeded 0, as the script runs them), each of which holds the
kernel to its plain version before it times it.  To compare two versions
on one card, run both in one call, in turns: old, new, new, old.

It prints one JSON line: the label, the card's name and power limit, and
each kernel's device time (``ms``), bound and SDPA time at those shapes.
Imports only torch, numpy and the copy under test.
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
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke
    from kvcache_factory_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("time_k1: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all(["flash_prefill"])
    rng = np.random.default_rng(0)
    dense = chip_smoke.phase_k1(rng)
    sw, chunk = chip_smoke.phase_k1_variants(rng)
    ashape, vslash, _ = chip_smoke.phase_k1_sparse(rng)
    rows = {e["name"]: {key: e.get(key) for key in ("ms", "bound_ms", "library_ms")}
            for e in (dense, sw, chunk, ashape, vslash)}
    print(json.dumps({"label": args.label, "card": card, "kernels": rows}), flush=True)


if __name__ == "__main__":
    main()
