#!/usr/bin/env python3
"""Time K1's window-score pass alone at the shapes of ``chip_smoke.py``'s
phase 3j on one NVIDIA H100, or compare K1's machine code with another
checkout's, function by function.

    python3 tools/time_scores.py [--label NAME]
    python3 tools/time_scores.py --sass OTHER_CHECKOUT

Timing: run it from the root of a checkout of this repository, or of an
older copy of it (a git-ignored directory such as ``build/old/`` holding an
earlier commit's ``kvcache_factory_tpu_torch/`` and ``chip_smoke.py``: ``git
archive <commit> kvcache_factory_tpu_torch chip_smoke.py | tar -x -C
build/old``, then ``cd build/old && python3 ../../tools/time_scores.py``).
It imports ``chip_smoke`` and the port from the working directory, so the
kernels it builds and times are that copy's, through helpers every
``chip_smoke.py`` since head_dims above 512 were ported has (``k1_case``,
which holds K1, scores included, to its plain version, and ``k1_pass_ms``,
the device time of each named kernel from profiler rows, on a
``DeviceDraws(23)`` generator).  The score pass is whichever of the score
kernels' names the profile holds: ``window_scores_kernel`` and
``window_scores_wide_kernel`` (the scalar passes up to and above head_dim
512) or ``window_scores_tc_kernel`` (the tensor-core pass of
``csrc/window_scores.cuh``).  To compare two versions on one card, run
both in one call, in turns: old, new, new, old.  Shapes: B 2, S 4096,
true_len (4096, 3000); 32 / 8 heads of 128 at W 8, 32 and 128; 4 / 1 heads
of 1024 and of 514 at W 128.  It prints one JSON line: the label, the
card's name and power limit, and each shape's main-pass and score-pass
times.

``--sass``: builds K1's libraries (``flash_prefill``, ``_p8``, ``_p4``,
``flash_prefill_wide``) from this checkout and from ``OTHER_CHECKOUT`` with
``tools/same_sass.py``'s builder, every build side by side, and prints for
each library the functions whose SASS is identical, those that differ and
those that exist in one build only (names with the anonymous namespace's
hash removed).  Needs nvcc and cuobjdump (the machine with the card).

Imports only torch, numpy and the copy under test.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = (("d128_w8", 32, 8, 128, 8), ("d128_w32", 32, 8, 128, 32),
          ("d128_w128", 32, 8, 128, 128), ("d1024_w128", 4, 1, 1024, 128),
          ("d514_w128", 4, 1, 514, 128))
SCORE_NAMES = ("window_scores_kernel", "window_scores_wide_kernel", "window_scores_tc_kernel")
K1_LIBRARIES = ("flash_prefill", "flash_prefill_p8", "flash_prefill_p4", "flash_prefill_wide")


def time_shapes(label):
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from kvcache_factory_tpu_torch.ops.kernels import _build, flash_prefill

    if not torch.cuda.is_available():
        raise SystemExit("time_scores: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all(["flash_prefill", "flash_prefill_wide"])
    rng = chip_smoke.DeviceDraws(23)
    tls, rows = [4096, 3000], {}
    for name, Hq, Hkv, D, W in SHAPES:
        q, k, v, tl = chip_smoke.k1_case(rng, 2, Hq, Hkv, 4096, W, tls, D)[:4]
        main = "flash_fwd_kernel" if D <= 512 else "flash_cluster_kernel"
        passes = chip_smoke.k1_pass_ms(
            lambda: flash_prefill.flash_prefill_attention(q, k, v, tl, W),
            names=(main,) + SCORE_NAMES)
        found = {n: t for n, t in passes.items() if t is not None and n in SCORE_NAMES}
        if len(found) != 1 or passes[main] is None:
            raise SystemExit(f"time_scores: the profile at {name} holds {passes}")
        (kernel, ms), = found.items()
        rows[name] = {"main_pass_ms": passes[main], "score_pass_ms": ms, "score_kernel": kernel}
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({"label": label, "card": card, "shapes": rows}), flush=True)


def compare_sass(other):
    spec = importlib.util.spec_from_file_location("same_sass", REPO / "tools" / "same_sass.py")
    same_sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(same_sass)
    _build = same_sass._build
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for name in K1_LIBRARIES:
            source, defines = _build._source(name)
            for side, root in (("this", REPO), ("other", Path(other).resolve())):
                jobs.append((root / "kvcache_factory_tpu_torch" / "csrc" / source.name, defines,
                             Path(tmp) / f"{side}_{name}.so"))
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(lambda job: same_sass.sass_functions(*job), jobs))
    for i, name in enumerate(K1_LIBRARIES):
        mine, theirs = built[2 * i], built[2 * i + 1]
        both = sorted(set(mine) & set(theirs))
        print(json.dumps({
            "library": name,
            "identical": [f for f in both if mine[f] == theirs[f]],
            "differ": [f for f in both if mine[f] != theirs[f]],
            "this_only": sorted(set(mine) - set(theirs)),
            "other_only": sorted(set(theirs) - set(mine))}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    parser.add_argument("--sass", metavar="OTHER_CHECKOUT")
    args = parser.parse_args()
    if args.sass:
        compare_sass(args.sass)
    else:
        time_shapes(args.label)


if __name__ == "__main__":
    main()
