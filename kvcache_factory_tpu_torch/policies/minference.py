"""MInference per-model sparse-pattern configuration (port of
``kvcache_factory_tpu/policies/minference.py``; numpy only, kept as the
port's own copy).

The reference loads a per-model "best pattern" JSON through the external
``minference`` package (pyramidkv/minference.py:9-12).  The schema of those
files (MInference's ``configs/*.json``) is a list with one dict per layer,
mapping the head index (as a string) to ``[pattern_name, vertical_size,
slash_size, _]``, e.g.::

    [
      {"0": ["vertical_and_slash", 1000, 6096, 1],
       "1": ["vertical_and_slash", 3500, 100, 1], ...},   # layer 0
      ...                                                  # layer 1..L-1
    ]

The loader produces the dense ``[L, Hq, 2]`` int32 (vertical, slash) budget
array that ``models/llama.prefill`` slices per layer into the flash
kernel's ``sparse_head_budgets``, where the mask estimation
(``ops/kernels/flash_prefill.py::vertical_slash_block_mask``) ranks at the
pattern's static sizes and each head keeps only its first ``budget``
ranked columns / diagonals.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np


def load_sparse_budgets(path: str, num_layers: int, num_heads: int,
                        v_cap: int, s_cap: int) -> np.ndarray:
    """Load an MInference best-pattern JSON into a [L, Hq, 2] budget array.

    ``v_cap`` / ``s_cap`` are the pattern's static top-k sizes (the
    ``sparse_prefill`` tuple's v_topk / s_topk): per-head budgets are
    clipped to them.  Heads missing from a layer's dict, layers beyond the
    file and patterns other than ``vertical_and_slash`` keep the full
    static budget (dense-within-top-k, the conservative superset).
    """
    with open(path) as f:
        cfg = json.load(f)
    if not isinstance(cfg, list):
        raise ValueError(
            f"{path}: expected the MInference best-pattern schema (a list "
            "with one dict per layer, head index -> [pattern, v, s, ...])")
    out = np.full((num_layers, num_heads, 2), (v_cap, s_cap), np.int32)
    for li, layer in enumerate(cfg[:num_layers]):
        for hs, spec in layer.items():
            h = int(hs)
            if h >= num_heads:
                continue
            if not (isinstance(spec, (list, tuple)) and len(spec) >= 3
                    and spec[0] == "vertical_and_slash"):
                continue  # other patterns: keep the full static budget
            out[li, h, 0] = min(int(spec[1]), v_cap)
            out[li, h, 1] = min(int(spec[2]), s_cap)
    return out


def default_pattern() -> Tuple[str, int, int, int]:
    """The default pattern when no config file is given: vertical-slash with
    1024 columns / 128 diagonals estimated from the last 64 queries."""
    return ("vertical_slash", 1024, 128, 64)
