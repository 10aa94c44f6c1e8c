"""LongBench evaluation support (port of ``kvcache_factory_tpu/evals/longbench.py``).

Only HeadKV's capacity loader is ported so far; the runner, prompts and
scoring come with ROADMAP.md queue 1 item 12.
"""

from __future__ import annotations

import json

import numpy as np


def headkv_capacities(head_path: str, num_layers: int, num_heads: int,
                      max_capacity: int, head_beta: float = 1.01) -> np.ndarray:
    """Per-(layer, head) budgets ``[L, H]`` int32 from a retrieval-reasoning
    head-score file (the first line: a JSON object of per-head score lists,
    layer-major): normalized mean scores times the pooled capacity, plus a
    floor (reference run_longbench.py:225-234)."""
    with open(head_path) as f:
        head_list = json.loads(f.readline())
    scores = np.array([np.mean(v) for v in head_list.values()], np.float64)
    scores = scores / scores.sum()
    total_attention = scores.reshape(num_layers, num_heads)
    total_pool = (max_capacity // head_beta) * num_layers * num_heads
    min_num = max_capacity - max_capacity // head_beta
    return np.round(total_attention * total_pool + min_num).astype(np.int32)
