"""Torch's CPU thread counts for the port's tests.

Every ``tests/test_torch_*.py`` imports this module before anything that
runs torch.  Tier-1 runs the suite in several pytest-xdist workers at once
(``-n 6``), and torch starts one intra-op OpenMP thread per core in each of
them: six workers on eight cores then run 48 spinning threads, and a call
that takes a second alone takes minutes.  So under xdist each worker takes
its share of the cores, ``os.cpu_count() // workers`` threads (at least
one), for torch's intra-op and inter-op pools, and exports it as
``OMP_NUM_THREADS`` to the processes it starts (the CLI under torchrun, the
examples in a subprocess).  Ranks spawned by ``tests/torch_sp_worker.py``
set one thread each themselves.  A run without xdist, or with
``OMP_NUM_THREADS`` already set, keeps torch's own choice.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def share(cpus: Optional[int], workers: Optional[str]) -> Optional[int]:
    """Threads for one of ``workers`` xdist workers on ``cpus`` cores; None
    outside xdist."""
    if not workers:
        return None
    return max(1, (cpus or 1) // max(1, int(workers)))


THREADS = None if "OMP_NUM_THREADS" in os.environ else share(
    os.cpu_count(), os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

if THREADS is not None:
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    torch.set_num_threads(THREADS)
    try:
        torch.set_num_interop_threads(THREADS)
    except RuntimeError:  # the inter-op pool already ran work: it keeps its size
        pass
