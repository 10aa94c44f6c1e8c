"""The sequence-parallel process group: the port's counterpart of the JAX
engine's sp mesh (``kvcache_factory_tpu/runtime/engine.py:66-94``), for sp
alone.

``sp`` ranks share one prompt; rank ``r`` holds rows ``[r * S / sp,
(r + 1) * S / sp)`` of every activation of a bucket of ``S`` rows
(:meth:`SequenceParallelGroup.bounds`).  Ring attention moves K/V shards one
rank along the ring (:meth:`SequenceParallelGroup.shift`), and prefill
fetches a few rows from the ranks that own them
(:meth:`SequenceParallelGroup.gather_rows`).

The transport follows the group's backend.  NCCL moves device tensors.
Gloo moves CPU tensors; a CUDA tensor is staged through a pinned host
buffer explicitly (ranks that share one card cannot form an NCCL
communicator), and the bytes and host time staged are counted in
``staged_bytes`` and ``staged_s``.  Only copies pass through the host: no
compute moves to the CPU.  Give ``torch.distributed.init_process_group`` its
rendezvous (a ``file://`` or ``tcp://localhost`` address), world size and
rank yourself.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class SequenceParallelGroup:
    """The ranks of one ``torch.distributed`` group (the default group when
    ``group`` is None) as one sequence-parallel ring."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("sequence parallelism needs an initialized "
                             "torch.distributed process group")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self._next = self._global_rank((self.rank + 1) % self.size)
        self._prev = self._global_rank((self.rank - 1) % self.size)
        self.staged_bytes = 0
        self.staged_s = 0.0
        self._pinned: Dict[Tuple[str, int], torch.Tensor] = {}

    def _global_rank(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def bounds(self, S: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a bucket of ``S`` rows."""
        if S % self.size:
            raise ValueError(f"a bucket of {S} rows does not split over "
                             f"sp={self.size} ranks")
        n = S // self.size
        return self.rank * n, (self.rank + 1) * n

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend != "nccl"

    def _host(self, key: Tuple[str, int], like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer shaped like ``like``, kept for the next call."""
        buf = self._pinned.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def shift(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """One step of the ring: send each tensor to rank + 1 and return the
        tensors of the same shapes received from rank - 1."""
        staged = self._staged(tensors[0])
        t0 = time.perf_counter()
        if staged:
            sends = [self._host(("send", i), t) for i, t in enumerate(tensors)]
            for host, t in zip(sends, tensors):
                host.copy_(t, non_blocking=True)
            torch.cuda.current_stream(tensors[0].device).synchronize()
            recvs = [self._host(("recv", i), t) for i, t in enumerate(tensors)]
        else:
            sends = [t.contiguous() for t in tensors]
            recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, peer=self._next, group=self.group, tag=i)
               for i, t in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, t, peer=self._prev, group=self.group, tag=i)
                for i, t in enumerate(recvs)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if not staged:
            return recvs
        # A blocking copy from pinned memory: the buffers are free on return.
        out = [host.to(t.device) for host, t in zip(recvs, tensors)]
        self.staged_bytes += sum(t.numel() * t.element_size() for t in sends)
        self.staged_s += time.perf_counter() - t0
        return out

    def gather_rows(self, t: torch.Tensor, rows: torch.Tensor, dim: int) -> torch.Tensor:
        """The rows ``rows [B, R]`` (global ids along axis ``dim`` of ``t``,
        of which this rank holds its shard; axis 0 is the batch), each taken
        from the rank that owns it: ``[B, R, *rest]``, ``rest`` being ``t``'s
        other axes in order.  Every rank receives the same bytes.  Meant for
        a few rows: every rank's pick of all ``R`` rows is gathered."""
        B, S_loc = t.shape[0], t.shape[dim]
        local = (rows - self.rank * S_loc).clamp(0, S_loc - 1)
        picked = torch.stack([t[b].index_select(dim - 1, local[b]).movedim(dim - 1, 0)
                              for b in range(B)])                 # [B, R, *rest]
        staged = self._staged(picked)
        t0 = time.perf_counter()
        src = picked.cpu() if staged else picked
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        every = torch.stack(parts)                                # [n, B, R, *rest]
        if staged:
            every = every.to(picked.device)
            self.staged_bytes += src.numel() * src.element_size()
            self.staged_s += time.perf_counter() - t0
        owner = (rows // S_loc).clamp(0, self.size - 1)
        idx = owner.reshape(1, *owner.shape, *([1] * (every.dim() - 3)))
        return every.gather(0, idx.expand(1, *every.shape[1:]))[0]
