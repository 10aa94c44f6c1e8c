"""Process groups and parameter shards of the parallel layer: the port's
counterpart of the JAX package's meshes (``kvcache_factory_tpu/parallel/
mesh.py`` and the ``(dp, sp, tp)`` mesh of ``runtime/engine.py:66-99``).

JAX is single-controller: one process, and GSPMD inserts the collectives.
The port is multi-controller: one process per rank, each holding its own
shard.  The caller brings up the ``torch.distributed`` process group (a
script calls ``init_process_group`` itself; the CLI runs under
``torchrun``), and :class:`ParallelGroups` lays its ranks out as the
``(dp, sp, tp)`` grid, or the ``(dp, ep, tp)`` grid of an expert-parallel
layout (sp and ep never compose), in row-major order, as ``mesh_utils.
create_device_mesh`` lays out JAX's devices, with one subgroup
(``dist.new_group``) per axis:

* ``dp`` ranks hold rows ``[d * B / dp, (d + 1) * B / dp)`` of the batch;
* ``sp`` ranks share one prompt; rank ``r`` holds rows ``[r * S / sp,
  (r + 1) * S / sp)`` of every activation of a bucket of ``S`` rows
  (:meth:`SequenceParallelGroup.bounds`).  Ring attention moves K/V shards
  one rank along the ring (:meth:`SequenceParallelGroup.shift`), and
  prefill fetches a few rows from the ranks that own them
  (:meth:`SequenceParallelGroup.gather_rows`);
* ``ep`` ranks hold ``E / ep`` of a Mixtral layer's experts each
  (:func:`shard_tree`); attention, the router, norms, embedding and
  ``lm_head`` are replicated over ep, and the MoE block's output is
  reduced once over the ``(ep, tp)`` plane (:attr:`ParallelGroups.ep`);
* ``tp`` ranks hold a Megatron-style shard of the weights
  (:func:`param_specs`, :func:`shard_params`): their query heads, the KV
  heads those read, their FFN columns and their vocabulary columns.  A
  layer reduces twice over tp (after ``o_proj`` and after the FFN), and
  the logits are gathered over tp before any token is chosen.

``dcn_dp`` of the dp ways cross hosts (:func:`check_dcn`): on one host
the layout is plain dp.  Pipeline stages (``pp``) are the ranks of the
default group in order (``parallel/pipeline.py``); they talk point to
point (:meth:`StagedGroup.exchange`).

The transport follows the group's backend (:class:`StagedGroup`).  NCCL
moves device tensors when each rank has its own card.  Gloo moves CPU
tensors; a CUDA tensor is staged through a pinned host buffer explicitly
(ranks that share one card cannot form an NCCL communicator), and the
bytes and host time staged are counted in ``staged_bytes`` and
``staged_s``.  Only copies pass through the host: no compute moves to the
CPU (a staged reduction gathers the parts and sums them on the card).
Give ``torch.distributed.init_process_group`` its rendezvous (a ``file://``
or ``tcp://localhost`` address), world size and rank yourself.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig, ShardingConfig


class StagedGroup:
    """Collectives over the ranks of one ``torch.distributed`` group (the
    default group when ``group`` is None), by the transport rule above.
    ``collectives`` counts every call that communicates; ``staged_bytes``
    and ``staged_s`` the bytes this rank sent through the host and the host
    time those calls took."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("a parallel layout needs an initialized torch.distributed "
                             "process group")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self._pinned: Dict[Tuple, torch.Tensor] = {}
        self.reset_counts()

    def reset_counts(self) -> None:
        self.collectives = 0
        self.staged_bytes = 0
        self.staged_s = 0.0

    def _global_rank(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend != "nccl"

    def _host(self, key: Tuple, shape, dtype: torch.dtype) -> torch.Tensor:
        """A pinned host buffer of ``shape``, kept under ``key`` for the
        next call of that shape."""
        buf = self._pinned.get(key)
        if buf is None or buf.shape != tuple(shape) or buf.dtype != dtype:
            buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _to_host(self, key: Tuple, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Copies of device tensors in pinned buffers, complete on return."""
        hosts = [self._host(key + (i,), t.shape, t.dtype) for i, t in enumerate(tensors)]
        for host, t in zip(hosts, tensors):
            host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(tensors[0].device).synchronize()
        return hosts

    def _count(self, nbytes: int, t0: float) -> None:
        self.staged_bytes += nbytes
        self.staged_s += time.perf_counter() - t0

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[Tuple[int, ...], torch.dtype, int]],
                 device=None) -> List[torch.Tensor]:
        """Point to point: send each ``(tensor, peer)`` and receive each
        ``(shape, dtype, peer)`` (peers are ranks of this group), all posted
        at once, so that ranks exchanging in both directions cannot wait on
        each other; returns the received tensors on ``device`` (the sent
        tensors' device by default), complete on return.  Several tensors
        between one pair of ranks match in order.  One call that moves
        anything counts as one collective; staged bytes are this rank's
        sends."""
        if not sends and not recvs:
            return []
        self.collectives += 1
        if device is None:
            device = sends[0][0].device if sends else torch.device("cpu")
        device = torch.device(device)
        staged = self.backend != "nccl" and (device.type == "cuda" or any(
            t.is_cuda for t, _ in sends))
        t0 = time.perf_counter()
        tags: Dict[Tuple[str, int], int] = {}

        def tag(kind, peer):
            tags[kind, peer] = tags.get((kind, peer), -1) + 1
            return tags[kind, peer]
        send_tags = [tag("send", peer) for _, peer in sends]
        recv_tags = [tag("recv", peer) for *_, peer in recvs]
        if staged:
            out = ([] if not sends else
                   self._to_host(("xsend",) + tuple((tuple(t.shape), t.dtype, p)
                                                   for t, p in sends), [t for t, _ in sends]))
            bufs = [self._host(("xrecv", i, p), shape, dtype)
                    for i, (shape, dtype, p) in enumerate(recvs)]
        else:
            out = [t.contiguous() for t, _ in sends]
            bufs = [torch.empty(shape, dtype=dtype, device=device) for shape, dtype, _ in recvs]
        ops = [dist.P2POp(dist.isend, t, peer=self._global_rank(p), group=self.group, tag=tg)
               for t, (_, p), tg in zip(out, sends, send_tags)]
        ops += [dist.P2POp(dist.irecv, t, peer=self._global_rank(p), group=self.group, tag=tg)
                for t, (*_, p), tg in zip(bufs, recvs, recv_tags)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if not staged:
            return bufs
        # A blocking copy from pinned memory: the buffers are free on return.
        got = [b.to(device) for b in bufs]
        self._count(sum(t.numel() * t.element_size() for t in out), t0)
        return got

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, stacked in rank order: ``[size, *t.shape]``
        on ``t``'s device, the same bytes on every rank."""
        self.collectives += 1
        t = t.contiguous()
        if not self._staged(t):
            out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
            if self.backend == "nccl":
                dist.all_gather_into_tensor(out, t, group=self.group)
            else:
                dist.all_gather(list(out.unbind(0)), t, group=self.group)
            return out
        t0 = time.perf_counter()
        # Buffers kept per shape: a layer alternates between a few shapes.
        key = (tuple(t.shape), t.dtype)
        (src,) = self._to_host(("gather_send",) + key, [t])
        dst = self._host(("gather_recv",) + key, (self.size,) + tuple(t.shape), t.dtype)
        dist.all_gather(list(dst.unbind(0)), src, group=self.group)
        # A blocking copy from pinned memory: the buffers are free on return.
        out = dst.to(t.device)
        self._count(src.numel() * src.element_size(), t0)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor).  NCCL reduces on
        the card; otherwise the parts are gathered and summed in rank order
        on ``t``'s device (one rounding to ``t``'s dtype), so every rank
        holds the same bytes and no sum runs on the host for a card's
        tensor."""
        if self.backend == "nccl" and t.is_cuda:
            self.collectives += 1
            out = t.contiguous().clone()
            dist.all_reduce(out, group=self.group)
            return out
        return self.all_gather(t).sum(dim=0, dtype=t.dtype)


class SequenceParallelGroup(StagedGroup):
    """The ranks of one group (the default group when ``group`` is None)
    as one sequence-parallel ring."""

    def bounds(self, S: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a bucket of ``S`` rows."""
        if S % self.size:
            raise ValueError(f"a bucket of {S} rows does not split over "
                             f"sp={self.size} ranks")
        n = S // self.size
        return self.rank * n, (self.rank + 1) * n

    def shift(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """One step of the ring: send each tensor to rank + 1 and return the
        tensors of the same shapes received from rank - 1
        (:meth:`StagedGroup.exchange`)."""
        nxt, prev = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        return self.exchange([(t, nxt) for t in tensors],
                             [(tuple(t.shape), t.dtype, prev) for t in tensors],
                             device=tensors[0].device)

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
        every = self.all_gather(picked)                           # [n, B, R, *rest]
        owner = (rows // S_loc).clamp(0, self.size - 1)
        idx = owner.reshape(1, *owner.shape, *([1] * (every.dim() - 3)))
        return every.gather(0, idx.expand(1, *every.shape[1:]))[0]


# ---------------------------------------------------------------------------
# The (dp, sp, tp) grid
# ---------------------------------------------------------------------------


def shard_model_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The widths one of ``tp`` ranks computes: its ``Hq / tp`` query heads,
    the KV heads they read (``Hkv / tp``, or one when ``tp > Hkv``: each
    rank's query heads then share one KV head, replicated across the ranks
    that read it) and its ``F / tp`` FFN columns.  ``vocab_size`` stays the
    model's: the logits are gathered over tp.  ``ValueError`` where a width
    does not split, as JAX's ``device_put`` refuses an uneven shard."""
    if tp == 1:
        return cfg
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    for what, n in (("num_attention_heads", Hq), ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {what}={n}")
    if Hkv % tp and tp % Hkv:
        raise ValueError(f"tp={tp} must divide num_key_value_heads={Hkv} or be a multiple "
                         "of it (each rank's query heads must read whole KV heads)")
    return dataclasses.replace(cfg, num_attention_heads=Hq // tp,
                               num_key_value_heads=max(Hkv // tp, 1),
                               intermediate_size=cfg.intermediate_size // tp)


def kv_head_offset(cfg: ModelConfig, tp: int, rank: int) -> int:
    """The first KV head rank ``rank`` of ``tp`` reads."""
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    return rank * (Hq // tp) // (Hq // Hkv)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The axis tp splits in each leaf of ``models/weights.py``'s tree (None:
    replicated), the counterpart of JAX's ``param_specs``
    (``parallel/mesh.py:84-124``): column-parallel ``qkv_proj``,
    ``gate_up_proj``, their biases and ``lm_head`` (-1), row-parallel
    ``o_proj`` and ``down_proj`` (-2), replicated norms, embedding, router
    and the biases added after a reduction.  Negative axes, so that
    Mixtral's expert stacks ``[L, E, in, out]`` split each expert's FFN
    columns as the dense leaves do.  :func:`shard_leaf` cuts ``qkv`` and
    ``gate_up`` per component."""
    layers = {"qkv_proj": -1, "qkv_bias": -1, "o_proj": -2, "o_bias": None,
              "gate_up_proj": -1, "gate_up_bias": -1, "down_proj": -2, "down_bias": None,
              "input_norm": None, "post_norm": None}
    if cfg.is_moe:
        layers["router"] = None
    return {"embed": None, "layers": layers, "final_norm": None, "lm_head": -1}


def _cat(parts: List, axis: int):
    if isinstance(parts[0], np.ndarray):
        return np.ascontiguousarray(np.concatenate(parts, axis=axis))
    return torch.cat(parts, dim=axis).contiguous()


def _take(x, axis: int, lo: int, hi: int):
    index = [slice(None)] * x.ndim
    index[axis] = slice(lo, hi)
    return x[tuple(index)]


def shard_leaf(x, name: str, axis: Optional[int], cfg: ModelConfig, tp: int, rank: int):
    """Rank ``rank``'s shard of one leaf (a torch tensor or a numpy array)
    along ``axis``.  The fused leaves are not cut where they are contiguous
    (rank 0 would hold every q head and no k or v, or the gate and no up
    projection): ``qkv`` splits each of q, k and v by heads and re-fuses
    them, ``gate_up`` each of gate and up by FFN columns.  A returned
    tensor owns its memory, so the full leaf can be freed."""
    if axis is None or tp == 1:
        return x
    axis = axis % x.ndim
    n = x.shape[axis]
    if name.startswith("qkv"):
        Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        D = n // (Hq + 2 * Hkv)
        local = shard_model_config(cfg, tp)
        q0, kv0 = rank * local.num_attention_heads, kv_head_offset(cfg, tp, rank)
        nq, nkv = local.num_attention_heads, local.num_key_value_heads
        return _cat([_take(x, axis, q0 * D, (q0 + nq) * D),
                     _take(x, axis, (Hq + kv0) * D, (Hq + kv0 + nkv) * D),
                     _take(x, axis, (Hq + Hkv + kv0) * D, (Hq + Hkv + kv0 + nkv) * D)], axis)
    if name.startswith("gate_up"):
        F, f = n // 2, n // 2 // tp
        return _cat([_take(x, axis, rank * f, (rank + 1) * f),
                     _take(x, axis, F + rank * f, F + (rank + 1) * f)], axis)
    if n % tp:
        raise ValueError(f"tp={tp} does not divide axis {axis} of {name} ({n})")
    w = n // tp
    return _cat([_take(x, axis, rank * w, (rank + 1) * w)], axis)


def expert_slice(cfg: ModelConfig, ep: int, ep_rank: int) -> Tuple[int, int]:
    """Rank ``ep_rank`` of ``ep``'s experts ``[e0, e0 + n)``: contiguous
    blocks, as JAX's ``param_specs`` splits the expert axis over ``ep``
    (``parallel/mesh.py:97-102``)."""
    E = cfg.num_local_experts
    if not cfg.is_moe:
        raise ValueError("ep shards the experts of an MoE model; this model has none")
    if E % ep:
        raise ValueError(f"ep={ep} does not divide num_local_experts={E}")
    n = E // ep
    return ep_rank * n, n


def shard_tree(params: Dict[str, Any], cfg: ModelConfig, tp: int, rank: int,
               ep: int = 1, ep_rank: int = 0) -> Dict[str, Any]:
    """Rank ``rank``'s shard of a weight tree by :func:`param_specs`.  A
    W8A16 leaf ``{"q", "s"}`` shards ``q`` like its weight and ``s [..., 1,
    out]`` with the output columns of a column-parallel weight; a
    row-parallel weight's ``s`` is replicated (JAX ``mesh.py:138-166``).
    With ``ep`` the expert stacks ``gate_up_proj`` / ``down_proj`` ``[L, E,
    ...]`` (``q`` and ``s`` alike) keep rank ``ep_rank``'s experts
    (:func:`expert_slice`) before the tp cut inside each expert; every
    other leaf is replicated over ep."""
    shard_model_config(cfg, tp)  # the widths must split
    specs = param_specs(cfg)
    e0, n_e = expert_slice(cfg, ep, ep_rank) if ep > 1 else (0, 0)

    def experts(name, x):
        if ep == 1 or name not in ("gate_up_proj", "down_proj"):
            return x
        return _cat([_take(x, 1, e0, e0 + n_e)], 1)

    def leaf(name, x, axis):
        if isinstance(x, dict):
            s_axis = axis if axis == -1 else None
            return {"q": shard_leaf(experts(name, x["q"]), name, axis, cfg, tp, rank),
                    "s": shard_leaf(experts(name, x["s"]), name, s_axis, cfg, tp, rank)}
        return shard_leaf(experts(name, x), name, axis, cfg, tp, rank)

    missing = (set(params["layers"]) - set(specs["layers"])) | (set(params) - set(specs))
    if missing:
        raise ValueError(f"no shard spec for {sorted(missing)}")
    out = {k: leaf(k, v, specs[k]) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: leaf(k, v, specs["layers"][k]) for k, v in params["layers"].items()}
    return out


def check_dcn(sharding: ShardingConfig, world: Optional[int] = None,
              local_world: Optional[int] = None) -> int:
    """The hosts a layout's ranks span, by torchrun's ``WORLD_SIZE`` and
    ``LOCAL_WORLD_SIZE`` (one host where they are unset or equal).  On one
    host ``dcn_dp`` is plain dp, as JAX's flat mesh when
    ``process_count() == 1``; across hosts the leading ``dcn_dp`` ways of
    dp must be the hosts (ranks are numbered host by host, so a host
    holds ``world / hosts`` consecutive ranks), else ``ValueError``: the
    layout cannot put its inter-host ways across hosts."""
    world = int(os.environ.get("WORLD_SIZE", sharding.world)) if world is None else world
    local_world = (int(os.environ.get("LOCAL_WORLD_SIZE", world)) if local_world is None
                   else local_world)
    if world % local_world:
        raise ValueError(f"{world} ranks do not split into hosts of {local_world}")
    hosts = world // local_world
    if hosts == 1:
        return 1
    if hosts != sharding.dcn_dp:
        raise ValueError(f"dcn_dp={sharding.dcn_dp} must equal the hosts the ranks span "
                         f"({hosts}: {world} ranks, {local_world} a host): dp's inter-host "
                         "ways are the hosts, and only dp crosses them")
    return hosts


class ExpertShard(NamedTuple):
    """One rank's experts under ep: its first expert ``e0`` (it holds
    ``[e0, e0 + n)``, ``n`` from its weights) and the group over which the
    MoE block's output is reduced (the ``(ep, tp)`` plane)."""

    e0: int
    group: StagedGroup


class ParallelGroups:
    """The ``(dp, sp, tp)`` grid of ``sharding`` over the ranks of the
    default group, or its ``(dp, ep, tp)`` grid when ``ep > 1``, which must
    hold ``sharding.world`` ranks: this rank's coordinates (``dp_rank``,
    ``sp_rank``, ``ep_rank``, ``tp_rank``) and one group object per axis
    wider than one rank (``dp``, ``tp``: :class:`StagedGroup`; ``sp``:
    :class:`SequenceParallelGroup`; None for an axis of one rank).  Under
    ep, ``ep`` is the ``(ep, tp)`` plane of this rank's dp row: the ranks
    that hold one layer's experts between them, over which the MoE block
    is reduced once.  The subgroups come from ``dist.new_group``, which
    every rank of the default group calls for every subgroup in one order,
    so every rank builds the grid together (:func:`parallel_groups` builds
    each grid once per process)."""

    def __init__(self, sharding: ShardingConfig):
        mid_name, mid = ("ep", sharding.ep) if sharding.ep > 1 else ("sp", sharding.sp)
        layout = (f"ShardingConfig(dp={sharding.dp}, {mid_name}={mid}, tp={sharding.tp}"
                  + (f", dcn_dp={sharding.dcn_dp})" if sharding.dcn_dp > 1 else ")"))
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                f"{layout} needs an initialized torch.distributed process group of "
                f"{sharding.world} ranks: launch under torchrun --nproc-per-node "
                f"{sharding.world}, or call init_process_group in every rank")
        if sharding.pp > 1:
            raise ValueError("a pp layout runs on its stages (parallel/pipeline.py), "
                             "not on the (dp, sp|ep, tp) grid")
        world = dist.get_world_size()
        shape = (sharding.dp, mid, sharding.tp)
        if world != sharding.world:
            raise ValueError(f"{layout} needs a process group of {sharding.world} ranks, "
                             f"got {world}")
        if sharding.dcn_dp > 1:
            check_dcn(sharding, world)
        self.sharding = sharding
        self.rank = dist.get_rank()
        self.dp_rank, mid_rank, self.tp_rank = (int(c) for c in
                                                np.unravel_index(self.rank, shape))
        self.sp_rank, self.ep_rank = (0, mid_rank) if mid_name == "ep" else (mid_rank, 0)
        grid = np.arange(world).reshape(shape)
        self.dp = self._subgroup(grid, shape, world, (0,), StagedGroup)
        self.sp = self.ep = None
        if mid_name == "sp":
            self.sp = self._subgroup(grid, shape, world, (1,), SequenceParallelGroup)
        else:
            self.ep = self._subgroup(grid, shape, world, (1, 2), StagedGroup)
        self.tp = self._subgroup(grid, shape, world, (2,), StagedGroup)

    def _subgroup(self, grid, shape, world, axes, kind):
        """This rank's group over the grid ``axes`` (None for one rank):
        ``dist.new_group`` for every group of that kind, on every rank."""
        size = int(np.prod([shape[a] for a in axes]))
        if size == 1:
            return None
        if size == world:
            return kind()
        mine = None
        rest = [a for a in range(3) if a not in axes]
        for members in np.transpose(grid, rest + list(axes)).reshape(-1, size):
            g = dist.new_group(ranks=members.tolist())
            if self.rank in members:
                mine = kind(g)
        return mine

    @property
    def groups(self) -> Dict[str, StagedGroup]:
        """The axes wider than one rank, by name."""
        return {name: g for name, g in (("dp", self.dp), ("sp", self.sp), ("ep", self.ep),
                                        ("tp", self.tp)) if g is not None}

    def reset_counts(self) -> None:
        for g in self.groups.values():
            g.reset_counts()

    def counts(self) -> Dict[str, Dict[str, float]]:
        """Each axis's collectives, staged bytes and staged seconds."""
        return {name: {"collectives": g.collectives, "staged_bytes": g.staged_bytes,
                       "staged_s": g.staged_s} for name, g in self.groups.items()}

    def rows(self, B: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a batch of ``B`` (a multiple of dp)."""
        n = B // self.sharding.dp
        return self.dp_rank * n, (self.dp_rank + 1) * n

    def local_model(self, cfg: ModelConfig) -> ModelConfig:
        return shard_model_config(cfg, self.sharding.tp)

    def q_head_offset(self, cfg: ModelConfig) -> int:
        return self.tp_rank * (cfg.num_attention_heads // self.sharding.tp)

    def kv_head_offset(self, cfg: ModelConfig) -> int:
        return kv_head_offset(cfg, self.sharding.tp, self.tp_rank)

    def experts(self, cfg: ModelConfig) -> Optional[ExpertShard]:
        """This rank's :class:`ExpertShard` under ep (None without ep)."""
        if self.ep is None:
            return None
        return ExpertShard(expert_slice(cfg, self.sharding.ep, self.ep_rank)[0], self.ep)

    def gather_dp(self, t: torch.Tensor) -> torch.Tensor:
        """The dp ranks' ``t`` concatenated along axis 0, in dp order."""
        if self.dp is None:
            return t
        every = self.dp.all_gather(t)
        return every.reshape((-1,) + tuple(t.shape[1:]))


_GRIDS: Dict[Tuple, ParallelGroups] = {}


def parallel_groups(sharding: ShardingConfig) -> ParallelGroups:
    """The :class:`ParallelGroups` of ``sharding``, built once per process
    and default group (building one creates subgroups, a collective call of
    every rank)."""
    world = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    key = (sharding.dp, sharding.sp, sharding.ep, sharding.tp, sharding.dcn_dp, world)
    grid = _GRIDS.get(key)
    if grid is None:
        grid = _GRIDS[key] = ParallelGroups(sharding)
    return grid


def shard_params(params: Dict[str, Any], groups: ParallelGroups,
                 cfg: ModelConfig) -> Dict[str, Any]:
    """This rank's tp (and ep) shard of ``params`` (:func:`shard_tree`);
    the whole tree where tp and ep are 1."""
    sh = groups.sharding
    if sh.tp == 1 and sh.ep == 1:
        return params
    return shard_tree(params, cfg, sh.tp, groups.tp_rank, sh.ep, groups.ep_rank)


def gather_vocab(tp: Optional[StagedGroup], logits: torch.Tensor) -> torch.Tensor:
    """Logits over the whole vocabulary from each tp rank's columns
    ``[..., V / tp]`` (identity without tp)."""
    if tp is None:
        return logits
    every = tp.all_gather(logits)                      # [tp, ..., V / tp]
    return torch.cat(every.unbind(0), dim=-1)

