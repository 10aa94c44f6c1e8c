"""Continuous batching: slot-based request scheduling over one batched cache
(port of ``kvcache_factory_tpu/runtime/batching.py``, on one device or on
a ``(dp, tp)`` or ``(dp, ep, tp)`` grid of ranks).

A fixed pool of decode slots shares one batched cache ``[L, n_slots, H, C,
D]``; finished slots are refilled from the request queue while the other
streams go on:

    submit -> scheduler FIFO (runtime/native.py) -> admit into a free slot
      -> prefill the row: one-shot, or chunked admission (one chunk per loop
         iteration, the pending prompts of a bucket pooled in one dispatch)
      -> insert the row into the batched cache
      -> decode chunk: up to ``chunk_size`` greedy steps over all slots
      -> EOS or the token budget frees the slot at the chunk's end

Every cache the engine builds (dense, per-token or grouped quantized, the
latter with its ``None`` planes, evicting, ThinK packed) keeps
``positions`` as ``[B]`` and every other tensor as ``[L, B, ...]``, so slot
insertion and pool allocation are generic.

Where torch is not JAX (state is updated in place):

- ``decode_step`` advances the cache's ``lengths`` and ``positions`` in
  place, so the decode chunk saves both before each step and restores them
  for frozen rows: their garbage appends stay invisible, as in the JAX
  engine, and are overwritten by the next real append or admission.
- A row freezes at EOS, as in JAX, and also once it has produced its token
  budget, which the host knows when the chunk starts (JAX runs such rows
  to the chunk's end and drops their tokens).  Token streams are the same;
  a row's cache ends at its prompt's entries plus ``max_new - 1``, and the
  last chunk of a drain runs only the steps some row still needs.  Without
  EOS ids the chunk needs no device-to-host read per step.
- Chunk pools are written in place by ``chunk_step``.  A finished row is
  finalized from a view of its pool row before anything is enqueued that
  could reuse it (one stream orders the two), and its cache is a fresh
  tensor.  Pools that shrink gather into fresh tensors.
- The host arrays of chunk offsets, lengths and tokens are turned into
  fresh device tensors at each dispatch, so changing them afterwards
  cannot reach a copy in flight.
- Prefix snapshots (``cache_prefix``) are copies of a pool row taken at
  the prefix's chunk boundary, and a resumed admission copies the
  snapshot into its own pool row: ``chunk_step`` writes the pool in place,
  so an alias would let a resumed prompt's chunks overwrite the snapshot.
- cam's and random's ``torch.Generator`` is restored to its state at
  construction before every admission's prefill or finalize, as JAX's
  engine hands one key to every call.

Under ``cfg.sharding`` ``(dp, tp)`` or ``(dp, ep, tp)`` (JAX
``:144-153, 207-217``) the engine runs on each rank of a
``torch.distributed`` group of ``dp * ep * tp`` ranks
(``parallel/mesh.py::ParallelGroups``), every rank submitting the same
requests.  Slots shard over dp: dp rank ``d`` holds slots ``[d * n /
dp, (d + 1) * n / dp)`` of ``n`` and computes only their rows (their
prefills, chunk pools and cache rows); heads shard over tp, each tp rank
holding its shard of the weights and of the cache; each ep rank holds its
experts and every head (one-shot admission only: chunked admission under
ep raises JAX's ``ValueError``).  Every rank runs the
same scheduler.  After each loop iteration's admission work and after
each decode chunk the dp ranks gather the first tokens of the slots they
activated, their pending chunked admissions and every slot's tokens, so
that the replicated schedulers agree on what each slot emitted and which
slot finished.  Under dp a slot's activation waits for that gather: the
slots prefilled in one iteration activate together, in admission order,
after its admission loop.  sp and pp are not served here, as JAX's
batching engine has no path for either.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import EngineConfig
from ..models import llama
from ..models.chunked_prefill import (ChunkState, _check_supported, chunk_step, finalize,
                                      init_chunked_state)
from ..policies.methods import HeadShard
from .engine import head_rows, rank_grid, rank_params
from .native import make_scheduler


def _insert_row(batched: llama.Cache, row: llama.Cache, slot: int) -> None:
    """Copy a one-row cache into batch position ``slot``, in place."""
    for buf, r in zip(batched, row):
        if buf is None:
            continue
        if buf.dim() == 1:
            buf[slot] = r[0]
        else:
            buf[:, slot] = r[:, 0]


def _alloc_pool(row: llama.Cache, n_slots: int) -> llama.Cache:
    """A zero-filled ``n_slots``-row cache shaped like a prefilled row (every
    bucket shares one capacity, so every row has the same shapes)."""
    def z(r):
        shape = (n_slots,) if r.dim() == 1 else (r.shape[0], n_slots) + r.shape[2:]
        return torch.zeros(shape, dtype=r.dtype, device=r.device)

    return type(row)(*(None if r is None else z(r) for r in row))


# --- chunk-pool row plumbing (chunked admission) ---------------------------
# A chunk state is (kbuf, vbuf, qwin, x_last): the batch axis is 1 for the
# three [L, B, ...] buffers and 0 for x_last [B, hidden].


def _pool_row(state: ChunkState, r: int) -> ChunkState:
    """Row ``r`` of a pool as a one-row state: views, no copy."""
    kb, vb, qw, xl = state
    return kb[:, r:r + 1], vb[:, r:r + 1], qw[:, r:r + 1], xl[r:r + 1]


def _pool_take(state: ChunkState, rows: Sequence[int]) -> ChunkState:
    """The given rows of a pool, gathered into fresh tensors."""
    kb, vb, qw, xl = state
    idx = torch.tensor(list(rows), dtype=torch.int64, device=kb.device)
    return (kb.index_select(1, idx), vb.index_select(1, idx), qw.index_select(1, idx),
            xl.index_select(0, idx))


def _pool_graft(new: ChunkState, old: ChunkState) -> None:
    """Copy a smaller pool into rows ``[0, P_old)`` of a grown one."""
    for n, o in zip(new[:3], old[:3]):
        n[:, :o.shape[1]] = o
    new[3][:old[3].shape[0]] = old[3]


class ContinuousBatchingEngine:
    """Drains a request queue through a fixed-slot batched decode loop, on
    ``device`` ("cuda" unless the caller asks for the CPU).

    ``head_capacity`` is headkv's ``[L, H]`` budgets, required with headkv
    (``ValueError`` otherwise, as JAX's engine); ``rng`` the generator cam
    and random draw from, on ``device``, seeded 0 by default.

    ``prefix_cache_bytes`` bounds the device bytes that prefix snapshots
    (:meth:`cache_prefix`) hold; the oldest-used snapshot goes first, and
    one alone over the budget is never kept.

    ``instrument`` records, for checks and measurements, each request's
    fp32 logits for every token it emitted (``logits[rid]``, entry 0 from
    its prefill) and the wall time of each loop iteration's prefill work,
    the stall it puts on running streams (``admission_stalls_s``); the
    device is synchronised around that work.  Off, the engine records
    neither and makes no extra synchronisation.  Under dp a rank records
    the logits of the requests its slots served.

    Under a ``(dp, tp)`` or ``(dp, ep, tp)`` layout the engine runs on
    each rank of the default ``torch.distributed`` group; it shards full
    ``params`` or takes the rank's shard, as ``InferenceEngine`` does, and
    ``self.cache`` is then this rank's slots and heads."""

    def __init__(self, params, cfg: EngineConfig, n_slots: int = 4,
                 max_new_cap: int = 256, eos_token_ids: Sequence[int] = (),
                 head_capacity=None, rng: Optional[torch.Generator] = None,
                 chunk_size: int = 16, prefill_chunk_tokens: int = 0,
                 prefix_cache_bytes: int = 3 * 2**29,
                 device="cuda", instrument: bool = False):
        llama._check_supported(cfg.model, cfg.compression, cfg.quant)
        if cfg.compression.method == "headkv" and head_capacity is None:
            raise ValueError("headkv requires head_capacity (as in InferenceEngine)")
        sh = cfg.sharding
        if sh.sp > 1 or sh.pp > 1:
            raise ValueError("the batching engine serves dp, tp and ep; sp and pp run "
                             "through InferenceEngine (JAX's batching engine has neither)")
        if prefill_chunk_tokens and sh.ep > 1:
            raise ValueError("chunked admission (prefill_chunk_tokens) does not compose with "
                             "expert parallelism (ep); use one-shot admission under ep meshes")
        if n_slots % sh.dp:
            raise ValueError(f"n_slots={n_slots} must be divisible by dp={sh.dp} "
                             "(slots shard over dp)")
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        # This rank's grid, widths and slots [slot0, slot0 + n_local).
        self.groups, self.model_cfg = rank_grid(cfg)
        self.tp_group = self.dp_group = self.experts = None
        self.n_local, self.slot0 = n_slots // sh.dp, 0
        if self.groups is not None:
            self.tp_group, self.dp_group = self.groups.tp, self.groups.dp
            self.experts = self.groups.experts(cfg.model)
            self.slot0 = self.groups.dp_rank * self.n_local
        self.params = rank_params(params, cfg, self.groups)
        self.head_capacity = head_rows(head_capacity, cfg, self.groups, self.device)
        self.rng = rng if rng is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self._rng_state = self.rng.get_state()
        self.n_slots = n_slots
        self.max_new_cap = max_new_cap
        self.chunk_size = max(1, chunk_size)
        # Bounded-stall admission: prefill an admitted prompt in chunks of
        # this many tokens, one chunk per loop iteration, interleaved with
        # decode chunks.  0 = one-shot admission.
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.buckets = sorted(cfg.prefill_buckets)
        if prefill_chunk_tokens:
            _check_supported(cfg.compression)
            bad = [b for b in self.buckets if b % prefill_chunk_tokens]
            if bad:
                raise ValueError(f"prefill buckets {bad} not divisible by "
                                 f"prefill_chunk_tokens={prefill_chunk_tokens}")
        # Prefix caching: registered prefixes (a shared system prompt), and
        # snapshots of a pool row at a prefix's chunk boundary keyed by
        # (bucket, prefix tokens), oldest use first.
        self._prefixes: List[List[int]] = []
        self._prefix_states: Dict[tuple, ChunkState] = {}
        self._prefix_cache_bytes = int(prefix_cache_bytes)
        # Pending chunked admissions pool per bucket: one [P]-row chunk state
        # advances every pending prompt of a bucket in one chunk_step call
        # (per-row offsets).  Pools start at one row, double on demand and
        # halve when their live rows fit in half (inert rows still run every
        # layer's products).
        self._chunk_groups: Dict[int, dict] = {}
        self.prefill_chunks_executed = 0   # row-chunks advanced
        self.prefill_chunk_dispatches = 0  # chunk_step calls issued
        self.prefix_resumes = 0            # admissions resumed from a prefix snapshot
        self.steps_executed = 0            # decode steps this rank ran (EOS- and budget-aware)
        self.eos = tuple(eos_token_ids)
        self.scheduler = make_scheduler(n_slots, self.buckets)
        self._prompts: Dict[int, List[int]] = {}
        self._max_new: Dict[int, int] = {}
        self.instrument = instrument
        self.logits: Dict[int, List[torch.Tensor]] = {}
        self.admission_stalls_s: List[float] = []
        self.cache: Optional[llama.Cache] = None  # the batched cache after run()

        L = cfg.model.num_hidden_layers
        caps = [cfg.compression.layer_capacity(L, b) for b in self.buckets]
        self.cache_capacity = max(caps) + max_new_cap + 1
        if cfg.quant is not None:
            # The JAX engine's rounding for its TPU cache layouts; the port's
            # kernels need none, but both engines then build caches of the
            # same capacity.
            align = 256 if cfg.quant.nbits == 4 else 128
            self.cache_capacity = -(-self.cache_capacity // align) * align

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int) -> int:
        max_new_tokens = min(max_new_tokens, self.max_new_cap)
        rid = self.scheduler.submit(len(prompt_ids), max_new_tokens)
        if rid < 0:
            raise ValueError(f"prompt length {len(prompt_ids)} exceeds largest "
                             f"bucket {self.buckets[-1]}")
        self._prompts[rid] = list(prompt_ids)
        self._max_new[rid] = max_new_tokens
        return rid

    # --- prefix caching --------------------------------------------------------

    def cache_prefix(self, prefix_ids: Sequence[int]) -> None:
        """Register a shared prompt prefix (a system prompt).  The first
        admitted prompt that starts with it snapshots its chunked state at
        the prefix's chunk boundary; later admissions resume from the
        snapshot and skip the prefix's chunks.  Requires chunked admission
        (JAX ``batching.py:430-437``)."""
        if not self.prefill_chunk_tokens:
            raise ValueError("prefix caching requires prefill_chunk_tokens")
        self._prefixes.append(list(prefix_ids))

    def _prefix_resume_point(self, prompt: List[int]) -> int:
        """The largest registered prefix's chunk boundary this prompt can
        resume from (0: none), capped at ``true_len - max(window, 32)`` so
        that every query row the policies read is recomputed after the
        resume (JAX ``batching.py:439-452``)."""
        Sc = self.prefill_chunk_tokens
        wk = max(self.cfg.compression.window_size, 32)
        best = 0
        for pref in self._prefixes:
            c0 = min((len(pref) // Sc) * Sc, ((len(prompt) - wk) // Sc) * Sc)
            if c0 > best and prompt[:c0] == pref[:c0]:
                best = c0
        return best

    def _prefix_state_bytes(self) -> int:
        """Device bytes held by the live prefix snapshots."""
        return sum(t.numel() * t.element_size()
                   for st in self._prefix_states.values() for t in st)

    def _store_prefix_snapshot(self, key: tuple, state: ChunkState) -> None:
        self._prefix_states[key] = state
        while self._prefix_states and self._prefix_state_bytes() > self._prefix_cache_bytes:
            self._prefix_states.pop(next(iter(self._prefix_states)))

    # --- admission -----------------------------------------------------------

    def _fresh_rng(self) -> torch.Generator:
        """The generator at its state at construction (one per call)."""
        self.rng.set_state(self._rng_state)
        return self.rng

    def _row_shard(self) -> Optional[HeadShard]:
        """A one-row admission's tile under tp: its heads (one row, drawn
        and ranked as one device draws and ranks it)."""
        if self.tp_group is None:
            return None
        m = self.cfg.model
        return HeadShard(0, 1, self.groups.q_head_offset(m), m.num_attention_heads,
                         m.num_key_value_heads, self.tp_group.all_gather)

    def _mine(self, slot: int) -> bool:
        """Whether this dp rank holds ``slot``."""
        return self.slot0 <= slot < self.slot0 + self.n_local

    def _prefill_row(self, prompt: List[int], bucket: int):
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :len(prompt)] = torch.tensor(prompt)
        res = llama.prefill(self.params, self.model_cfg, self.cfg.compression,
                            toks.to(self.device),
                            torch.tensor([len(prompt)], dtype=torch.int32, device=self.device),
                            self.cache_capacity, quant=self.cfg.quant, rng=self._fresh_rng(),
                            head_capacity=self.head_capacity, tp=self.tp_group,
                            shard=self._row_shard(), ep=self.experts)
        return res.cache, res.logits_last

    def _chunk_group(self, bucket: int) -> dict:
        g = self._chunk_groups.get(bucket)
        if g is None:
            g = {"P": 0, "state": None, "toks": np.zeros((0, bucket), np.int64),
                 "tl": np.zeros((0,), np.int64), "c0": np.zeros((0,), np.int64),
                 "rows": {}, "free": []}
            self._chunk_groups[bucket] = g
        if not g["free"]:
            # grow the pool: double the rows, graft the existing state in
            newP = max(1, 2 * g["P"])
            fresh = init_chunked_state(self.model_cfg, self.cfg.compression, newP,
                                       bucket, self.device)
            if g["P"]:
                _pool_graft(fresh, g["state"])
            g["state"] = fresh
            pad = newP - g["P"]
            g["toks"] = np.concatenate([g["toks"], np.zeros((pad, bucket), np.int64)])
            g["tl"] = np.concatenate([g["tl"], np.zeros((pad,), np.int64)])
            g["c0"] = np.concatenate([g["c0"], np.zeros((pad,), np.int64)])
            g["free"].extend(range(g["P"], newP))
            g["P"] = newP
        return g

    def _admit_chunked(self, slot: int, rid: int, bucket: int) -> None:
        """Claim a pool row for a newly admitted prompt; a prompt whose
        registered prefix has a snapshot resumes after it, the snapshot
        copied into the row."""
        g = self._chunk_group(bucket)
        r = g["free"].pop()
        prompt = self._prompts[rid]
        g["toks"][r] = 0
        g["toks"][r, :len(prompt)] = prompt
        g["tl"][r] = len(prompt)
        c0 = 0
        snap_at = self._prefix_resume_point(prompt)
        if snap_at:
            key = (bucket, tuple(prompt[:snap_at]))
            hit = self._prefix_states.pop(key, None)
            if hit is not None:
                self._prefix_states[key] = hit  # most recently used
                for buf, one in zip(_pool_row(g["state"], r), hit):
                    buf.copy_(one)
                c0, snap_at = snap_at, 0  # resumed: nothing left to record
                self.prefix_resumes += 1
        g["c0"][r] = c0
        g["rows"][r] = {"rid": rid, "slot": slot, "n": len(prompt), "snap_at": snap_at,
                        "prompt": prompt}

    def _shrink_chunk_group(self, g: dict) -> None:
        """Halve a pool whose live rows fit in half of it, compacting them to
        the front: a dispatch costs the pool's whole size, so after a burst
        a grown pool would tax every later admission of its bucket."""
        newP = g["P"] // 2
        live = sorted(g["rows"])
        g["state"] = _pool_take(g["state"], live + [0] * (newP - len(live)))
        toks = np.zeros((newP, g["toks"].shape[1]), np.int64)
        tl = np.zeros((newP,), np.int64)
        c0 = np.zeros((newP,), np.int64)
        rows = {}
        for j, r in enumerate(live):
            toks[j], tl[j], c0[j] = g["toks"][r], g["tl"][r], g["c0"][r]
            rows[j] = g["rows"][r]
        g["toks"], g["tl"], g["c0"], g["rows"] = toks, tl, c0, rows
        g["free"] = list(range(len(live), newP))
        g["P"] = newP

    def _advance_chunked_groups(self) -> List[Tuple[int, int, llama.Cache, torch.Tensor]]:
        """Advance every pending admission by one chunk: one chunk_step per
        bucket pool, however many rows are pending.  Returns the finished
        rows as (slot, rid, cache, logits of the first token)."""
        model, comp = self.model_cfg, self.cfg.compression
        Sc = self.prefill_chunk_tokens
        done = []
        for bucket, g in self._chunk_groups.items():
            if not g["rows"]:
                continue
            while g["P"] > 1 and len(g["rows"]) <= g["P"] // 2:
                self._shrink_chunk_group(g)
            toks_c = np.zeros((g["P"], Sc), np.int64)
            for r in g["rows"]:
                toks_c[r] = g["toks"][r, g["c0"][r]:g["c0"][r] + Sc]
            chunk_step(self.params, model, torch.tensor(toks_c, device=self.device),
                       g["c0"], g["tl"], g["state"], tp=self.tp_group)
            self.prefill_chunk_dispatches += 1
            for r in list(g["rows"]):
                meta = g["rows"][r]
                g["c0"][r] += Sc
                self.prefill_chunks_executed += 1
                if meta["snap_at"] and g["c0"][r] == meta["snap_at"]:
                    self._store_prefix_snapshot(
                        (bucket, tuple(meta["prompt"][:meta["snap_at"]])),
                        _pool_take(g["state"], [r]))
                if g["c0"][r] >= meta["n"]:
                    res = finalize(self.params, model, comp, _pool_row(g["state"], r),
                                   [meta["n"]], self.cache_capacity, quant=self.cfg.quant,
                                   rng=self._fresh_rng(), head_capacity=self.head_capacity,
                                   tp=self.tp_group, shard=self._row_shard())
                    done.append((meta["slot"], meta["rid"], res.cache, res.logits_last))
                    g["rows"].pop(r)
                    g["free"].append(r)
                    g["tl"][r] = 0
                    g["c0"][r] = 0
        return done

    def _chunked_pending(self) -> int:
        return sum(len(g["rows"]) for g in self._chunk_groups.values())

    # --- decode ----------------------------------------------------------------

    def _decode_chunk(self, cur: np.ndarray, cache: Optional[llama.Cache], active: np.ndarray,
                      budget: np.ndarray):
        """Up to ``chunk_size`` greedy steps over every slot.  A row freezes
        when its token is an EOS or when it has produced ``budget`` tokens;
        the chunk ends when every row is frozen.  Returns the tokens
        ``[n, n_slots]`` (a frozen row repeats its last token), the logits
        ``[n, n_local, V]`` of this rank's slots when instrumented, and
        ``n``.  Under dp each rank steps its own slots (none when none of
        them is active) and the ranks gather every slot's tokens: ``n`` is
        the longest rank's count, a shorter rank's rows repeating their
        last token."""
        if self.dp_group is None:
            return self._decode_rows(cur, cache, active, budget)
        mine = slice(self.slot0, self.slot0 + self.n_local)
        toks = np.repeat(cur[None, mine], self.chunk_size, axis=0)
        logits, n = None, 0
        if active[mine].any():
            local, logits, n = self._decode_rows(cur[mine], cache, active[mine], budget[mine])
            toks[:n], toks[n:] = local, local[n - 1]
        sent = np.concatenate([toks.reshape(-1), [n]])
        every = self.dp_group.all_gather(torch.tensor(sent, device=self.device)).cpu().numpy()
        n = int(every[:, -1].max())
        toks = every[:, :-1].reshape(-1, self.chunk_size, self.n_local)    # [dp, chunk, n_local]
        return np.concatenate(list(toks), axis=1)[:n], logits, n

    def _decode_rows(self, cur: np.ndarray, cache: llama.Cache, active: np.ndarray,
                     budget: np.ndarray):
        """:meth:`_decode_chunk` over the slots of one cache."""
        dev = self.device
        quant = self.cfg.quant
        evr = self.cfg.compression.eviction_recent
        n_max = min(self.chunk_size, int(budget[active].max()))
        tok = torch.tensor(cur.tolist(), dtype=torch.int64, device=dev)
        act = torch.tensor(active.tolist(), device=dev)
        left = torch.tensor(budget.tolist(), device=dev)
        eos = torch.tensor(list(self.eos), dtype=torch.int64, device=dev)
        toks, logits_all = [], []
        for k in range(n_max):
            # Only an EOS can freeze every row before n_max: read back then.
            if self.eos and k and not bool(act.any()):
                break
            lens0, pos0 = cache.lengths.clone(), cache.positions.clone()
            logits, _ = llama.decode_step(self.params, self.model_cfg, tok, cache, quant=quant,
                                          eviction_recent=evr, tp=self.tp_group,
                                          ep=self.experts)
            cache.lengths.copy_(torch.where(act[None, :, None], cache.lengths, lens0))
            cache.positions.copy_(torch.where(act, cache.positions, pos0))
            tok = torch.where(act, logits.argmax(-1), tok)
            toks.append(tok)
            if self.instrument:
                logits_all.append(logits)
            act = act & ~torch.isin(tok, eos) & (left > k + 1)
        out = torch.stack(toks).cpu().numpy()
        self.steps_executed += len(toks)
        return out, torch.stack(logits_all).cpu() if logits_all else None, len(toks)

    def _gather_firsts(self, ready, pending: int) -> Tuple[Dict[int, int], int]:
        """The dp ranks' first tokens of the slots each prefilled this
        iteration (``ready``: slot, rid, row cache, logits), as ``{slot:
        token}``, and the sum of their ``pending`` chunked admissions."""
        sent = np.full((self.n_local + 1,), -1, np.int64)
        if ready:
            firsts = torch.cat([lg for *_, lg in ready]).argmax(-1).tolist()
            for (slot, *_), first in zip(ready, firsts):
                sent[slot - self.slot0] = first
        sent[-1] = pending
        every = self.dp_group.all_gather(torch.tensor(sent, device=self.device)).cpu().numpy()
        toks = every[:, :-1].reshape(-1)
        return ({int(s): int(toks[s]) for s in np.nonzero(toks >= 0)[0]},
                int(every[:, -1].sum()))

    # --- the loop --------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def run(self) -> Dict[int, List[int]]:
        """Blocking drain: returns {request_id: generated token ids}.  The
        batched cache is left in ``self.cache``."""
        batched = None  # allocated from the first prefilled row, so it is
                        # the configured cache type with no allocator per type
        outputs: Dict[int, List[int]] = {}
        slot_rid = [-1] * self.n_slots
        cur = np.zeros((self.n_slots,), np.int64)
        active = np.zeros((self.n_slots,), bool)

        admitted: Dict[int, int] = {}  # slot -> the request admitted to it last

        def activate(slot, rid, first, row_cache=None, logits=None):
            """Start ``slot``'s stream; ``row_cache`` and ``logits`` where
            this rank prefilled it."""
            nonlocal batched
            if row_cache is not None:
                if batched is None:
                    batched = _alloc_pool(row_cache, self.n_local)
                _insert_row(batched, row_cache, slot - self.slot0)
            outputs[rid] = [first]
            if self.instrument and logits is not None:
                self.logits[rid] = [logits[0].float().cpu()]
            slot_rid[slot] = rid
            cur[slot] = first
            active[slot] = True
            # The prefill token counts toward max_new; a first-token EOS
            # finishes at once (min_new_tokens=1 semantics).
            if self.scheduler.step(slot, first in self.eos):
                active[slot] = False
                slot_rid[slot] = -1

        while True:
            if self.instrument:
                self._sync()
                t0 = time.perf_counter()
            prefilled = False
            ready = []  # (slot, rid, row cache, logits): prefilled, held for the dp gather
            # Admit as many queued requests as there are free slots.
            while (adm := self.scheduler.admit()) is not None:
                slot, rid, bucket, _ = adm
                admitted[slot] = rid
                if not self._mine(slot):
                    continue
                prefilled = True
                if self.prefill_chunk_tokens:
                    self._admit_chunked(slot, rid, bucket)
                    continue
                row_cache, logits = self._prefill_row(self._prompts[rid], bucket)
                if self.dp_group is None:
                    activate(slot, rid, int(logits[0].argmax()), row_cache, logits)
                else:
                    ready.append((slot, rid, row_cache, logits))

            # Advance every pending chunked prefill by one chunk; the first
            # tokens of the rows that finish come back in one transfer.
            if self._chunked_pending():
                prefilled = True
                done = self._advance_chunked_groups()
                if self.dp_group is not None:
                    ready += done
                elif done:
                    firsts = torch.cat([lg for *_, lg in done]).argmax(-1).tolist()
                    for (slot, rid, row_cache, lg), first in zip(done, firsts):
                        activate(slot, rid, first, row_cache, lg)
            pending = self._chunked_pending()
            if self.dp_group is not None:
                firsts, pending = self._gather_firsts(ready, pending)
                local = {slot: (row_cache, lg) for slot, _, row_cache, lg in ready}
                for slot in sorted(firsts, key=admitted.get):
                    activate(slot, admitted[slot], firsts[slot], *local.get(slot, (None, None)))
            if self.instrument and prefilled:
                self._sync()
                self.admission_stalls_s.append(time.perf_counter() - t0)

            if not active.any():
                st = self.scheduler.stats()
                if st["queued"] == 0 and st["active"] == 0 and not pending:
                    break
                continue

            budget = np.zeros((self.n_slots,), np.int64)
            for slot in np.nonzero(active)[0]:
                rid = slot_rid[slot]
                budget[slot] = self._max_new[rid] - len(outputs[rid])
            toks, logits, n = self._decode_chunk(cur, batched, active, budget)
            for k in range(n):
                for slot in range(self.n_slots):
                    if not active[slot]:
                        continue
                    tok = int(toks[k, slot])
                    rid = slot_rid[slot]
                    outputs[rid].append(tok)
                    if self.instrument and self._mine(slot):
                        self.logits[rid].append(logits[k, slot - self.slot0])
                    if self.scheduler.step(slot, tok in self.eos):
                        active[slot] = False
                        slot_rid[slot] = -1
            cur = toks[n - 1].copy()

        self.cache = batched
        return outputs
