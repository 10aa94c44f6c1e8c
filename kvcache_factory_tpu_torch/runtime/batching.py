"""Continuous batching: slot-based request scheduling over one batched cache
(port of ``kvcache_factory_tpu/runtime/batching.py``, single device).

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

Prefix caching (``cache_prefix``), the ``(dp, tp)`` mesh, and headkv, cam
and random (capacities and draws through admission) are not ported
(ROADMAP.md item 1.10).
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

    ``instrument`` records, for checks and measurements, each request's
    fp32 logits for every token it emitted (``logits[rid]``, entry 0 from
    its prefill) and the wall time of each loop iteration's prefill work,
    the stall it puts on running streams (``admission_stalls_s``); the
    device is synchronised around that work.  Off, the engine records
    neither and makes no extra synchronisation."""

    def __init__(self, params, cfg: EngineConfig, n_slots: int = 4,
                 max_new_cap: int = 256, eos_token_ids: Sequence[int] = (),
                 chunk_size: int = 16, prefill_chunk_tokens: int = 0,
                 device="cuda", instrument: bool = False):
        llama._check_supported(cfg.model, cfg.compression, cfg.quant)
        if cfg.compression.method in ("headkv", "cam", "random"):
            raise NotImplementedError(
                f"{cfg.compression.method!r} in the batching engine (head capacities and "
                "draws through admission) is not ported yet (ROADMAP.md item 1.10)")
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the engine "
                             f"runs on {self.device}")
        self.params = params
        self.cfg = cfg
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
        # Pending chunked admissions pool per bucket: one [P]-row chunk state
        # advances every pending prompt of a bucket in one chunk_step call
        # (per-row offsets).  Pools start at one row, double on demand and
        # halve when their live rows fit in half (inert rows still run every
        # layer's products).
        self._chunk_groups: Dict[int, dict] = {}
        self.prefill_chunks_executed = 0   # row-chunks advanced
        self.prefill_chunk_dispatches = 0  # chunk_step calls issued
        self.steps_executed = 0            # decode steps run (EOS- and budget-aware)
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

    def cache_prefix(self, prefix_ids: Sequence[int]) -> None:
        raise NotImplementedError("prefix caching is not ported yet (ROADMAP.md item 1.10: "
                                  "prefix snapshots of chunked admission)")

    # --- admission -----------------------------------------------------------

    def _prefill_row(self, prompt: List[int], bucket: int):
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :len(prompt)] = torch.tensor(prompt)
        res = llama.prefill(self.params, self.cfg.model, self.cfg.compression,
                            toks.to(self.device),
                            torch.tensor([len(prompt)], dtype=torch.int32, device=self.device),
                            self.cache_capacity, quant=self.cfg.quant)
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
            fresh = init_chunked_state(self.cfg.model, self.cfg.compression, newP,
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
        """Claim a pool row for a newly admitted prompt."""
        g = self._chunk_group(bucket)
        r = g["free"].pop()
        prompt = self._prompts[rid]
        g["toks"][r] = 0
        g["toks"][r, :len(prompt)] = prompt
        g["tl"][r] = len(prompt)
        g["c0"][r] = 0
        g["rows"][r] = {"rid": rid, "slot": slot, "n": len(prompt)}

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
        model, comp = self.cfg.model, self.cfg.compression
        Sc = self.prefill_chunk_tokens
        done = []
        for g in self._chunk_groups.values():
            if not g["rows"]:
                continue
            while g["P"] > 1 and len(g["rows"]) <= g["P"] // 2:
                self._shrink_chunk_group(g)
            toks_c = np.zeros((g["P"], Sc), np.int64)
            for r in g["rows"]:
                toks_c[r] = g["toks"][r, g["c0"][r]:g["c0"][r] + Sc]
            chunk_step(self.params, model, torch.tensor(toks_c, device=self.device),
                       g["c0"], g["tl"], g["state"])
            self.prefill_chunk_dispatches += 1
            for r in list(g["rows"]):
                meta = g["rows"][r]
                g["c0"][r] += Sc
                self.prefill_chunks_executed += 1
                if g["c0"][r] >= meta["n"]:
                    res = finalize(self.params, model, comp, _pool_row(g["state"], r),
                                   [meta["n"]], self.cache_capacity, quant=self.cfg.quant)
                    done.append((meta["slot"], meta["rid"], res.cache, res.logits_last))
                    g["rows"].pop(r)
                    g["free"].append(r)
                    g["tl"][r] = 0
                    g["c0"][r] = 0
        return done

    def _chunked_pending(self) -> int:
        return sum(len(g["rows"]) for g in self._chunk_groups.values())

    # --- decode ----------------------------------------------------------------

    def _decode_chunk(self, cur: np.ndarray, cache: llama.Cache, active: np.ndarray,
                      budget: np.ndarray):
        """Up to ``chunk_size`` greedy steps over every slot.  A row freezes
        when its token is an EOS or when it has produced ``budget`` tokens;
        the chunk ends when every row is frozen.  Returns the tokens
        ``[n, n_slots]`` (a frozen row repeats its last token), the logits
        ``[n, n_slots, V]`` when instrumented, and ``n``."""
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
            logits, _ = llama.decode_step(self.params, self.cfg.model, tok, cache, quant=quant,
                                          eviction_recent=evr)
            cache.lengths.copy_(torch.where(act[None, :, None], cache.lengths, lens0))
            cache.positions.copy_(torch.where(act, cache.positions, pos0))
            tok = torch.where(act, logits.argmax(-1), tok)
            toks.append(tok)
            if self.instrument:
                logits_all.append(logits)
            act = act & ~torch.isin(tok, eos) & (left > k + 1)
        out = torch.stack(toks).cpu().numpy()
        return out, torch.stack(logits_all).cpu() if logits_all else None, len(toks)

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

        def activate(slot, rid, row_cache, first, logits):
            nonlocal batched
            if batched is None:
                batched = _alloc_pool(row_cache, self.n_slots)
            _insert_row(batched, row_cache, slot)
            outputs[rid] = [first]
            if self.instrument:
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
            # Admit as many queued requests as there are free slots.
            while (adm := self.scheduler.admit()) is not None:
                slot, rid, bucket, _ = adm
                prefilled = True
                if self.prefill_chunk_tokens:
                    self._admit_chunked(slot, rid, bucket)
                    continue
                row_cache, logits = self._prefill_row(self._prompts[rid], bucket)
                activate(slot, rid, row_cache, int(logits[0].argmax()), logits)

            # Advance every pending chunked prefill by one chunk; the first
            # tokens of the rows that finish come back in one transfer.
            if self._chunked_pending():
                prefilled = True
                done = self._advance_chunked_groups()
                if done:
                    firsts = torch.cat([lg for *_, lg in done]).argmax(-1).tolist()
                    for (slot, rid, row_cache, lg), first in zip(done, firsts):
                        activate(slot, rid, row_cache, first, lg)
            if self.instrument and prefilled:
                self._sync()
                self.admission_stalls_s.append(time.perf_counter() - t0)

            if not active.any():
                st = self.scheduler.stats()
                if st["queued"] == 0 and st["active"] == 0 and not self._chunked_pending():
                    break
                continue

            budget = np.zeros((self.n_slots,), np.int64)
            for slot in np.nonzero(active)[0]:
                rid = slot_rid[slot]
                budget[slot] = self._max_new[rid] - len(outputs[rid])
            toks, logits, n = self._decode_chunk(cur, batched, active, budget)
            self.steps_executed += n
            for k in range(n):
                for slot in range(self.n_slots):
                    if not active[slot]:
                        continue
                    tok = int(toks[k, slot])
                    rid = slot_rid[slot]
                    outputs[rid].append(tok)
                    if self.instrument:
                        self.logits[rid].append(logits[k, slot])
                    if self.scheduler.step(slot, tok in self.eos):
                        active[slot] = False
                        slot_rid[slot] = -1
            cur = toks[n - 1].copy()

        self.cache = batched
        return outputs
