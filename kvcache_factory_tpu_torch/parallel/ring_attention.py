"""Ring attention: causal self-attention over a sequence split across the
ranks of a :class:`~.mesh.SequenceParallelGroup` (port of
``kvcache_factory_tpu/parallel/ring_attention.py``, its kernel fold
``_ring_kernel_fold`` :162-235).

Each rank holds one shard of q/k/v rows.  K/V shards move one rank along
the ring ``n - 1`` times; at every hop a rank runs K1-ml
(``flash_prefill_attention(..., return_ml=True)``) on its q shard against
the shard it holds, which gives that hop's local attention and each row's
``(m, l)``, and folds it into fp32 running stats with
:func:`ring_hop_fold`.  Hops with no visible column (a later shard, or one
wholly below every local row's sliding window) are skipped.  On the CPU the
hops run K1-ml's plain version; on the card the kernel.

Every shard that passes through is kept: after the ``n - 1`` hops a rank
has held all ``n``, which is the global K/V that prefill compression needs,
so no second gather is made (the JAX package lets GSPMD gather it,
``models/llama.py:330-332``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.attention import NEG_INF
from ..ops.kernels import flash_prefill
from .mesh import SequenceParallelGroup

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # m, l [B, Hq, S_loc]; acc [.., D]


def ring_hop_fold(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                  out_h: torch.Tensor, m_h: torch.Tensor, l_h: torch.Tensor) -> State:
    """Exact online-softmax combine of the running ``(m, l, acc)`` with one
    hop's normalized output and ``(m_h, l_h)`` (JAX ``:196-201``).  A row
    that saw no column in the hop (``m_h = NEG_INF``) gets weight
    ``exp(NEG_INF - m_new) = 0`` once any hop saw a column."""
    m_new = torch.maximum(m, m_h)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_h - m_new)
    acc = acc * alpha[..., None] + out_h.float() * (l_h * beta)[..., None]
    return m_new, l * alpha + l_h * beta, acc


def hop_visible(my: int, src: int, S_loc: int, sliding_window: Optional[int]) -> bool:
    """Whether rank ``my``'s rows see any column of shard ``src`` (JAX
    ``:203-214``): causality hides later shards, and a window hides a shard
    whose last column lies at or below the lowest local row's window."""
    if src > my:
        return False
    return sliding_window is None or src * S_loc + S_loc - 1 > my * S_loc - sliding_window


def _init_state(q: torch.Tensor) -> State:
    B, Hq, S_loc, D = q.shape
    return (torch.full((B, Hq, S_loc), NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros((B, Hq, S_loc), dtype=torch.float32, device=q.device),
            torch.zeros((B, Hq, S_loc, D), dtype=torch.float32, device=q.device))


def _fold_hop(state: State, q, k_blk, v_blk, true_len, my: int, src: int,
              sliding_window: Optional[int]) -> State:
    """Rank ``my``'s hop over shard ``src`` (JAX ``:182-187``): local
    attention of its q rows, at global ids ``my * S_loc + r``, over the
    shard's columns, expressed as K1's chunk mode with ``row_offset = (my -
    src) * S_loc`` and the valid length shifted by ``src * S_loc``."""
    S_loc = q.shape[2]
    if not hop_visible(my, src, S_loc, sliding_window):
        return state
    out_h, _, m_h, l_h = flash_prefill.flash_prefill_attention(
        q, k_blk, v_blk, true_len - src * S_loc, 0, sliding_window=sliding_window,
        row_offset=(my - src) * S_loc, return_ml=True)
    return ring_hop_fold(*state, out_h, m_h, l_h)


def _finish(state: State, dtype: torch.dtype) -> torch.Tensor:
    _, l, acc = state
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).to(dtype)


def ring_attention(
    q: torch.Tensor,         # [B, Hq, S_loc, D]: this rank's rows
    k: torch.Tensor,         # [B, Hkv, S_loc, D]
    v: torch.Tensor,         # [B, Hkv, S_loc, D]
    true_len: torch.Tensor,  # [B] int32, the global valid length
    group: SequenceParallelGroup,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal GQA attention of this rank's rows over the whole sequence.
    Returns ``(out [B, Hq, S_loc, D], k_all, v_all [B, Hkv, S, D])``, the
    last two being every rank's K/V shard in sequence order.  One rank is
    K1 itself, with no ``(m, l)`` (JAX ``:173-180``); otherwise ``n - 1``
    fold-then-shift hops and a last fold with no shift (``:216-232``)."""
    n, my = group.size, group.rank
    if n == 1:
        out, _ = flash_prefill.flash_prefill_attention(q, k, v, true_len, 0,
                                                       sliding_window=sliding_window)
        return out, k, v
    shards = [None] * n
    shards[my] = (k, v)
    state = _init_state(q)
    for i in range(n):
        src = (my - i) % n
        state = _fold_hop(state, q, *shards[src], true_len, my, src, sliding_window)
        if i < n - 1:
            shards[(src - 1) % n] = tuple(group.shift(shards[src]))
    return (_finish(state, q.dtype), torch.cat([s[0] for s in shards], dim=2),
            torch.cat([s[1] for s in shards], dim=2))


def ring_attention_emulated(
    q: torch.Tensor,         # [B, Hq, S, D]: the whole sequence
    k: torch.Tensor,         # [B, Hkv, S, D]
    v: torch.Tensor,
    true_len: torch.Tensor,  # [B] int32
    n: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Every rank of an ``n``-rank ring in one process: each rank's hops in
    its ring order and folds, as :func:`ring_attention` runs them; returns
    ``out [B, Hq, S, D]``.  The reference the ring over a process group is
    held to."""
    S = q.shape[2]
    if S % n:
        raise ValueError(f"{S} rows do not split over {n} ranks")
    S_loc = S // n
    rows = lambda t, r: t[:, :, r * S_loc:(r + 1) * S_loc].contiguous()
    if n == 1:
        return flash_prefill.flash_prefill_attention(q, k, v, true_len, 0,
                                                     sliding_window=sliding_window)[0]
    outs = []
    for my in range(n):
        q_my = rows(q, my)
        state = _init_state(q_my)
        for i in range(n):
            src = (my - i) % n
            state = _fold_hop(state, q_my, rows(k, src), rows(v, src), true_len, my, src,
                              sliding_window)
        outs.append(_finish(state, q.dtype))
    return torch.cat(outs, dim=2)
