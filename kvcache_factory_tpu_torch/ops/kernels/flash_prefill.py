"""K1: causal flash prefill attention that also emits the SnapKV window
scores, with its sliding-window, chunk (``row_offset``) and MInference
sparse (a-shape, vertical-slash) variants, and its ``return_ml`` variant
(K1-ml), which also returns each row's online-softmax ``(m, l)`` for the
ring-attention fold (``parallel/ring_attention.py``).

The CUDA kernel (``csrc/flash_prefill.cu``) replaces the Pallas TPU kernel
``kvcache_factory_tpu/ops/kernels/flash_prefill.py::_flash_kernel`` (dense
causal path with score emission, ``sliding_window``, chunk mode, the
sparse block patterns and ``return_ml``).  It is a Hopper kernel: one CTA
of three warpgroups per 128 q rows of one head, a producer that loads Q
once and 128-key K/V tiles (64-key at head_dim 256) through a 2-stage TMA
ring, and two consumers of 64 rows each that run both products with
``wgmma`` and mask only the tiles on an edge (above head_dim 256, 64 q rows a
CTA whose two consumers split the output's columns).  It takes any even
head_dim (:func:`takes_head_dim`): up to 512 each on the narrowest of the
instantiations ``INSTANCES`` at least as wide (:func:`instance`), above 512
on the kernels of ``csrc/flash_prefill_wide.cu``, whose shared memory does
not grow with D: O's columns split over :func:`slices` CTAs of ``SLICE``
columns, up to 2048 one thread-block cluster of them per 64 q rows that
computes each score once (:func:`cluster_size`), above 2048 CTAs that each
recompute the scores over D (:func:`entry`), each with the true head_dim's
``1/sqrt(D)``, and any observation window.  A bf16
row of a head_dim that is no multiple of 8 is no whole number of 16-byte
pieces, and TMA takes no such row stride: those head_dims run the library built
with the producer warpgroup copying 8- or 4-byte pieces by ``cp.async``
into the same swizzled stages (:func:`copy_bytes`, :func:`library`).
With a window, both builds then run the window-score pass of
``csrc/window_scores.cuh`` (``SCORE_SOURCE``): one tensor-core kernel for
every head_dim, a CTA per 64-key tile and KV head computing the scores of
all the group's query heads from the main pass's ``(m, l)``, reading each
K tile once.  Its plain version is :func:`window_scores_reference`.  The
sources' headers say what bounds each kernel on the card and how the
design answers that.  The vertical-slash block mask is estimated in
plain torch (:func:`vertical_slash_block_mask`), as the JAX
package estimates it in XLA; both patterns reach the kernel as one
``[B, Hq, n_blk, n_blk]`` block mask.

Dispatch is one rule: a CPU tensor goes to the plain version
(:func:`flash_prefill_attention_reference`); a CUDA tensor goes to the
kernel, or raises.  ``flash_prefill_attention.launches`` counts kernel
launches (the main pass), ``flash_prefill_attention.score_launches`` the
window-score pass's (one a launch with ``window > 0``), and
``flash_prefill_attention.variant_launches`` splits the first by variant: ``"dense"``, ``"sliding_window"`` (whole-sequence queries under a
window), ``"chunk"`` (``row_offset`` given, with or without a window),
``"ashape"`` and ``"vertical_slash"`` (a sparse pattern, with or without a
window) and ``"ring"`` (``return_ml``, with or without an offset or a
window).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..attention import NEG_INF
from . import _build

SOURCE = "kvcache_factory_tpu_torch/csrc/flash_prefill.cu"
WIDE_SOURCE = "kvcache_factory_tpu_torch/csrc/flash_prefill_wide.cu"
REPLACES = "kvcache_factory_tpu/ops/kernels/flash_prefill.py:66"
# The window-score pass: its source, kernel name and the TPU kernel's lines.
SCORE_SOURCE = "kvcache_factory_tpu_torch/csrc/window_scores.cuh"
SCORE_KERNEL = "window_scores_tc_kernel"
REPLACES_SCORES = "kvcache_factory_tpu/ops/kernels/flash_prefill.py:299-344"
# The TPU kernel's lines for each variant (its mask, tile bounds and entry).
REPLACES_VARIANT = {
    "sliding_window": "kvcache_factory_tpu/ops/kernels/flash_prefill.py:113-129",
    "chunk": "kvcache_factory_tpu/ops/kernels/flash_prefill.py:103-112",
    "ashape": "kvcache_factory_tpu/ops/kernels/flash_prefill.py:230-252",
    "vertical_slash": "kvcache_factory_tpu/ops/kernels/flash_prefill.py:228-252",
    "ring": "kvcache_factory_tpu/ops/kernels/flash_prefill.py:288-297",
}
# The kernels' instantiation widths: a head_dim up to 512 runs on the
# narrowest at least as wide (K1 and K2; K3 and K4 take exactly 128, 256, 384
# and 512); a wider one on the wide kernels, in column slices of SLICE.
INSTANCES = (64, 128, 256, 384, 512)
SLICE = 256
# Above 512 the slices of a q tile (K1) or of a query block's split (K3) run
# as one thread-block cluster of at most CLUSTER_MAX CTAs (the portable
# cluster size): head_dims up to 2048.  Wider ones run kernels whose slice
# CTAs share no work (:func:`cluster_size`).  The one rule for K1 and K3:
# csrc/flash_prefill_wide.cu and csrc/decode_attn_quant_cluster.cu size
# their shared memory by a CLUSTER_MAX equal to this one (a test holds them
# to it) and refuse a wider cluster.
CLUSTER_MAX = 8
# What the card refuses, and why.
REFUSED = ("odd head_dims are not served: RoPE splits a head in halves, in both packages, "
           "so neither runs one")
# A pattern block is a multiple of 64 (or the whole sequence): a CTA's 128 q
# rows are two consumer warpgroups of 64 (one set of 64 above head_dim 256)
# and a key tile (128 keys, 64 at head_dim 256, 32 above) one or two halves
# of 64 or part of one, so each warpgroup's rows and each half of a tile lie
# in one block.
PATTERN_QUANTUM = 64
DEFAULT_PATTERN_BLOCK = 1024  # JAX's q_block whenever a pattern is given

RowOffset = Union[None, int, torch.Tensor]


def flash_prefill_attention(
    q: torch.Tensor,         # [B, Hq, S_q, D]
    k: torch.Tensor,         # [B, Hkv, S_k, D]
    v: torch.Tensor,         # [B, Hkv, S_k, D]
    true_len: torch.Tensor,  # [B] int32
    window: int,
    sliding_window: Optional[int] = None,
    row_offset: RowOffset = None,  # int or [B] int32: global id of q row 0
    sparse_pattern: Optional[tuple] = None,
    sparse_head_budgets: Optional[torch.Tensor] = None,  # [Hq, 2] int32 (v, s)
    q_block: Optional[int] = None,
    return_ml: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Returns ``(out [B, Hq, S_q, D], scores [B, Hq, S_k] fp32)``; with
    ``return_ml`` also ``(m, l)``, fp32 ``[B, Hq, S_q]`` each: each row's
    final online-softmax max and sum over the columns it saw in this call
    (the logits scaled, the sum of ``exp(logit - m)``), so that
    ``out * l`` is its unnormalized accumulator.  A row that saw no column
    returns ``m = NEG_INF``, ``l = 0`` and a zero output.  (The JAX kernel
    returns ``l`` = the folded column count there; both weigh the row to
    zero in the ring fold.  Test ``m``, not ``l``, for an empty row.)

    Row ``r`` of example ``b`` has the global id ``R = row_offset[b] + r``
    (``R = r`` without ``row_offset``) and attends the columns
    ``c <= min(R, true_len[b]-1)``, and ``c > R - sliding_window`` under a
    window, with logits scaled by ``1/sqrt(D)``.  ``scores[b, h, c]`` is the
    sum over the observation-window rows ``[true_len - window, true_len)``
    of the final normalized probabilities; the caller masks the columns at
    or past ``true_len - window``.  ``window=0`` emits zeros.

    ``sparse_pattern`` (MInference) further restricts row ``r`` to the
    columns whose pattern block its own block selects, in blocks of
    ``min(q_block, S)`` rows and columns (``q_block`` 1024 by default):
    ``("ashape", sink, local, stride)`` or its bare three-tuple form, or
    ``("vertical_slash", v_topk, s_topk, last_q)`` with per-head budgets
    ``sparse_head_budgets`` (see :func:`sparse_block_mask`).  The window
    scores are then sums of that sparse softmax.

    The JAX wrapper's contract (``flash_prefill.py:489-507``): window scores
    need whole-sequence queries without a sliding window, so ``window`` is
    0 under ``sliding_window`` and in chunk mode; sparse patterns need
    whole-sequence queries; q and k lengths differ only in chunk mode;
    ``row_offset >= 0``; ``return_ml`` needs ``window=0`` and no sparse
    pattern (``:505-507``).  A ring hop passes one K/V shard, so
    ``true_len`` may exceed ``S_k``: columns stop at ``S_k - 1``.  Output
    rows at or past ``true_len`` are unspecified (never read by the
    model); a row whose ``true_len`` is 0 comes out finite (zeros from the
    kernel)."""
    _check_contract(q, k, window, sliding_window, row_offset, sparse_pattern, return_ml)
    block_mask, block = None, 0
    if sparse_pattern is not None:
        # Looked up as a module global at each call: chip_smoke.py swaps it
        # to record each mask or to hand the kernel a mask built beforehand.
        block_mask, block = sparse_block_mask(q, k, true_len, sparse_pattern,
                                              sparse_head_budgets, q_block)
    if q.device.type == "cpu":
        return flash_prefill_attention_reference(
            q, k, v, true_len, window, sliding_window=sliding_window,
            row_offset=row_offset, block_mask=block_mask, block=block,
            return_ml=return_ml)
    B, Hq, S_q, D = q.shape
    lib = _build.load(library(D))
    S_k = k.shape[2]
    dev = q.device
    if row_offset is not None and not (torch.is_tensor(row_offset)
                                       and row_offset.shape == (B,)):
        row_offset = torch.as_tensor(row_offset, dtype=torch.int32, device=dev) \
            .reshape(-1).expand(B).contiguous()
    _check(q, k, v, true_len, window, sliding_window, row_offset, block_mask, block)
    out = torch.empty_like(q)
    scores = (torch.empty if window else torch.zeros)(
        (B, Hq, S_k), dtype=torch.float32, device=dev)
    win_ml = torch.empty((B, Hq, max(window, 1), 2), dtype=torch.float32,
                         device=dev)
    row_ml = torch.empty((2, B, Hq, S_q), dtype=torch.float32, device=dev) \
        if return_ml else None
    # The wide kernel takes its slice count before the head_dim.
    shape = (() if D <= INSTANCES[-1] else (slices(D),)) + (D,)
    with torch.cuda.device(dev):
        code = getattr(lib, entry(D))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), true_len.data_ptr(),
            None if row_offset is None else row_offset.data_ptr(),
            None if block_mask is None else block_mask.data_ptr(),
            out.data_ptr(), win_ml.data_ptr(), scores.data_ptr(),
            None if row_ml is None else row_ml.data_ptr(),
            B, Hq, k.shape[1], S_q, S_k, window, sliding_window or 0,
            block, 0 if block_mask is None else block_mask.shape[-1], *shape, D ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "flash_prefill")
    flash_prefill_attention.launches += 1
    if window:
        flash_prefill_attention.score_launches += 1
    flash_prefill_attention.variant_launches[
        variant(sliding_window, row_offset, sparse_pattern, return_ml)] += 1
    if return_ml:
        return out, scores, row_ml[0], row_ml[1]
    return out, scores


flash_prefill_attention.launches = 0
flash_prefill_attention.score_launches = 0
flash_prefill_attention.variant_launches = {
    "dense": 0, "sliding_window": 0, "chunk": 0, "ashape": 0, "vertical_slash": 0,
    "ring": 0}


def takes_head_dim(D: int) -> bool:
    """Whether K1 and K2 take head_dim ``D`` on the card: any even one
    (RoPE splits a head in halves, so every head_dim either package runs is
    even)."""
    return D % 2 == 0 and D >= 2


def slices(D: int) -> int:
    """The column slices of ``SLICE`` columns that the wide kernels split
    O's ``D`` columns into, one CTA each (1 up to 512: the instantiations
    keep a whole row)."""
    return 1 if D <= INSTANCES[-1] else -(-D // SLICE)


def cluster_size(D: int) -> int:
    """CTAs of one cluster of the wide kernels at head_dim ``D``, the rule
    that picks K1's entry point (:func:`entry`) and K3's library
    (``decode_attn_quant.library``): its :func:`slices` from 513 to 2048,
    where one cluster computes each score (K3: each logit) once for all
    slices; 1 (no cluster) up to 512 and above 2048, where each slice CTA
    recomputes them."""
    n = slices(D)
    return n if D > INSTANCES[-1] and n <= CLUSTER_MAX else 1


def entry(D: int) -> str:
    """K1's entry point at head_dim ``D``: its instantiation's up to 512,
    the cluster kernel's up to 2048 and the slice-recomputing kernel's
    above (both in ``flash_prefill_wide``)."""
    if D <= INSTANCES[-1]:
        return f"kvcf_flash_prefill_d{instance(D)}"
    return "kvcf_flash_prefill_cluster" if cluster_size(D) > 1 else "kvcf_flash_prefill_wide"


def copy_bytes(D: int) -> int:
    """The widest copy a bf16 row of ``D`` elements is a whole number of:
    16 bytes at ``D % 8 == 0``, 8 at ``D % 4 == 0``, 4 otherwise.  K1's and
    K2's kernels read a row in pieces of this size, and their inputs must
    be aligned to it."""
    return 16 if D % 8 == 0 else 8 if D % 4 == 0 else 4


def library(D: int) -> str:
    """The kernel library K1 runs at head_dim ``D``: up to 512
    ``flash_prefill`` (TMA loads) for rows of 16-byte pieces, else
    ``flash_prefill_p8`` or ``_p4``, the same source built with the producer
    copying pieces of :func:`copy_bytes` by ``cp.async``; above 512
    ``flash_prefill_wide``, which picks its piece width from ``D`` itself."""
    if D > INSTANCES[-1]:
        return "flash_prefill_wide"
    width = copy_bytes(D)
    return "flash_prefill" if width == 16 else f"flash_prefill_p{width}"


def instance(D: int) -> int:
    """The instantiation a head_dim runs on: up to 512 the narrowest at
    least as wide (its columns past ``D`` are zero and never written), above
    512 ``D`` itself (the wide kernels' slices span D).  The logits keep
    ``D``'s own ``1/sqrt(D)``."""
    return next((w for w in INSTANCES if w >= D), D)


def pattern_kind(sparse_pattern: tuple) -> str:
    """``"vertical_slash"`` or ``"ashape"`` (the bare three-tuple form is an
    a-shape)."""
    if sparse_pattern[0] == "vertical_slash" and len(sparse_pattern) == 4:
        return "vertical_slash"
    if (sparse_pattern[0] == "ashape" and len(sparse_pattern) == 4) or (
            len(sparse_pattern) == 3 and not isinstance(sparse_pattern[0], str)):
        return "ashape"
    raise ValueError(f"flash_prefill: unknown sparse pattern {sparse_pattern!r}")


def variant(sliding_window: Optional[int], row_offset: RowOffset,
            sparse_pattern: Optional[tuple] = None, return_ml: bool = False) -> str:
    """Which of K1's variants a call runs."""
    if return_ml:
        return "ring"
    if row_offset is not None:
        return "chunk"
    if sparse_pattern is not None:
        return pattern_kind(sparse_pattern)
    return "dense" if sliding_window is None else "sliding_window"


def reset_launches() -> None:
    flash_prefill_attention.launches = 0
    flash_prefill_attention.score_launches = 0
    for key in flash_prefill_attention.variant_launches:
        flash_prefill_attention.variant_launches[key] = 0


def _check_contract(q, k, window, sliding_window, row_offset, sparse_pattern=None,
                    return_ml=False):
    """The JAX wrapper's asserts (``flash_prefill.py:495-507``), on every
    device."""
    if return_ml and (window or sparse_pattern is not None):
        raise ValueError("flash_prefill: (m, l) emission is a dense-attention feature "
                         "(the ring fold): pass window=0 and no sparse pattern")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError("flash_prefill: sliding_window must be >= 1")
    if window and (sliding_window is not None or row_offset is not None):
        raise ValueError("flash_prefill: window scores need the dense causal softmax "
                         "of whole-sequence queries; pass window=0 with a "
                         "sliding_window or a row_offset")
    if sparse_pattern is not None and row_offset is not None:
        raise ValueError("flash_prefill: chunk mode: sparse patterns need "
                         "whole-sequence queries")
    if row_offset is None and q.shape[2] != k.shape[2]:
        raise ValueError("flash_prefill: q and k lengths differ only in chunk mode "
                         f"(row_offset), got {q.shape[2]} and {k.shape[2]}")
    if row_offset is not None and not torch.is_tensor(row_offset) and row_offset < 0:
        raise ValueError("flash_prefill: row_offset must be >= 0")


def _check(q, k, v, true_len, window, sliding_window=None, row_offset=None,
           block_mask=None, block=0):
    # q, k and v are read in pieces of copy_bytes(D) (16 bytes by TMA, or
    # 8 / 4 by cp.async); the int32 vectors and the block mask one int at
    # a time.
    piece = copy_bytes(q.shape[-1])
    named = [("q", q, piece), ("k", k, piece), ("v", v, piece), ("true_len", true_len, 4)]
    if row_offset is not None:
        named.append(("row_offset", row_offset, 4))
    if block_mask is not None:
        named.append(("block_mask", block_mask, 4))
    for name, t, align in named:
        if t.device != q.device:
            raise ValueError(f"flash_prefill: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_prefill: {name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"flash_prefill: {name} must be {align}-byte aligned")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.dim() != 4:
            raise ValueError(f"flash_prefill: {name} must be a 4-d bfloat16 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    B, Hq, S_q, D = q.shape
    if not takes_head_dim(D):
        raise ValueError(f"flash_prefill: needs an even head_dim, got D={D}; {REFUSED}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or k.shape[2] < 1 \
            or Hq % k.shape[1]:
        raise ValueError(f"flash_prefill: k/v shape {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    for name, t in (("true_len", true_len), ("row_offset", row_offset)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (B,)):
            raise ValueError(f"flash_prefill: {name} must be int32 of shape [B]")
    if window < 0:
        raise ValueError(f"flash_prefill: window must be >= 0, got {window}")
    if block_mask is not None:
        n = -(-S_q // block)
        if block_mask.dtype != torch.int32 or block_mask.shape != (B, Hq, n, n):
            raise ValueError(f"flash_prefill: block_mask must be int32 of shape "
                             f"{(B, Hq, n, n)}")
        # A warpgroup's 64 q rows and a tile's 64-key half must each lie
        # inside one block.
        if n > 1 and block % PATTERN_QUANTUM:
            raise ValueError(f"flash_prefill: the pattern block ({block}) must be a "
                             f"multiple of {PATTERN_QUANTUM} on the card")
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")


# ---------------------------------------------------------------------------
# MInference block patterns
# ---------------------------------------------------------------------------


def sparse_block_mask(
    q: torch.Tensor, k: torch.Tensor, true_len: torch.Tensor, sparse_pattern: tuple,
    head_budgets: Optional[torch.Tensor] = None, q_block: Optional[int] = None,
) -> Tuple[torch.Tensor, int]:
    """The ``[B, Hq, n_blk, n_blk]`` int32 block mask of a sparse pattern
    and its block size ``min(q_block, S)`` (JAX ``flash_prefill.py:520-568``).
    Entry ``[b, h, i, j]`` says whether the rows of block ``i`` may attend
    the columns of block ``j``; causality and validity apply on top.

    A-shape (``("ashape", sink, local, stride)`` or ``(sink, local,
    stride)``): block ``j`` is kept for q block ``i`` when ``j < sink``,
    ``j > i - local`` or ``j % stride == 0`` (JAX ``:222-231``, where the
    diagonal block ``kv_hi - 1`` is the q block's own index).
    Vertical-slash: estimated per example from k padded with zero rows to
    a whole number of blocks, as JAX pads q and k; q is not padded, since
    the estimation reads only its rows below ``true_len``."""
    B, Hq, S, D = q.shape
    block = min(q_block or DEFAULT_PATTERN_BLOCK, S)
    n = -(-S // block)
    dev = q.device
    if pattern_kind(sparse_pattern) == "ashape":
        sink, local, stride = sparse_pattern[-3:]
        qb = torch.arange(n, device=dev)[:, None]
        kb = torch.arange(n, device=dev)[None, :]
        keep = (kb < sink) | (kb > qb - local) | (kb % stride == 0)
        return keep.to(torch.int32).expand(B, Hq, n, n).contiguous(), block
    _, v_topk, s_topk, last_q = sparse_pattern
    kp = F.pad(k, (0, 0, 0, n * block - S))
    tl = true_len.to(device=dev)
    masks = [vertical_slash_block_mask(q[b], kp[b], tl[b], block, block, v_topk,
                                       s_topk, last_q, head_budgets)
             for b in range(B)]
    return torch.stack(masks).contiguous(), block


def vertical_slash_block_mask(
    q: torch.Tensor,         # [Hq, S_q, D], S_q <= S_pad (padded or not)
    k: torch.Tensor,         # [Hkv, S_pad, D] (padded)
    true_len: torch.Tensor,  # 0-d int
    QB: int, KB: int, v_topk: int, s_topk: int, last_q: int,
    head_budgets: Optional[torch.Tensor] = None,  # [Hq, 2] int (v, s)
) -> torch.Tensor:
    """MInference vertical-slash pattern estimation (JAX
    ``flash_prefill.py:347-433``), plain torch: ``[Hq, n_qb, n_kb]`` int32.

    The last ``last_q`` queries' fp32 causal softmax over the valid columns
    gives each column's mass (vertical) and each diagonal's mass (slash,
    constant ``row - col``).  The top ``v_topk`` columns and ``s_topk``
    diagonals, ranked by a stable descending sort (lower index first on
    ties, as ``lax.top_k``), become blocks; each head keeps only its first
    ``head_budgets[h]`` ranks.  Sink and diagonal blocks are always kept.
    The ranks come from tensors on q's device: no value is read back to the
    host.  Rows at or past ``true_len`` give no mass, so q's rows past
    ``S_q`` (JAX's zero padding) are never needed."""
    Hq, S_q, D = q.shape
    Hkv, S = k.shape[:2]
    G = Hq // Hkv
    n_qb, n_kb = S // QB, S // KB
    dev = q.device
    if last_q > S:
        raise ValueError(f"vertical_slash: last_q {last_q} exceeds the padded "
                         f"length {S}")
    scale = 1.0 / float(D) ** 0.5
    tl = torch.as_tensor(true_len, device=dev).to(torch.int64).reshape(())
    start = (tl - last_q).clamp(min=0)
    rows = start + torch.arange(last_q, device=dev)              # [lq] global
    qw = q.index_select(1, rows.clamp(max=S_q - 1)).float().reshape(Hkv, G, last_q, D)
    logits = torch.einsum("hgqd,hkd->hgqk", qw, k.float()).reshape(Hq, last_q, S) * scale
    cols = torch.arange(S, device=dev)
    valid = (cols[None] <= rows[:, None]) & (cols[None] < tl) & (rows[:, None] < tl)
    A = torch.softmax(torch.where(valid[None], logits, NEG_INF), dim=-1)
    A = torch.where(valid[None], A, 0.0)

    # vertical: column sums of the estimation window
    vert = A.sum(dim=1)                                          # [Hq, S]
    nv = min(v_topk, S)
    vcols = torch.sort(vert, dim=-1, descending=True, stable=True).indices[:, :nv]
    v_keep = torch.ones((Hq, nv), dtype=torch.int32, device=dev)
    if head_budgets is not None:
        hb = head_budgets.to(device=dev, dtype=torch.int64)
        v_keep = (torch.arange(nv, device=dev)[None] < hb[:, 0:1]).to(torch.int32)
    vert_blk = torch.zeros((Hq, n_kb), dtype=torch.int32, device=dev) \
        .scatter_add_(1, vcols // KB, v_keep) > 0                # [Hq, n_kb]

    # slash: diagonal sums.  Row r of the column-reversed A, shifted right by
    # r, puts diagonal d = row - col at position p = (S - 1 - col) + r (JAX's
    # skew); a strided view of the rows padded with last_q zeros is that
    # shift without a copy per row.
    W = S + last_q
    padded = F.pad(A.flip(-1), (0, last_q))                      # [Hq, lq, W]
    skew = padded.as_strided((Hq, last_q, W), (last_q * W, W - 1, 1))
    diag_sum = skew.sum(dim=1)                                   # [Hq, W]
    ns = min(s_topk, S)
    spos = torch.sort(diag_sum, dim=-1, descending=True, stable=True).indices[:, :ns]
    sdist = spos + start - (S - 1)                               # d = row - col
    if head_budgets is not None:
        # ranks past a head's slash budget point at an impossible diagonal
        s_keep = torch.arange(ns, device=dev)[None] < hb[:, 1:2]
        sdist = torch.where(s_keep, sdist, S + last_q + 1)

    # q block i rows [i*QB, (i+1)*QB) meet kv block j cols [j*KB, (j+1)*KB)
    # along diagonal d iff diff - KB < d <= diff + QB - 1, diff = i*QB - j*KB.
    diff = (torch.arange(n_qb, device=dev)[:, None] * QB
            - torch.arange(n_kb, device=dev)[None, :] * KB)      # [n_qb, n_kb]
    d = sdist[:, None, None, :]
    hit = (d > (diff - KB)[None, ..., None]) & (d <= (diff + QB - 1)[None, ..., None])
    mask = hit.any(dim=-1) | vert_blk[:, None, :]
    diag = (diff >= -(KB - 1)) & (diff <= QB - 1)
    mask = mask | diag[None] | (torch.arange(n_kb, device=dev) == 0)[None, None, :]
    return mask.to(torch.int32)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def flash_prefill_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    true_len: torch.Tensor, window: int, q_block: int = 256,
    sliding_window: Optional[int] = None, row_offset: RowOffset = None,
    block_mask: Optional[torch.Tensor] = None, block: int = 0,
    return_ml: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`flash_prefill_attention`: fp32 logits and
    softmax blocked over ``q_block`` q rows, the same masks, window scores
    and, with ``return_ml``, ``(m, l)`` (an empty row: ``NEG_INF``, 0 and a
    zero output, as the kernel gives).  ``block_mask [B, Hq, n, n]`` (with
    its ``block`` size, whole-sequence queries only) hides the columns
    whose block the row's block does not select.  As in both kernels, the
    unnormalized probabilities ``exp(s - m)`` are rounded to the value
    dtype before the PV product and the result is divided by the fp32 row
    sum afterwards.  A row that sees
    no column (an inert row, ``true_len`` 0) averages every value row:
    finite, and never read (zeros with ``return_ml``)."""
    B, Hq, S_q, D = q.shape
    Hkv, S_k = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    tl = true_len.to(device=dev, dtype=torch.int64)
    off = torch.zeros((B,), dtype=torch.int64, device=dev) if row_offset is None \
        else torch.as_tensor(row_offset, device=dev).to(torch.int64).reshape(-1).expand(B)
    qg = q.reshape(B, Hkv, G, S_q, D)
    kf, vf = k.float(), v.float()
    cols = torch.arange(S_k, device=dev)
    scores = torch.zeros((B, Hkv, G, S_k), dtype=torch.float32, device=dev)
    if block_mask is not None:
        sel_all = block_mask.to(device=dev, dtype=torch.bool)
        col_blk = cols // block
    outs, ms, ls = [], [], []
    for r0 in range(0, S_q, q_block):
        qblk = qg[:, :, :, r0:r0 + q_block].float()
        rows = off[:, None] + r0 + torch.arange(qblk.shape[3], device=dev)  # [B, n] global
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kf) * D ** -0.5
        lim = torch.minimum(rows, tl[:, None] - 1)
        bad = cols[None, None] > lim[:, :, None]                 # [B, n, S_k]
        if sliding_window is not None:
            bad = bad | (cols[None, None] <= rows[:, :, None] - sliding_window)
        bad = bad[:, None, None]
        if block_mask is not None:
            row_blk = (r0 + torch.arange(qblk.shape[3], device=dev)) // block
            sel = sel_all[:, :, row_blk][..., col_blk]           # [B, Hq, n, S_k]
            bad = bad | ~sel.reshape(B, Hkv, G, -1, S_k)
        logits = torch.where(bad, NEG_INF, logits)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        denom = p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vf) / denom
        if return_ml:
            empty = m == NEG_INF
            denom = torch.where(empty, 0.0, denom)
            out = torch.where(empty, 0.0, out)
            ms.append(m[..., 0])
            ls.append(denom[..., 0])
        outs.append(out.to(q.dtype))
        if window:
            in_win = (rows >= tl[:, None] - window) & (rows < tl[:, None])
            if bool(in_win.any()):
                scores += (p / denom * in_win[:, None, None, :, None]).sum(dim=3)
    out = torch.cat(outs, dim=3).reshape(B, Hq, S_q, D)
    if return_ml:
        return (out, scores.reshape(B, Hq, S_k), torch.cat(ms, dim=3).reshape(B, Hq, S_q),
                torch.cat(ls, dim=3).reshape(B, Hq, S_q))
    return out, scores.reshape(B, Hq, S_k)


def window_scores_reference(
    q: torch.Tensor, k: torch.Tensor, true_len: torch.Tensor, window: int,
    m: torch.Tensor, l: torch.Tensor, block_mask: Optional[torch.Tensor] = None,
    block: int = 0,
) -> torch.Tensor:
    """Plain version of K1's window-score pass: ``scores [B, Hq, S]`` fp32,
    ``scores[b, h, c]`` the sum over the window rows ``r`` in ``[true_len -
    window, true_len)``, ``r >= 0``, ``c <= r`` (and, with ``block_mask``,
    ``r``'s block selecting ``c``'s) of ``exp(q[r].k[c] / sqrt(D) - m[r]) /
    l[r]``, where ``m``, ``l [B, Hq, S]`` are each row's final softmax max and
    sum in natural-log units (what the main pass stores for the window rows,
    and what :func:`flash_prefill_attention` returns with ``return_ml``).
    Columns past every window row are 0."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    dev = q.device
    tl = true_len.to(device=dev, dtype=torch.int64)
    rows = tl[:, None] - window + torch.arange(window, device=dev)    # [B, W] global
    valid = rows >= 0
    at = rows.clamp(min=0)
    pick = lambda x: torch.gather(x.float(), 2, at[:, None, :].expand(B, Hq, window))  # noqa: E731
    qw = torch.gather(q.float(), 2, at[:, None, :, None].expand(B, Hq, window, D))
    logits = torch.einsum("bhgwd,bhkd->bhgwk", qw.reshape(B, Hkv, Hq // Hkv, window, D),
                          k.float()).reshape(B, Hq, window, S) * D ** -0.5
    cols = torch.arange(S, device=dev)
    keep = (cols[None, None] <= rows[:, :, None]) & valid[:, :, None]          # [B, W, S]
    keep = keep[:, None]
    if block_mask is not None:
        sel = block_mask.to(device=dev, dtype=torch.bool)
        keep = keep & sel[torch.arange(B, device=dev)[:, None, None],
                          torch.arange(Hq, device=dev)[None, :, None],
                          (at // block)[:, None, :]][..., cols // block]
    l_w = pick(l)
    p = torch.exp(logits - pick(m)[..., None]) / torch.where(l_w == 0, 1.0, l_w)[..., None]
    return torch.where(keep, p, 0.0).sum(dim=2)

