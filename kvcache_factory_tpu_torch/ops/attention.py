"""Prefill attention ops (plain torch).

``blocked_causal_attention`` processes query rows in blocks, so peak memory
is O(H * q_block * S) instead of the O(H * S^2) of a naive masked softmax.
The math is exact (full-row fp32 softmax per block), the same as
``kvcache_factory_tpu/ops/attention.py``, with its sliding-window and chunk
(``row_offset``) options.  The port's prefill attention is the flash kernel
(``ops/kernels/flash_prefill.py``); this function serves the fp32 reference
forward (``models/reference.py``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def blocked_causal_attention(
    q: torch.Tensor,         # [B, Hq, S_q, D]
    k: torch.Tensor,         # [B, Hkv, S, D]
    v: torch.Tensor,         # [B, Hkv, S, D]
    true_len: torch.Tensor,  # [B] int
    sliding_window: Optional[int] = None,
    q_block: int = 512,
    row_offset: Union[None, int, torch.Tensor] = None,  # int or [B]
) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention over each example's
    first ``true_len`` keys, q-row blocked.

    ``row_offset`` (chunked prefill): q is a chunk of a longer sequence
    whose keys fill ``k``/``v``, and q row ``r`` of example ``b`` has the
    global id ``row_offset[b] + r`` (an int applies to every example).
    Every mask uses the global ids: column ``c`` is visible when
    ``c <= row``, ``c > row - sliding_window`` and ``c < true_len``.  With it
    unset, q and k share one length S."""
    B, Hq, S_q, D = q.shape
    Hk, S = k.shape[1], k.shape[2]
    G = Hq // Hk
    dev = q.device
    if row_offset is None:
        if S_q != S:
            raise ValueError("q/k lengths differ only with row_offset")
        row_offset = 0
    off = torch.as_tensor(row_offset, device=dev).to(torch.int64).reshape(-1).expand(B)
    true_len = true_len.to(device=dev, dtype=torch.int64)
    qb = min(q_block, S_q)
    scale = 1.0 / float(D) ** 0.5
    cols = torch.arange(S, device=dev)
    qg = q.reshape(B, Hk, G, S_q, D)
    outs = []
    for r0 in range(0, S_q, qb):
        qblk = qg[:, :, :, r0:r0 + qb]
        n = qblk.shape[3]
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qblk.float(), k.float()) * scale
        rows = (off[:, None] + r0 + torch.arange(n, device=dev))[:, :, None]  # [B, n, 1]
        m = (cols[None, None] <= rows) & (cols[None, None] < true_len[:, None, None])
        if sliding_window is not None:
            m = m & (cols[None, None] > rows - sliding_window)
        logits = torch.where(m[:, None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).float(), v.float())
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=3).reshape(B, Hq, S_q, D)
