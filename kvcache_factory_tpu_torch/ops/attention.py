"""Prefill attention ops (plain torch).

``blocked_causal_attention`` processes query rows in blocks, so peak memory
is O(H * q_block * S) instead of the O(H * S^2) of a naive masked softmax.
The math is exact (full-row fp32 softmax per block), the same as
``kvcache_factory_tpu/ops/attention.py`` without its sliding-window and
chunk (``row_offset``) options, which come with the K1 variants that use
them.  The port's prefill attention is the flash kernel
(``ops/kernels/flash_prefill.py``); this function serves the fp32 reference
forward (``models/reference.py``).
"""

from __future__ import annotations

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def blocked_causal_attention(
    q: torch.Tensor,         # [B, Hq, S, D]
    k: torch.Tensor,         # [B, Hkv, S, D]
    v: torch.Tensor,         # [B, Hkv, S, D]
    true_len: torch.Tensor,  # [B] int
    q_block: int = 512,
) -> torch.Tensor:
    """Causal self-attention over each example's first ``true_len`` keys,
    q-row blocked."""
    B, Hq, S, D = q.shape
    Hk = k.shape[1]
    G = Hq // Hk
    dev = q.device
    true_len = true_len.to(device=dev, dtype=torch.int64)
    qb = min(q_block, S)
    scale = 1.0 / float(D) ** 0.5
    cols = torch.arange(S, device=dev)
    qg = q.reshape(B, Hk, G, S, D)
    outs = []
    for r0 in range(0, S, qb):
        qblk = qg[:, :, :, r0:r0 + qb]
        n = qblk.shape[3]
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qblk.float(), k.float()) * scale
        rows = (r0 + torch.arange(n, device=dev))[None, :, None]      # [1, n, 1]
        m = (cols[None, None] <= rows) & (cols[None, None] < true_len[:, None, None])
        logits = torch.where(m[:, None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).float(), v.float())
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=3).reshape(B, Hq, S, D)
