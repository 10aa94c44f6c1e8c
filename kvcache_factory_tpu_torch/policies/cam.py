"""CAM cache merging of values (port of ``kvcache_factory_tpu/policies/cam.py``).

Before eviction, each to-be-evicted value ``v[c]`` is, on a Bernoulli hit
with probability ``col_mean[c] / max(col_mean over the sinks and columns
[c, c + w))``, spread as ``v[c] / w`` over the next ``w`` values.  JAX runs
this as a ``fori_loop`` over ``t = c + w`` in which iteration ``t`` reads
values that earlier iterations changed (:func:`cam_merge_values_sequential`
is that loop, kept as the reference).

The hit coefficients depend on ``col_mean``, the uniforms and ``true_len``
only, never on ``v``; and ``v[c]`` is final when iteration ``c + w`` reads
it.  So the merge is one banded lower-triangular linear recurrence per
head, ``v'[t] = v[t] + sum_{j=1..w} a[t-j] * v'[t-j]`` with
``a[c] = active_c * bern_c / w``, which :func:`cam_merge_values` solves by
forward substitution over blocks of rows (``torch.linalg.solve_triangular``
per block, the previous block's last ``w`` rows carried in).
"""

from __future__ import annotations

import torch


def merge_coefficients(
    col_mean: torch.Tensor,   # [H, S] fp32 mean attention per column (window rows)
    true_len: torch.Tensor,   # 0-d int
    start_budget_ratio: float,
    window_size: int,
    uniforms: torch.Tensor,   # [S, H] in [0, 1)
) -> torch.Tensor:
    """``a [H, S]`` fp32: ``bern_c / w`` where column ``c`` is merged
    forward (iteration ``t = c + w`` active and its draw below ``p_c``), else 0."""
    H, S = col_mean.shape
    w = window_size
    dev = col_mean.device
    a = torch.zeros((H, S), dtype=torch.float32, device=dev)
    n = S - w  # iterations t = w .. S-1 merge columns c = 0 .. n-1
    if n <= 0:
        return a
    tl = true_len.to(torch.int64)
    # jnp.ceil(start_budget_ratio * true_len) in fp32 (the ratio rounded to
    # fp32 on the host: no copy to the device)
    ratio = float(torch.tensor(start_budget_ratio, dtype=torch.float32))
    start_budget = torch.ceil(tl.to(torch.float32) * ratio).to(torch.int64)
    cols = torch.arange(S, device=dev)
    sink_max = torch.where(cols < start_budget, col_mean, float("-inf")).amax(-1, keepdim=True)
    win_max = col_mean.unfold(1, w, 1)[:, :n].amax(-1)  # max over columns [c, c + w)
    p = col_mean[:, :n] / torch.maximum(win_max, sink_max)
    p = torch.where(torch.isnan(p), 0.0, p)
    p = torch.where(torch.isinf(p), 1.0, p).clamp(0.0, 1.0)
    bern = (uniforms[w:, :].T < p).to(torch.float32)
    c = cols[:n]
    active = (c >= start_budget) & (c < tl - w)
    a[:, :n] = torch.where(active, bern, 0.0) / w
    return a


def cam_merge_values(
    v: torch.Tensor,          # [H, S, D]
    col_mean: torch.Tensor,   # [H, S] fp32
    true_len: torch.Tensor,   # 0-d int
    start_budget_ratio: float,
    window_size: int,
    uniforms: torch.Tensor,   # [S, H]
    *,
    block: int = 256,
) -> torch.Tensor:
    """Values with CAM's merging applied, in fp32 and cast back to
    ``v.dtype``: forward substitution over ``block``-row blocks."""
    H, S, D = v.shape
    w = window_size
    a = merge_coefficients(col_mean, true_len, start_budget_ratio, w, uniforms)
    T = max(block, w)
    nb = -(-S // T)
    pad = nb * T - S
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    ab = torch.nn.functional.pad(a, (0, pad)).reshape(H, nb, T)
    i = torch.arange(T, device=v.device)
    band = ((i[:, None] - i[None]) >= 1) & ((i[:, None] - i[None]) <= w)
    # Unit lower-triangular (I - A_b) per block: A_b[i, j] = a[j] on the band.
    m = torch.eye(T, device=v.device) - torch.where(band, ab[:, :, None, :], 0.0)
    # Rows i < w of a block take a[j] * v'[j] from the previous block's last
    # w rows j (as offsets jj in [0, w): those with jj >= i).
    cross = i[:w, None] <= i[None, :w]
    out = torch.empty_like(vf)
    for b in range(nb):
        rhs = vf[:, b * T:(b + 1) * T]
        if b > 0:
            e = torch.where(cross, ab[:, b - 1, None, T - w:], 0.0)  # [H, w, w]
            tail = out[:, b * T - w:b * T]
            rhs = torch.cat([rhs[:, :w] + e @ tail, rhs[:, w:]], dim=1)
        out[:, b * T:(b + 1) * T] = torch.linalg.solve_triangular(
            m[:, b], rhs, upper=False, unitriangular=True)
    return out[:, :S].to(v.dtype)


def cam_merge_values_sequential(
    v: torch.Tensor,
    col_mean: torch.Tensor,
    true_len: torch.Tensor,
    start_budget_ratio: float,
    window_size: int,
    uniforms: torch.Tensor,
) -> torch.Tensor:
    """JAX's ``fori_loop`` form step by step, in ``v.dtype`` (the reference
    :func:`cam_merge_values` is held to)."""
    H, S, D = v.shape
    w = window_size
    a = merge_coefficients(col_mean, true_len, start_budget_ratio, w, uniforms)
    hit = (a > 0).to(v.dtype)
    v = torch.nn.functional.pad(v, (0, 0, 0, w + 1)).clone()
    for c in range(S - w):
        # JAX: add = v[c] * bern / w; seg += active * add (a = active * bern / w)
        add = v[:, c] * hit[:, c, None] / w
        v[:, c + 1:c + 1 + w] += add[:, None]
    return v[:, :S]
