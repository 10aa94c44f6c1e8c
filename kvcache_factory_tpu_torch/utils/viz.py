"""Attention visualization (port of ``kvcache_factory_tpu/utils/viz.py``).

``infer_attention`` runs a forward that materializes each layer's softmax
probabilities (viz runs on short prompts, so the O(S^2) maps are fine), in
fp32 on the device of the weights, through the model's own building blocks
(``models/llama.py``: RMSNorm, RoPE, the fused QKV projection with its
biases, ``grouped_attention`` with ``return_probs``, o_proj and the FFN), so
the maps show what the model computes.  No kernel is involved: K1 emits no
probability maps.  The plots import matplotlib only when called.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.llama import _finish_layer, _layer, _qkv, grouped_attention, rope_tables
from ..models.reference import _f32


@torch.no_grad()
def infer_attention(params, cfg: ModelConfig, tokens, scale: float = 1e4) -> List[np.ndarray]:
    """Returns one [Hq, S, S] fp32 attention map per layer (host numpy),
    scaled by ``scale`` (the reference multiplies by 10^4,
    viztools/infer.py:20).  ``tokens``: one prompt, [S] or [1, S]."""
    dev = params["embed"].device
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=dev)
    if tokens.dim() == 1:
        tokens = tokens[None]
    B, S = tokens.shape
    if B != 1:
        raise ValueError("visualization runs on a single prompt")
    Hq = cfg.num_attention_heads

    x = params["embed"][tokens].float()
    cos, sin = rope_tables(cfg, S, dev)
    rows = torch.arange(S, device=dev)[:, None]
    cols = torch.arange(S, device=dev)[None]
    mask = cols <= rows
    if cfg.sliding_window is not None:
        mask = mask & (cols > rows - cfg.sliding_window)
    mask = mask[None, None]

    maps = []
    for li in range(cfg.num_hidden_layers):
        lp = {name: _f32(w) for name, w in _layer(params, li).items()}
        q, k, v = _qkv(x, lp, cfg, cos, sin)
        out, probs = grouped_attention(q, k, v, mask, return_probs=True)
        maps.append(probs.reshape(Hq, S, S).cpu().numpy() * scale)
        x = _finish_layer(x, out, lp, cfg)
    return maps


def plot_attention_heatmap(attn_map: np.ndarray, head: Optional[int] = None,
                           save_path: Optional[str] = None, title: str = "",
                           log_scale: bool = True):
    """Heatmap of one layer's attention (mean over heads unless ``head``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = attn_map[head] if head is not None else attn_map.mean(axis=0)
    if log_scale:
        m = np.log1p(m)
    plt.figure(figsize=(8, 7))
    plt.imshow(m, cmap="viridis", aspect="auto")
    plt.colorbar(label="log(1 + attention x 1e4)" if log_scale else "attention")
    plt.xlabel("key position")
    plt.ylabel("query position")
    plt.title(title or ("head %d" % head if head is not None else "mean heads"))
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path, dpi=120)
        plt.close()
        return save_path
    return plt.gcf()


def plot_budget_allocation(lengths, save_path: Optional[str] = None):
    """Per-layer/per-head retained-cache lengths ([L, H] or [L, B, H], a
    numpy array or a tensor on any device): PyramidKV's pyramid and AdaKV's
    adaptive head budgets."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu().numpy()
    lengths = np.asarray(lengths)
    if lengths.ndim == 3:
        lengths = lengths[:, 0]
    plt.figure(figsize=(9, 5))
    plt.imshow(lengths, cmap="magma", aspect="auto")
    plt.colorbar(label="retained KV entries")
    plt.xlabel("head")
    plt.ylabel("layer")
    plt.title("KV budget allocation")
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path, dpi=120)
        plt.close()
        return save_path
    return plt.gcf()
