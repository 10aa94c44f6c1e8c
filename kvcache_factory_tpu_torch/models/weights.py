"""Parameter initialization and conversion (port of
``kvcache_factory_tpu/models/weights.py``).

Weights layout (matrices input-major so the forward is ``x @ W``; QKV and
gate/up fused), every layer leaf stacked over layers on axis 0:

    {
      "embed":        [V, hidden],
      "layers": {
        "qkv_proj":   [L, hidden, (Hq + 2*Hkv) * D],
        "o_proj":     [L, Hq*D, hidden],
        "gate_up_proj": [L, hidden, 2*ffn],
        "down_proj":  [L, ffn, hidden],
        "input_norm": [L, hidden],       "post_norm": [L, hidden],
      },
      "final_norm":   [hidden],
      "lm_head":      [hidden, V],
    }

Loading a HF checkpoint (``load_params``) is not ported yet (ROADMAP.md
queue 1 item 12).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig, dtype_of


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random init (normal / sqrt(fan_in)) drawn with a ``torch.Generator``
    on ``device``, layer by layer so no full-model fp32 copy is ever held.
    The same seed gives the same weights on the same device type; the draws
    differ from the JAX package's (tests carry JAX weights across with
    :func:`params_from_jax`)."""
    if cfg.is_moe:
        raise NotImplementedError("MoE weights are not ported yet "
                                  "(ROADMAP.md queue 1 item 10)")
    dtype = dtype or dtype_of(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    qd = cfg.num_attention_heads * cfg.head_dim
    kvd = cfg.num_key_value_heads * cfg.head_dim
    L, V = cfg.num_hidden_layers, cfg.vocab_size

    def mat(shape):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w / math.sqrt(shape[0])).to(dtype)

    def stacked(shape):
        out = torch.empty((L,) + shape, dtype=dtype, device=device)
        for li in range(L):
            out[li] = mat(shape)
        return out

    return {
        "embed": mat((V, h)),
        "layers": {
            "qkv_proj": stacked((h, qd + 2 * kvd)),
            "o_proj": stacked((qd, h)),
            "gate_up_proj": stacked((h, 2 * ffn)),
            "down_proj": stacked((ffn, h)),
            "input_norm": torch.ones((L, h), dtype=dtype, device=device),
            "post_norm": torch.ones((L, h), dtype=dtype, device=device),
        },
        "final_norm": torch.ones((h,), dtype=dtype, device=device),
        "lm_head": mat((h, V)),
    }


def params_from_jax(np_params: Dict[str, Any], device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX package's parameter pytree, already converted to numpy
    arrays by the caller (``jax.tree.map(np.asarray, params)``), as the
    port's dict with the same keys, so both packages compute the same
    function."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, dtype=np.float32))
        return t.to(device=device, dtype=dtype or t.dtype)

    return conv(np_params)
