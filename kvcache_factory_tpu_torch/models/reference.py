"""Plain fp32 full forward: no cache, no compression, no kernels.

``forward_logits`` is the yardstick the card's bf16 path is held against
(``chip_smoke.py``): prefill logits agree with it whatever the compression,
and with no compression every decode step's logits agree with it over the
prompt plus the generated tokens.  Weights are upcast to fp32 one layer at
a time, and attention goes over q-row blocks, so a 7B model at a few
thousand tokens fits beside its bf16 weights.  A W8A16 leaf enters as its
dequantized fp32 matrix ``q * s``, the function the W8A16 path computes,
so that path is held to the bf16 path's limits; the optional biases are
added where the model has them.  A Mixtral layer's FFN is ``moe_ffn`` on
the fp32 expert stacks (its per-token dispatch, one layer's experts in
fp32 at a time: 5.6 GB at Mixtral-8x7B widths); ``moe_router`` is looked
up in ``models/llama.py`` at each call, so a caller may replay another
run's routing through it.  Under expert parallelism (``ep``) each rank
holds its experts and the fp32 block's output is summed over the ranks
(``llama.ffn_block``), so no rank dequantizes or holds the whole model.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from ..parallel.mesh import ExpertShard
from ..ops.attention import blocked_causal_attention
from .llama import (_layer, _merge_heads, _split_heads, apply_rope, ffn_block, rms_norm,
                    rope_tables)


def _f32(w) -> torch.Tensor:
    """A weight leaf in fp32; a W8A16 leaf dequantized (expert stacks too)."""
    if isinstance(w, dict):
        return w["q"].float() * w["s"].float()
    return w.float()


@torch.no_grad()
def forward_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   q_block: int = 256, ep: Optional[ExpertShard] = None) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] fp32, causal over all T tokens
    (and inside ``cfg.sliding_window`` when the model has one)."""
    B, T = tokens.shape
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    dev = tokens.device
    f32 = torch.float32
    x = params["embed"][tokens].to(f32)
    cos, sin = rope_tables(cfg, T, dev)
    full = torch.full((B,), T, dtype=torch.int64, device=dev)
    for li in range(cfg.num_hidden_layers):
        lp = {name: _f32(w) for name, w in _layer(params, li).items()}
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        qkv = h @ lp["qkv_proj"]
        if "qkv_bias" in lp:
            qkv = qkv + lp["qkv_bias"]
        q = apply_rope(_split_heads(qkv[..., :Hq * D], Hq, D), cos, sin)
        k = apply_rope(_split_heads(qkv[..., Hq * D:(Hq + Hkv) * D], Hkv, D),
                       cos, sin)
        v = _split_heads(qkv[..., (Hq + Hkv) * D:], Hkv, D)
        attn = blocked_causal_attention(q, k, v, full, cfg.sliding_window,
                                        q_block=q_block)
        o = _merge_heads(attn) @ lp["o_proj"]
        x = x + (o if "o_bias" not in lp else o + lp["o_bias"])
        h2 = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
        x = x + ffn_block(h2, lp, cfg, ep=ep)
    x = rms_norm(x, params["final_norm"].to(f32), cfg.rms_norm_eps)
    return x @ _f32(params["lm_head"])
