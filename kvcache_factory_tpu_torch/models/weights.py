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

plus, where the checkpoint has them, the fused biases ``qkv_bias``
``[L, (Hq + 2*Hkv) * D]`` (Qwen2), ``o_bias`` ``[L, hidden]`` (Llama
``attention_bias``), ``gate_up_bias`` ``[L, 2*ffn]`` and ``down_bias``
``[L, hidden]`` (``mlp_bias``).  :func:`quantize_weights` turns the matmul
weights into W8A16 leaves ``{"q": int8 [..., in, out], "s": fp32 [..., 1,
out]}``, which ``models/llama.py::wdot`` consumes.

Loading sources: a HF model directory (``config.json`` and safetensors
shards, read by ``runtime/native.py::SafetensorsFile``) or an in-memory
``state_dict``.  Each stacked leaf is built one layer at a time in the
target dtype on the target device, so a load never holds the model in
fp32 on the host.
"""

from __future__ import annotations

import json
import math
import os
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Tuple

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
                                  "(ROADMAP.md item 1.9)")
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
    function.  Floating leaves go through fp32 to ``dtype`` (default
    fp32); integer leaves keep their dtype and a W8A16 leaf's scale stays
    fp32, so a weight-quantized tree carries across exactly."""
    def conv(x, cast=True):
        if isinstance(x, dict):
            quantized = set(x) == {"q", "s"}
            return {k: conv(v, cast and not quantized) for k, v in x.items()}
        a = np.asarray(x)
        if np.issubdtype(a.dtype, np.integer):
            return torch.from_numpy(a.copy()).to(device)
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=(dtype if cast else None) or t.dtype)

    return conv(np_params)


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------

# Our stacked leaf -> the HF names of one layer (several: fused along the
# output axis).  HF matrices are [out, in]; ours are [in, out].
_LAYER_MAP = {
    "qkv_proj": ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                 "self_attn.v_proj.weight"),
    "o_proj": ("self_attn.o_proj.weight",),
    "gate_up_proj": ("mlp.gate_proj.weight", "mlp.up_proj.weight"),
    "down_proj": ("mlp.down_proj.weight",),
    "input_norm": ("input_layernorm.weight",),
    "post_norm": ("post_attention_layernorm.weight",),
}
# Optional biases, taken when layer 0 has the first name: Qwen2 carries
# q/k/v biases only; Llama ``attention_bias`` adds o_proj's, ``mlp_bias``
# gate/up/down's.
_BIAS_MAP = {
    "qkv_bias": ("self_attn.q_proj.bias", "self_attn.k_proj.bias",
                 "self_attn.v_proj.bias"),
    "o_bias": ("self_attn.o_proj.bias",),
    "gate_up_bias": ("mlp.gate_proj.bias", "mlp.up_proj.bias"),
    "down_bias": ("mlp.down_proj.bias",),
}


def _as_tensor(x) -> torch.Tensor:
    return x.detach() if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def params_from_state_dict(cfg: ModelConfig, state: Mapping, dtype=torch.float32,
                           device="cuda") -> Dict[str, Any]:
    """A HF Llama / Mistral / Qwen2 ``state_dict``-like mapping (name ->
    torch tensor or numpy array, HF ``[out, in]`` layout) as the stacked
    layout in ``dtype`` on ``device`` (JAX ``weights.py:94-177``): q/k/v
    and gate/up fused along the output axis, matrices transposed to
    input-major, the four optional bias kinds, and ``lm_head`` from the
    embedding when the model ties them or the checkpoint has none.  Each
    source tensor is read once, moved to ``device`` in its stored dtype,
    and copied (cast, transposed) into its layer's slot of the stacked
    leaf, so the mapping may read lazily from disk."""
    if cfg.is_moe:
        raise NotImplementedError("MoE checkpoints are not ported yet (ROADMAP.md item 1.9)")
    L = cfg.num_hidden_layers

    def get(name: str) -> torch.Tensor:
        return _as_tensor(state[name]).to(device)

    def stack(names: Tuple[str, ...]) -> torch.Tensor:
        out = None
        for li in range(L):
            parts = [get(f"model.layers.{li}.{n}") for n in names]
            parts = [w.T if w.dim() == 2 else w for w in parts]
            if out is None:
                width = sum(w.shape[-1] for w in parts)
                out = torch.empty((L,) + parts[0].shape[:-1] + (width,), dtype=dtype,
                                  device=device)
            o = 0
            for w in parts:
                out[li, ..., o:o + w.shape[-1]].copy_(w)
                o += w.shape[-1]
        return out

    layers = {ours: stack(theirs) for ours, theirs in _LAYER_MAP.items()}
    for ours, theirs in _BIAS_MAP.items():
        if f"model.layers.0.{theirs[0]}" in state:
            layers[ours] = stack(theirs)

    embed = get("model.embed_tokens.weight").to(dtype)
    if cfg.tie_word_embeddings or "lm_head.weight" not in state:
        lm_head = embed.T.contiguous()
    else:
        lm_head = get("lm_head.weight").T.to(dtype).contiguous()
    return {"embed": embed, "layers": layers,
            "final_norm": get("model.norm.weight").to(dtype), "lm_head": lm_head}


class _CheckpointState(Mapping):
    """Tensor name -> CPU tensor, read from the checkpoint's shards on each
    lookup; the shards stay open until :meth:`close`."""

    def __init__(self, model_dir: str):
        index_path = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.exists(index_path):
            with open(index_path) as f:
                self._where = dict(json.load(f)["weight_map"])
            shards = sorted(set(self._where.values()))
        else:
            shards = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
            self._where = None
        if not shards:
            raise FileNotFoundError(f"no safetensors shards in {model_dir}")
        from ..runtime.native import SafetensorsFile
        self._files = {}
        try:
            for shard in shards:
                self._files[shard] = SafetensorsFile(os.path.join(model_dir, shard))
        except OSError:
            self.close()
            raise
        if self._where is None:
            self._where = {name: shard for shard, f in self._files.items() for name in f.keys()}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._files[self._where[name]].tensor(name)

    def __contains__(self, name) -> bool:  # without reading the tensor
        return name in self._where

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def close(self) -> None:
        for f in self._files.values():
            f.close()


def load_params(model_dir: str, cfg: Optional[ModelConfig] = None, dtype=torch.bfloat16,
                device="cuda") -> Tuple[Dict[str, Any], ModelConfig]:
    """Load a HF checkpoint directory (``config.json`` and safetensors
    shards, listed by ``model.safetensors.index.json`` where the checkpoint
    is sharded) onto ``device`` in ``dtype``; returns ``(params, cfg)``.
    The native reader serves unless it cannot be built:
    ``SafetensorsFile.bytes_read`` says which did."""
    if cfg is None:
        cfg = ModelConfig.from_json(os.path.join(model_dir, "config.json"))
    state = _CheckpointState(model_dir)
    try:
        return params_from_state_dict(cfg, state, dtype, device), cfg
    finally:
        state.close()


# ---------------------------------------------------------------------------
# Weight-only quantization (W8A16)
# ---------------------------------------------------------------------------

# The matmul weights that carry decode's weight stream (JAX
# ``weights.py:186``).  The embedding (a row gather), norms and biases stay
# in the model's dtype.
WEIGHT_QUANT_KEYS = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")


def _quantize_matrix(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``[..., in, out]`` -> per-out-channel symmetric int8 over the input
    axis, one leading index at a time (a 7B FFN leaf in fp32 at once would
    take 15 GB)."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:-2] + (1, w.shape[-1]), dtype=torch.float32, device=w.device)
    for idx in np.ndindex(*w.shape[:-2]):
        wf = w[idx].float()
        scale = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-30) / 127.0
        # The scale is rounded to bf16 before q is computed, so the stored
        # fp32 scale is bf16-exact and wdot's cast of it to a bf16
        # activation dtype loses nothing (JAX ``weights.py:257-264``).
        scale = scale.to(torch.bfloat16).float()
        q[idx] = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        s[idx] = scale
    return {"q": q, "s": s}


def quantize_weights(params: Dict[str, Any], nbits: int = 8,
                     skip: tuple = ()) -> Dict[str, Any]:
    """Weight-only int8 quantization (W8A16) of the matmul weights (JAX
    ``weights.py:209-276``): each weight ``[..., in, out]`` becomes ``{"q":
    int8, "s": fp32 [..., 1, out]}`` with a per-out-channel symmetric scale
    over the input axis, rounded half to even and clipped to +-127; the
    forward applies the scale after the dot (``models/llama.py::wdot``).
    ``skip`` keeps named matrices in the model's dtype: "lm_head" and the
    ``WEIGHT_QUANT_KEYS`` layer entries.  Returns a new dict; the caller
    frees the source weights."""
    if nbits != 8:
        raise NotImplementedError(
            "weight-only quantization supports nbits=8; int4 weights need a packed-nibble "
            "unpack in the matmul, as in the JAX package")
    if isinstance(params.get("lm_head"), dict) or any(
            isinstance(v, dict) for v in params["layers"].values()):
        raise ValueError(
            "params are already weight-quantized ({'q', 's'} leaves found); "
            "quantize_weights must be applied to fp weights exactly once")
    known = set(WEIGHT_QUANT_KEYS) | {"lm_head"}
    unknown = set(skip) - known
    if unknown:
        raise ValueError(f"skip names {sorted(unknown)} not quantizable "
                         f"(valid: {sorted(known)})")
    out = dict(params)
    if "lm_head" not in skip:
        out["lm_head"] = _quantize_matrix(params["lm_head"])
    out["layers"] = {k: (_quantize_matrix(v) if k in WEIGHT_QUANT_KEYS and k not in skip
                         else v) for k, v in params["layers"].items()}
    return out
