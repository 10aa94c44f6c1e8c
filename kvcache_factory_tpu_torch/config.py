"""Typed configuration for the PyTorch/CUDA port.

The port keeps its own copy of the JAX package's configuration dataclasses
(``kvcache_factory_tpu/config.py``) so that it never imports that package,
whose ``config.py`` imports ``jax.numpy``.  Field names, defaults and
validation are the same; ``dtype_of`` returns torch dtypes.

Features the port does not carry yet raise ``NotImplementedError`` naming
their ROADMAP.md item, rather than being silently ignored.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for a Llama/Mistral-family decoder
    (the fields of HF ``LlamaConfig`` / ``MistralConfig`` the forward uses)."""

    model_type: str = "llama"  # "llama" | "mistral" | "mixtral"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 8192
    rope_theta: float = 10000.0
    # HF rope_scaling (hashable): ("llama3", factor, low_freq_factor,
    # high_freq_factor, original_max_position) or ("linear", factor, 0, 0, 0).
    rope_scaling: Optional[Tuple[str, float, float, float, int]] = None
    rms_norm_eps: float = 1e-5
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    num_local_experts: int = 0  # 0 = dense FFN
    num_experts_per_tok: int = 2
    dtype: str = "bfloat16"

    @property
    def is_moe(self) -> bool:
        return self.num_local_experts > 0

    @staticmethod
    def from_hf_config(cfg: Any) -> "ModelConfig":
        """Build from a HF PretrainedConfig (or a dict loaded from config.json)."""
        if not isinstance(cfg, dict):
            cfg = cfg.to_dict()
        head_dim = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
        return ModelConfig(
            model_type=cfg.get("model_type", "llama"),
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=head_dim,
            max_position_embeddings=cfg.get("max_position_embeddings", 8192),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=_rope_scaling_tuple(cfg.get("rope_scaling")),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            sliding_window=_resolve_sliding_window(cfg),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            attention_bias=cfg.get("attention_bias", False),
            mlp_bias=cfg.get("mlp_bias", False),
            num_local_experts=cfg.get("num_local_experts", 0) or 0,
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
        )

    @staticmethod
    def from_json(path: str) -> "ModelConfig":
        """Build from a HF checkpoint's ``config.json``."""
        with open(path) as f:
            return ModelConfig.from_hf_config(json.load(f))


def _resolve_sliding_window(cfg: dict):
    """HF sliding-window semantics resolved to one global window (Mistral:
    plain ``sliding_window``; Qwen2: gated by ``use_sliding_window``).
    Genuinely mixed layer types are rejected."""
    sw = cfg.get("sliding_window")
    if sw is None:
        return None
    if "use_sliding_window" in cfg and not cfg["use_sliding_window"]:
        return None
    lt = cfg.get("layer_types")
    if lt:
        kinds = set(lt)
        if kinds == {"full_attention"}:
            return None
        if kinds != {"sliding_attention"}:
            raise NotImplementedError(
                "mixed full/sliding attention layer_types not supported")
        return sw
    mwl = cfg.get("max_window_layers")
    if cfg.get("use_sliding_window") and mwl:
        if mwl >= cfg["num_hidden_layers"]:
            return None
        raise NotImplementedError(
            "per-layer sliding window (max_window_layers) not supported")
    return sw


def _rope_scaling_tuple(rs):
    """HF rope_scaling dict -> hashable tuple (or None)."""
    if not rs:
        return None
    rope_type = rs.get("rope_type") or rs.get("type")
    return (rope_type, float(rs.get("factor", 1.0)),
            float(rs.get("low_freq_factor", 0.0)),
            float(rs.get("high_freq_factor", 0.0)),
            int(rs.get("original_max_position_embeddings", 0)))


# ---------------------------------------------------------------------------
# Compression configuration
# ---------------------------------------------------------------------------

KNOWN_METHODS = (
    "fullkv", "minference", "snapkv", "pyramidkv", "h2o", "streamingllm",
    "l2norm", "cam", "adakv", "headkv", "think", "random",
)


@dataclass(frozen=True)
class CompressionConfig:
    """Prefill-time KV compression policy (same fields and meaning as the
    JAX package's ``CompressionConfig``; see its docstring for each)."""

    method: str = "fullkv"
    max_capacity_prompt: int = 2048
    window_size: int = 32
    kernel_size: int = 7
    pooling: str = "maxpool"  # "avgpool" | "maxpool"
    beta: int = 20
    skip_layers: Tuple[int, ...] = (0, 1)
    start_budget_ratio: float = 0.1
    floor_ratio: float = 0.2
    normalize: bool = True
    head_capacity: Optional[Tuple[Tuple[int, ...], ...]] = None
    head_beta: float = 1.01
    pruning_ratio: float = 0.4
    recent_size: int = 32
    think_packed: bool = False
    merge: Optional[str] = None  # None | "pivot"
    group_reduce: str = "none"  # "none" | "mean" | "max" | "sum"
    head_capacity_bound_factor: float = 2.0
    sparse_prefill: Optional[Tuple] = None
    decode_evict: bool = False
    eviction_recent: int = 32

    def __post_init__(self):
        if self.method not in KNOWN_METHODS:
            raise ValueError(f"unknown method {self.method!r}; expected one of {KNOWN_METHODS}")
        if self.max_capacity_prompt - self.window_size <= 0 \
                and self.method not in ("fullkv", "minference", "l2norm"):
            raise ValueError("max_capacity_prompt must exceed window_size")
        if self.pooling not in ("avgpool", "maxpool"):
            raise ValueError("pooling must be avgpool or maxpool")
        if self.think_packed and self.method != "think":
            raise ValueError("think_packed requires method='think'")

    @property
    def base_capacity(self) -> int:
        """Retained non-window budget (reference ``max_capacity_prompt - window``)."""
        return self.max_capacity_prompt - self.window_size

    def cache_heads(self, num_query_heads: int, num_kv_heads: int) -> int:
        """Heads the packed cache carries: the KV heads when nothing is
        selected per query head (fullkv, minference) or when selections are
        group-reduced; otherwise one entry set per query head."""
        if self.method in ("fullkv", "minference") or self.group_reduce != "none":
            return num_kv_heads
        return num_query_heads

    def layer_capacity(self, num_layers: int, prefill_len: int) -> int:
        """Static per-layer cache capacity that holds this policy's output."""
        if self.method in ("fullkv", "minference"):
            return prefill_len
        cap = self.max_capacity_prompt
        if prefill_len <= cap:
            return prefill_len
        if self.method == "pyramidkv":
            base = self.base_capacity
            min_num = base // self.beta
            max_num = base * 2 - min_num
            max_num = min(max_num, prefill_len - self.window_size)
            return max_num + self.window_size
        if self.method in ("adakv", "headkv"):
            bound = int(math.ceil(self.base_capacity * self.head_capacity_bound_factor))
            bound = min(bound, prefill_len - self.window_size)
            return bound + self.window_size
        if self.method == "l2norm" and self.skip_layers:
            return prefill_len
        return cap


# ---------------------------------------------------------------------------
# Quantized-cache and sharding configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QuantConfig:
    """Quantized KV cache settings, as in the JAX package.  Which cache a
    configuration builds is :meth:`per_token`: the per-token int8 or int4
    cache that K3 / K4 stream, or else the grouped cache
    (``cache/quant_cache.py::QuantizedKVCache``: nbits 1/2/3, an fp
    residual ring, per-group outliers, any head_dim)."""

    nbits: int = 8
    q_group_size: int = 64
    outlier_extract: bool = True
    residual_length: int = 0
    axis_key: int = 1
    axis_value: int = 0

    def __post_init__(self):
        if self.nbits not in (1, 2, 3, 4, 8):
            raise ValueError("quantized cache supports nbits in {1, 2, 3, 4, 8}")

    def per_token(self, head_dim: int) -> bool:
        """Whether this configuration takes the per-token cache: one scale
        and one zero per token and head over the full head_dim, whatever
        ``q_group_size`` and ``outlier_extract`` say.  The JAX package's
        rule (``models/llama.py::_quant_tpu_layout``: ``head_dim % 128 ==
        0``) without its backend and capacity tests: the port chooses from
        the configuration alone, and its kernels (K3 and K4) take any
        capacity and every such head_dim.  Every other configuration
        (head_dim 64 and 80 included) builds the grouped cache, as JAX's XLA
        path does."""
        return (self.nbits in (8, 4) and self.residual_length == 0
                and head_dim % 128 == 0)


@dataclass(frozen=True)
class ShardingConfig:
    """Device-mesh layout, as in the JAX package, over the ranks of a
    ``torch.distributed`` group (``parallel/mesh.py::ParallelGroups``):
    ``dp`` (batch rows), ``tp`` (heads and FFN columns, Megatron-style) and
    either ``sp`` (sequence-parallel prefill by ring attention) or ``ep``
    (the MoE expert axis) in one ``(dp, sp, tp)`` or ``(dp, ep, tp)`` grid;
    ``pp`` (layers over GPipe stages, ``parallel/pipeline.py``) alone, with
    ``pp_microbatches`` (0 = pp) microbatches; ``dcn_dp`` the dp ways that
    cross hosts.  The JAX package's ``ValueError``s hold."""

    dp: int = 1
    tp: int = 1
    ep: int = 1
    sp: int = 1
    pp: int = 1
    pp_microbatches: int = 0
    dcn_dp: int = 1

    def __post_init__(self):
        if min(self.dp, self.tp, self.ep, self.sp, self.pp, self.dcn_dp) < 1:
            raise ValueError("every mesh axis must be >= 1")
        if self.dp % self.dcn_dp != 0:
            raise ValueError("dcn_dp must divide dp")
        if self.sp > 1 and self.ep > 1:
            raise ValueError("sp composes with dp/tp (one (dp, sp, tp) mesh) but not with ep")
        if self.pp > 1 and (self.dp * self.tp * self.ep > 1 or self.sp > 1):
            raise ValueError("pp is a dedicated mesh; it does not compose with dp/tp/ep/sp "
                             "in one config")
        if self.pp_microbatches and self.pp_microbatches < self.pp:
            raise ValueError("pp_microbatches must be >= pp (GPipe decode needs one "
                             "microbatch per in-flight stage)")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The JAX package's mesh axes for this layout (its ``(dp[, ep],
        tp)`` mesh; an ``sp`` layout runs on the ``(dp, sp, tp)`` grid, a
        ``pp`` layout on its own stage axis)."""
        return ("dp", "ep", "tp") if self.ep > 1 else ("dp", "tp")

    @property
    def world(self) -> int:
        """Ranks of the layout: the ``(dp, sp|ep, tp)`` grid, or the pp stages."""
        return self.dp * self.sp * self.ep * self.tp * self.pp


# ---------------------------------------------------------------------------
# Generation / engine configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    eos_token_ids: Tuple[int, ...] = ()
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    min_new_tokens: int = 1


@dataclass(frozen=True)
class EngineConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    quant: Optional[QuantConfig] = None
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    prefill_buckets: Tuple[int, ...] = (512, 1024, 2048, 4096, 8192)
    capacity_ratio: Optional[float] = None


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]
