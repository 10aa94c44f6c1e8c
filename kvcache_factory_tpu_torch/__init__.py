"""PyTorch/CUDA port of kvcache_factory_tpu for one NVIDIA H100.

The JAX package ``kvcache_factory_tpu`` is the reference and is never
imported here.  Entry points run on the card unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper uses its plain version.
"""

from .config import (CompressionConfig, EngineConfig, GenerationConfig,
                     ModelConfig, QuantConfig, ShardingConfig)

__all__ = ["CompressionConfig", "EngineConfig", "GenerationConfig",
           "ModelConfig", "QuantConfig", "ShardingConfig"]
