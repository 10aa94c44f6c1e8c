"""Generation-state checkpoints: save a decode mid-stream and resume it
(port of ``kvcache_factory_tpu/runtime/checkpoint.py``).

The state is the cache (any kind the port decodes over), the current input
tokens and the tokens generated so far.  It goes into a directory: one
``torch.save`` of a dict of tensors (``state.pt``; a cache's ``None``
planes are dropped, as the JAX package drops them, and come back as the
cache type's defaults) and a JSON side file (``kvcf_meta.json``) with the
cache type and the caller's metadata.  It loads with ``torch.load(...,
weights_only=True)`` onto the device the caller names; an offloaded
cache's host K/V loads into pinned host memory beside a card.  A resumed
decode continues bit for bit (``tests/test_torch_caches.py``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..cache.kv_cache import EvictingKVCache, KVCache
from ..cache.offload_cache import OffloadedKVCache
from ..cache.quant_cache import Int4KVCache, Int8KVCache, QuantizedKVCache
from ..cache.think_cache import ThinKCache

_CACHE_TYPES = {cls.__name__: cls for cls in (KVCache, Int8KVCache, Int4KVCache,
                                              QuantizedKVCache, EvictingKVCache, ThinKCache,
                                              OffloadedKVCache)}
_STATE, _META = "state.pt", "kvcf_meta.json"


def save_generation_state(path: str, cache, cur_tokens: torch.Tensor, generated,
                          metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write the state under directory ``path`` (created); returns its
    absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    state = {"cache": {k: v for k, v in cache._asdict().items() if v is not None},
             "cur_tokens": cur_tokens,
             "generated": torch.as_tensor(np.asarray(generated))}
    torch.save(state, os.path.join(path, _STATE))
    with open(os.path.join(path, _META), "w") as f:
        json.dump({"cache_type": type(cache).__name__, "metadata": metadata or {}}, f)
    return path


def load_generation_state(path: str, device="cuda") -> Tuple[Any, torch.Tensor, np.ndarray,
                                                              Dict[str, Any]]:
    """Returns ``(cache, cur_tokens, generated, metadata)``, the tensors on
    ``device`` (an offloaded cache's host K/V on the host)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    state = torch.load(os.path.join(path, _STATE), map_location="cpu", weights_only=True)
    cls = _CACHE_TYPES[meta["cache_type"]]
    device = torch.device(device)

    def place(name, t):
        if cls is OffloadedKVCache and name in ("hk", "hv"):
            return t.pin_memory() if device.type == "cuda" else t
        return t.to(device)

    cache = cls(**{k: place(k, v) for k, v in state["cache"].items()})
    return (cache, state["cur_tokens"].to(device), state["generated"].numpy(),
            meta["metadata"])
