"""Encoder-decoder cache (port of ``kvcache_factory_tpu/cache/encdec_cache.py``).

The reference's vendored ``EncoderDecoderCache`` (cache_utils_think.py:
1269-1434): a self-attention cache and a cross-attention cache, with
per-layer ``is_updated`` flags (a layer's cross K/V is computed once from
the encoder output, then reused) and the beam reorder.  Either side may be
any cache of the port whose tensors follow the ``[L, B, ...]`` layout rule
(``positions`` ``[B]``); ``cross_written [L]`` bool replaces the flags.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EncoderDecoderCache(NamedTuple):
    self_cache: object          # the decoder self-attention cache
    cross_cache: object         # the decoder -> encoder cross-attention cache
    cross_written: torch.Tensor  # [L] bool — cross K/V stored yet?

    @property
    def num_layers(self) -> int:
        return int(self.cross_written.shape[0])


def build_encoder_decoder_cache(self_cache, cross_cache) -> EncoderDecoderCache:
    """Wrap the two caches; ``cross_written`` from the cross cache's
    per-layer lengths, as the reference derives ``is_updated`` from
    ``get_seq_length(layer_idx) > 0`` (:1300-1302)."""
    return EncoderDecoderCache(self_cache=self_cache, cross_cache=cross_cache,
                               cross_written=(cross_cache.lengths > 0).flatten(1).any(dim=1))


def mark_cross_written(cache: EncoderDecoderCache, layer_idx: int) -> EncoderDecoderCache:
    """Reference :1397: the layer's cross K/V is stored (in place)."""
    cache.cross_written[layer_idx] = True
    return cache


def select_cross(cache: EncoderDecoderCache, layer_idx: int, fresh_k: torch.Tensor,
                 fresh_v: torch.Tensor):
    """The reuse rule (:1393-1398): the cached cross K/V once the layer's is
    written, else the fresh encoder projection (which the caller stores).
    A select on the flag, so no host read."""
    written = cache.cross_written[layer_idx]
    n = fresh_k.shape[-2]
    k = torch.where(written, cache.cross_cache.k[layer_idx][..., :n, :], fresh_k)
    v = torch.where(written, cache.cross_cache.v[layer_idx][..., :n, :], fresh_v)
    return k, v


def batch_select(cache: EncoderDecoderCache, indices: torch.Tensor) -> EncoderDecoderCache:
    """The beam reorder (``reorder_cache`` / ``batch_select_indices``,
    :1359-1372): the given batch rows of every tensor of both caches, as a
    new cache (``positions``-like tensors are ``[B]``, the rest
    ``[L, B, ...]``)."""
    def take(c):
        return type(c)(*(t if t is None else
                         t.index_select(0 if t.dim() == 1 else 1, indices.long())
                         for t in c))

    return cache._replace(self_cache=take(cache.self_cache), cross_cache=take(cache.cross_cache))
