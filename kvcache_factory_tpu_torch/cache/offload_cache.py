"""Host-offloaded KV cache (port of ``kvcache_factory_tpu/cache/offload_cache.py``).

The compressed prefill K/V moves once, after prefill, to host memory and is
never written again; decode appends go to a small ring on the device (the
decode headroom).  Each decode step copies every layer's host K/V to the
device and attends over ``[host rows ‖ ring]``, so the cache's device
memory is the ring alone and the host link bounds decode (the reference's
HF ``OffloadedCache``, cache_utils_think.py:507, makes the same trade).

On a CUDA cache the host tensors are pinned, so the copies are
asynchronous, and :class:`LayerPrefetch` starts layer ``i + 1``'s copy on a
side stream while layer ``i`` computes, as the reference's OffloadedCache
prefetches.  A failed pin raises: the prefill K/V is never kept on the card
instead.  On a CPU cache (the tests) the host tensors are ordinary CPU
tensors, the JAX package's CPU behaviour.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class OffloadedKVCache(NamedTuple):
    hk: torch.Tensor           # [L, B, H, C, D] host (pinned beside a card), never written
    hv: torch.Tensor           # [L, B, H, C, D]
    dk: torch.Tensor           # [L, B, H, R, D] decode ring on the device
    dv: torch.Tensor           # [L, B, H, R, D]
    prefill_len: torch.Tensor  # [L, B, H] int32 valid host rows (fixed)
    lengths: torch.Tensor      # [L, B, H] int32 total valid rows
    positions: torch.Tensor    # [B] int32 uncompressed token count

    @property
    def capacity(self) -> int:
        return self.hk.shape[3] + self.dk.shape[3]

    @property
    def host_capacity(self) -> int:
        return self.hk.shape[3]

    @property
    def device_capacity(self) -> int:
        return self.dk.shape[3]


def _to_host(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return x.clone()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    if not host.is_pinned():
        raise RuntimeError("could not pin host memory for the offloaded cache")
    host.copy_(x)
    return host


def offload_kv_cache(cache, decode_headroom: int) -> OffloadedKVCache:
    """Move a prefill ``KVCache``'s K/V to host memory and attach a ring of
    ``decode_headroom`` slots on the cache's device.  The caller drops its
    reference to ``cache`` to free the device copy."""
    L, B, H, _, D = cache.k.shape
    ring = lambda: torch.zeros((L, B, H, decode_headroom, D), dtype=cache.k.dtype,  # noqa: E731
                               device=cache.k.device)
    return OffloadedKVCache(hk=_to_host(cache.k), hv=_to_host(cache.v), dk=ring(), dv=ring(),
                            prefill_len=cache.lengths.clone(), lengths=cache.lengths.clone(),
                            positions=cache.positions.clone())


class LayerPrefetch:
    """Each layer's host K/V on ``device`` for one decode step.  On a card,
    two buffer pairs alternate: :meth:`layer` ``(i)`` queues layer ``i + 1``'s
    copy on a side stream (after everything already queued on the current
    stream, so the buffer it fills is no longer read) and makes the current
    stream wait for layer ``i``'s copy.  On the CPU it returns the host
    tensors themselves.  ``bytes_copied`` adds up the bytes of every copy
    queued, as the kernel wrappers count their launches."""

    bytes_copied = 0

    def __init__(self, cache: OffloadedKVCache, device: torch.device):
        self.hk, self.hv = cache.hk, cache.hv
        self.device = device
        if device.type != "cuda":
            return
        self.stream = torch.cuda.Stream(device)
        shape = self.hk.shape[1:]
        self.bufs = [tuple(torch.empty(shape, dtype=self.hk.dtype, device=device)
                           for _ in range(2)) for _ in range(2)]
        self.ready = {}
        self._fetch(0)

    def _fetch(self, li: int) -> None:
        kb, vb = self.bufs[li % 2]
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            kb.copy_(self.hk[li], non_blocking=True)
            vb.copy_(self.hv[li], non_blocking=True)
            LayerPrefetch.bytes_copied += kb.nbytes + vb.nbytes
            self.ready[li] = torch.cuda.Event()
            self.ready[li].record(self.stream)

    def layer(self, li: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.device.type != "cuda":
            return self.hk[li], self.hv[li]
        if li + 1 < self.hk.shape[0]:
            self._fetch(li + 1)
        torch.cuda.current_stream(self.device).wait_event(self.ready.pop(li))
        return self.bufs[li % 2]


def offloaded_cache_from_jax(hk, hv, dk, dv, prefill_len, lengths, positions, device="cpu",
                             dtype=torch.float32) -> OffloadedKVCache:
    """The port's cache holding a JAX ``OffloadedKVCache``'s arrays (as
    numpy): the host K/V on the host (pinned beside a card), the rest on
    ``device``."""
    f = lambda a: torch.from_numpy(np.asarray(a).astype(np.float32)).to(dtype)  # noqa: E731
    i = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)  # noqa: E731
    dev = torch.device(device)
    host = (lambda t: t) if dev.type == "cpu" else (lambda t: t.pin_memory())
    return OffloadedKVCache(host(f(hk)), host(f(hv)), f(dk).to(dev), f(dv).to(dev),
                            i(prefill_len), i(lengths), i(positions))
