"""The parallel layer: the ``(dp, sp, tp)`` grid of process groups, the
staged collectives and the Megatron-style parameter shards (``mesh.py``),
and ring attention over the sp ranks (``ring_attention.py``)."""
