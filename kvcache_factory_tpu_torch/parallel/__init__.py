"""The parallel layer: the ``(dp, sp|ep, tp)`` grid of process groups, the
staged collectives and point-to-point exchanges, and the Megatron-style and
expert parameter shards (``mesh.py``), ring attention over the sp ranks
(``ring_attention.py``), and the GPipe pipeline over pp stages
(``pipeline.py``)."""
