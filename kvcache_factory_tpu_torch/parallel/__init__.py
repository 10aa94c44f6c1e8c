"""Sequence parallelism: a process group over the ranks that share one
prompt (``mesh.py``) and ring attention over it (``ring_attention.py``)."""
