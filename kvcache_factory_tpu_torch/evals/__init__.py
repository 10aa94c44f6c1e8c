"""The evaluation harness (port of ``kvcache_factory_tpu/evals``): the
LongBench, RULER and Needle runners over the port's ``InferenceEngine``,
their metrics and the scoring CLI."""

from . import metrics, score
from .longbench import DATASETS as LONGBENCH_DATASETS
from .ruler import TASKS as RULER_TASKS

__all__ = ["metrics", "score", "LONGBENCH_DATASETS", "RULER_TASKS"]
