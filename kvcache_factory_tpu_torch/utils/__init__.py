from .profiling import PhaseTimer, annotate, trace
from .viz import infer_attention, plot_attention_heatmap, plot_budget_allocation

__all__ = ["PhaseTimer", "annotate", "trace", "infer_attention",
           "plot_attention_heatmap", "plot_budget_allocation"]
