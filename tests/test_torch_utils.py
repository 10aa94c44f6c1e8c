"""The port's profiling and visualization utilities
(``kvcache_factory_tpu_torch/utils``) against the JAX package's
(``kvcache_factory_tpu/utils``) on the CPU.

``infer_attention`` is held to JAX's on the same fp32 weights
(``params_from_jax``) within 1e-5 relative, plus 1e-3 absolute on the maps'
1e4 scale (1e-7 in probability, for entries near 0): both compute fp32
probabilities, which fp32 summation order moves by about 1e-6 relative
(7.8e-7 in probability at most on these models).  A row of a map sums to 1e4
within 1e-5 relative: 64 fp32 terms, 1.5e-3 absolute at most here.
"""

import torch_threads  # noqa: F401  (torch's thread share, first)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.utils import PhaseTimer as JPhaseTimer
from kvcache_factory_tpu.utils import infer_attention as j_infer_attention
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.utils import (PhaseTimer, annotate, infer_attention,
                                             plot_attention_heatmap, plot_budget_allocation,
                                             trace)

MAPS_TOL = dict(rtol=1e-5, atol=1e-3)
# The examples' tiny model (examples/visualization.py), and one with q/k/v
# biases (Qwen2's) and a sliding window shorter than the prompt.
MODELS = {
    "llama": dict(model_type="llama", vocab_size=256, hidden_size=128, intermediate_size=256,
                  num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
                  head_dim=16, dtype="float32"),
    "biases_window": dict(model_type="qwen2", vocab_size=256, hidden_size=128,
                          intermediate_size=256, num_hidden_layers=2, num_attention_heads=8,
                          num_key_value_heads=2, head_dim=16, sliding_window=24,
                          attention_bias=True, dtype="float32"),
}
PROMPT = 64


@pytest.fixture(scope="module", params=sorted(MODELS))
def viz_maps(request):
    kw = MODELS[request.param]
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jp = jweights.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    if kw.get("attention_bias"):
        qkv = jp["layers"]["qkv_proj"].shape[-1]
        jp["layers"]["qkv_bias"] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(4), (jc.num_hidden_layers, qkv), jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, size=PROMPT)
    return infer_attention(tp, tc, toks), j_infer_attention(jp, jc, toks), kw


def test_infer_attention_matches_jax(viz_maps):
    """One [Hq, S, S] map per layer, each within 1e-5 of JAX's; rows sum to
    1e4, nothing above the diagonal (nor, with a window, left of it)."""
    maps, j_maps, kw = viz_maps
    assert len(maps) == len(j_maps) == kw["num_hidden_layers"]
    rows = np.arange(PROMPT)
    hidden = rows[None] > rows[:, None]
    if kw.get("sliding_window"):
        hidden |= rows[None] <= rows[:, None] - kw["sliding_window"]
    for m, jm in zip(maps, j_maps):
        assert m.shape == (kw["num_attention_heads"], PROMPT, PROMPT) and m.dtype == np.float32
        np.testing.assert_allclose(m, np.asarray(jm), **MAPS_TOL)
        np.testing.assert_allclose(m.astype(np.float64).sum(-1), 1e4, rtol=1e-5)
        assert (m[:, hidden] == 0).all()


def test_plots_write_their_files(viz_maps, tmp_path):
    """Both plots write a PNG: a heatmap of the mean over heads and of one
    head, and the budget allocation from [L, B, H] lengths as numpy or as a
    tensor."""
    maps = viz_maps[0]
    paths = [plot_attention_heatmap(maps[0], save_path=str(tmp_path / "mean.png")),
             plot_attention_heatmap(maps[-1], head=1, save_path=str(tmp_path / "head.png"),
                                    log_scale=False),
             plot_budget_allocation(np.full((4, 2, 8), 64), save_path=str(tmp_path / "b.png")),
             plot_budget_allocation(torch.arange(32).reshape(4, 8),
                                    save_path=str(tmp_path / "t.png"))]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_phase_timer_summary_matches_jax(tmp_path):
    """The same recorded phases give JAX's summary (count, total_s, mean_s,
    tokens_per_s, rounded alike) and the same dump."""
    mine, theirs = PhaseTimer(), JPhaseTimer()
    for timer in (mine, theirs):
        timer.record("prefill", 0.123456789, num_tokens=4096)
        timer.record("prefill", 0.2)
        timer.record("decode", 0.01, num_tokens=2)
        timer.record("decode", 0.0123, num_tokens=2)
        timer.record("idle", 0.0)
    assert mine.summary() == theirs.summary()
    assert mine.dump(str(tmp_path / "t.json")) == theirs.dump()
    assert json.loads((tmp_path / "t.json").read_text()) == theirs.summary()


def test_phase_timer_times_a_phase_with_outputs():
    """``phase`` records a wall time per call and the tokens it is given;
    CPU tensors among the outputs need no synchronisation."""
    timer = PhaseTimer()
    for _ in range(2):
        out = []
        with timer.phase("step", outputs=out, num_tokens=3):
            out.append({"x": (torch.ones(4) * 2, [torch.zeros(1)])})
    s = timer.summary()["step"]
    assert s["count"] == 2 and s["total_s"] >= 0 and s["tokens_per_s"] > 0


def test_trace_writes_a_chrome_trace_naming_the_annotated_region(tmp_path):
    """``trace`` writes one Chrome trace into its directory; the regions of
    ``annotate`` are in it as host spans, with the ops run inside them."""
    with trace(str(tmp_path / "tr")):
        with annotate("prefill_region"):
            torch.randn(64, 64) @ torch.randn(64, 64)
        with annotate("decode_region"):
            torch.randn(8, 8).softmax(-1)
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"prefill_region", "decode_region"} <= set(spans)
    a = spans["prefill_region"]
    inside = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
              and a["ts"] <= e["ts"] <= a["ts"] + a["dur"]]
    assert any("mm" in n for n in inside), inside
