"""The port's evaluation harness (``kvcache_factory_tpu_torch/evals``)
against the JAX package's, on the CPU.

Metrics and the scorer equal JAX's on shared inputs.  ``run_dataset``,
``run_task`` and ``NeedleHaystackTester`` write output files equal line
for line to JAX's (the needle's two timing fields aside), each side on a
tiny fp32 engine with the same weights and ``tests/toy_tokenizer.py``, as
``tests/test_evals.py`` drives JAX's.  The CLI resolves its arguments as
JAX's does, refuses an unported flag before it loads anything, and runs a
tiny saved checkpoint end to end (``python -m ...evals.longbench``'s
``main``) with a word-level tokenizer saved beside it.
"""

import torch_threads  # noqa: F401  (torch's thread share, first)
import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.evals import cli_common as jcli
from kvcache_factory_tpu.evals import longbench as jlongbench
from kvcache_factory_tpu.evals import metrics as jmetrics
from kvcache_factory_tpu.evals import needle as jneedle
from kvcache_factory_tpu.evals import ruler as jruler
from kvcache_factory_tpu.evals import score as jscore
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.runtime import engine as jengine
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.evals import cli_common as tcli
from kvcache_factory_tpu_torch.evals import longbench as tlongbench
from kvcache_factory_tpu_torch.evals import metrics as tmetrics
from kvcache_factory_tpu_torch.evals import needle as tneedle
from kvcache_factory_tpu_torch.evals import needle_viz as tviz
from kvcache_factory_tpu_torch.evals import ruler as truler
from kvcache_factory_tpu_torch.evals import score as tscore
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.runtime import engine as tengine

from toy_tokenizer import ToyTokenizer

MODEL = dict(model_type="llama", vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             max_position_embeddings=512, dtype="float32")
COMP = dict(method="snapkv", max_capacity_prompt=32, window_size=8, kernel_size=7,
            pooling="maxpool")
BUCKETS = (64, 128, 256)


@pytest.fixture(scope="module")
def engines():
    jc = jcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    je = jengine.InferenceEngine(jp, jcfg.EngineConfig(
        model=jc, compression=jcfg.CompressionConfig(**COMP), prefill_buckets=BUCKETS))
    te = tengine.InferenceEngine(
        params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
        tcfg.EngineConfig(model=tcfg.ModelConfig(**MODEL),
                          compression=tcfg.CompressionConfig(**COMP),
                          prefill_buckets=BUCKETS), device="cpu")
    return je, te


# ---------------------------------------------------------------------------
# Metrics and scoring
# ---------------------------------------------------------------------------

PAIRS = [("The answer is Paris", "paris"), ("a banana", "banana"), ("", "x"),
         ("there are 7 paragraphs, yes 7", "7"), ("paragraphs 3 and 12", "Paragraph 12"),
         ("# comment\nreturn x + 1", "return x + 1"), ("the cat sat on the mat", "the cat sat"),
         ("sports politics", "sports")]
METRICS = ["qa_f1_score", "rouge_score", "count_score", "retrieval_score", "code_sim_score",
           "classification_score"]


@pytest.mark.parametrize("name", METRICS)
def test_metrics_match_jax(name):
    classes = ["sports", "politics", "sport", "sports news"]
    for pred, gt in PAIRS:
        if name == "retrieval_score" and "Paragraph" not in gt:
            continue
        got = getattr(tmetrics, name)(pred, gt, all_classes=classes)
        assert got == getattr(jmetrics, name)(pred, gt, all_classes=classes), (pred, gt)
    assert tmetrics.normalize_answer("The, A cat!") == jmetrics.normalize_answer("The, A cat!")
    refs = [["bar", "foo"], ["z"], ["a", "b", "c"]]
    preds = ["foo BAR baz", "q", "a c"]
    assert tmetrics.string_match_all(preds, refs) == jmetrics.string_match_all(preds, refs)
    assert sorted(tmetrics.DATASET_METRICS) == sorted(jmetrics.DATASET_METRICS)


def _fake_results(root):
    for dataset, rows in {"qasper": [("answer0", ["answer0"]), ("x y", ["y z"])],
                          "trec": [("sports\nmore", ["sports"])],
                          "passage_count": [("3 or 4", ["4"])]}.items():
        d = root / dataset
        d.mkdir(parents=True)
        for method, bad in (("FullKV", False), ("snapkv", True)):
            with open(d / f"{method}.json", "w") as f:
                for pred, ans in rows:
                    f.write(json.dumps({"pred": "wrong" if bad else pred, "answers": ans,
                                        "all_classes": ["sports", "politics"],
                                        "length": 5000}) + "\n")
                f.write("{truncated\n")


@pytest.mark.parametrize("suite,longbench_e", [("longbench", False), ("longbench", True),
                                               ("ruler", False)])
def test_score_results_dir_matches_jax(tmp_path, suite, longbench_e):
    _fake_results(tmp_path / "t")
    _fake_results(tmp_path / "j")
    got = tscore.score_results_dir(str(tmp_path / "t"), suite, longbench_e)
    want = jscore.score_results_dir(str(tmp_path / "j"), suite, longbench_e)
    assert json.dumps(got) == json.dumps(want)
    assert (tmp_path / "t" / "results.csv").read_text() == \
        (tmp_path / "j" / "results.csv").read_text()


# ---------------------------------------------------------------------------
# The runners
# ---------------------------------------------------------------------------


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def test_run_dataset_matches_jax(engines, tmp_path):
    je, te = engines
    tok = ToyTokenizer()
    data = tmp_path / "qasper.jsonl"
    with open(data, "w") as f:
        for i in range(3):
            f.write(json.dumps({"input": f"what is item {i}?",
                                "context": " ".join(f"word{j % 37} w{j % 90}"
                                                    for j in range(60 + 40 * i)),
                                "answers": [f"answer{i}"], "length": 200, "dataset": "qasper",
                                "language": "en", "all_classes": None, "_id": f"id{i}"}) + "\n")
    outs = {}
    for side, eng, mod in (("jax", je, jlongbench), ("port", te, tlongbench)):
        outs[side] = tmp_path / side / "qasper" / "snapkv.json"
        n = mod.run_dataset(eng, tok, "qasper", str(data), str(outs[side]), model_max=200,
                            max_num_examples=3, progress=False)
        assert n == 3
    assert _lines(outs["port"]) == _lines(outs["jax"])
    assert [json.loads(x)["_id"] for x in _lines(outs["port"])] == ["id0", "id1", "id2"]


def test_run_task_matches_jax(engines, tmp_path):
    je, te = engines
    tok = ToyTokenizer()
    data = tmp_path / "niah_single_1.jsonl"
    with open(data, "w") as f:
        for i in range(2):
            f.write(json.dumps({"index": i, "input": " ".join(f"t{j}" for j in range(150 + i)),
                                "outputs": ["magic"], "length": 150}) + "\n")
    outs = {}
    for side, eng, mod in (("jax", je, jruler), ("port", te, truler)):
        outs[side] = tmp_path / side / "niah_single_1" / "FullKV.json"
        assert mod.run_task(eng, tok, "niah_single_1", str(data), str(outs[side]),
                            model_max=250, progress=False) == 2
    assert _lines(outs["port"]) == _lines(outs["jax"])


def test_needle_tester_matches_jax(engines, tmp_path):
    je, te = engines
    hay = tmp_path / "essays"
    hay.mkdir()
    (hay / "essay1.txt").write_text(" ".join(f"w{i % 100} word. " for i in range(700)))
    results = {}
    for side, eng, mod in (("jax", je, jneedle), ("port", te, tneedle)):
        tester = mod.NeedleHaystackTester(
            eng, ToyTokenizer(), str(hay), str(tmp_path / side),
            context_lengths=[230, 300], depth_percents=[0, 50, 100], model_version="tiny",
            print_status=False)
        results[side] = tester.run()
        assert len(results[side]) == 6
        assert tester.run() == []  # resumed: every cell exists
    timing = ("test_duration_seconds", "test_timestamp_utc")
    strip = [{k: v for k, v in r.items() if k not in timing} for r in results["port"]]
    assert strip == [{k: v for k, v in r.items() if k not in timing} for r in results["jax"]]
    folder = tmp_path / "port" / "results" / "tiny"
    assert len(os.listdir(folder)) == 6
    for name in os.listdir(folder):
        got = json.loads((folder / name).read_text())
        want = json.loads((tmp_path / "jax" / "results" / "tiny" / name).read_text())
        assert {k: v for k, v in got.items() if k not in timing} == \
            {k: v for k, v in want.items() if k not in timing}


def test_needle_viz_scores(tmp_path):
    from kvcache_factory_tpu.evals import needle_viz as jviz
    d = tmp_path / "res"
    d.mkdir()
    for i, resp in enumerate(["eat a sandwich and sit in dolores park on a sunny day.",
                              "eat a sandwich", ""]):
        (d / f"{i}.json").write_text(json.dumps({"depth_percent": 50 * i,
                                                 "context_length": 1000,
                                                 "model_response": resp}))
    assert sorted(map(str, tviz.load_scores(str(d)))) == sorted(map(str, jviz.load_scores(str(d))))
    assert tviz.overall_score(str(d)) == jviz.overall_score(str(d))
    assert max(r["Score"] for r in tviz.load_scores(str(d))) == 1.0


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

ARGV = [[], ["--method", "snapkv", "--max_capacity_prompts", "128"],
        ["--method", "streamingllm", "--max_capacity_prompts", "256"],
        ["--method", "pyramidkv", "--max_capacity_prompts_ratio", "0.25"],
        ["--method", "minference"], ["--method", "adakv", "--floor", "0.3", "--merge", "pivot"],
        ["--method", "think", "--pruning_ratio", "0.5", "--group_reduce", "mean"]]


def _parse(mod, argv):
    ap = argparse.ArgumentParser()
    mod.add_engine_args(ap)
    return ap.parse_args(["--model_path", "m"] + argv)


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: "_".join(a) or "defaults")
def test_cli_argument_resolution_matches_jax(argv):
    targs, jargs = _parse(tcli, argv), _parse(jcli, argv)
    assert tcli.resolve_capacity(targs) == jcli.resolve_capacity(jargs)
    assert vars(tcli.compression_from_args(targs)) == vars(jcli.compression_from_args(jargs))
    assert targs.device == "cuda" and targs.seed == jargs.seed
    with pytest.raises(ValueError, match="headkv"):
        tcli.resolve_capacity(_parse(tcli, ["--method", "headkv",
                                            "--max_capacity_prompts_ratio", "0.5"]))


def _tiny_checkpoint(path, mixtral=False, **widths):
    """A tiny Llama (or, with ``mixtral``, a 4-expert Mixtral) checkpoint in
    the HF layout (``widths`` override its config) and a word-level
    tokenizer over ``w0 .. w99`` saved beside it."""
    import transformers as tf
    from tokenizers import Tokenizer, models, pre_tokenizers
    import torch
    torch.manual_seed(0)
    widths = {**dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512),
              **widths}
    model = (tf.MixtralForCausalLM(tf.MixtralConfig(num_local_experts=4, num_experts_per_tok=2,
                                                    **widths))
             if mixtral else tf.LlamaForCausalLM(tf.LlamaConfig(**widths)))
    model.save_pretrained(path)
    vocab = {"<unk>": 0, "</s>": 1, **{f"w{i}": i + 2 for i in range(100)}}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tf.PreTrainedTokenizerFast(tokenizer_object=tk, unk_token="<unk>",
                               eos_token="</s>").save_pretrained(path)


@pytest.mark.parametrize("flags,error,match", [
    (["--dp", "2"], ValueError, "torchrun --nproc-per-node 2"),
    (["--tp", "2"], ValueError, "torchrun --nproc-per-node 2"),
    (["--dp", "2", "--sp", "2", "--tp", "2"], ValueError, "torchrun --nproc-per-node 8"),
    (["--pp", "2"], ValueError, "torchrun --nproc-per-node 2"),
    (["--ep", "2"], ValueError, "torchrun --nproc-per-node 2"),
    (["--dp", "2", "--dcn_dp", "2"], ValueError, "torchrun --nproc-per-node 2")])
def test_cli_refuses_unported_flags_before_loading(tmp_path, flags, error, match):
    """Before anything is loaded: ``--dp``/``--tp``/``--sp``, ``--pp``,
    ``--ep`` and ``--dp`` with ``--dcn_dp`` outside a torchrun launch of
    their size raise ``ValueError`` saying how to launch."""
    (tmp_path / "config.json").write_text(json.dumps(dict(
        model_type="llama", vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)))
    args = _parse(tcli, flags)
    args.model_path = str(tmp_path)  # no weights, no tokenizer: nothing may be loaded
    with pytest.raises(error, match=match):
        tcli.build_engine_from_args(args)


# Rank 0 of a torchrun launch: the LongBench CLI once per argument list
# in ``sys.argv[1]`` (JSON), every checkpoint loaded in fp32.
_TORCHRUN_CLI = """import dataclasses, json, sys
import torch
from kvcache_factory_tpu_torch.evals import cli_common, longbench
from kvcache_factory_tpu_torch.models import weights

def load(path, cfg, device):
    return weights.load_params(path, dataclasses.replace(cfg, dtype="float32"),
                               dtype=torch.float32, device=device)

cli_common.load_params = load
for argv in json.load(open(sys.argv[1])):
    longbench.main(argv)
"""
LAYOUTS = {"pp": ["--pp", "2", "--pp_microbatches", "2"], "ep": ["--ep", "2"],
           "dcn_dp": ["--dp", "2", "--dcn_dp", "2"], "sp_h2o": ["--sp", "2", "--method", "h2o"]}


def _layout_argv(root, layout):
    flags = LAYOUTS[layout]
    method = flags[flags.index("--method") + 1] if "--method" in flags else "snapkv"
    ckpt = root / ("tiny-mixtral" if layout == "ep" else "tiny-llama")
    return method, ["--model_path", str(ckpt), "--data_dir", str(root / "data"), "--datasets",
                    "hotpotqa", "--max_capacity_prompts", "64", "--prefill_buckets", "128",
                    "256", "--device", "cpu", "--method", method]


@pytest.fixture(scope="module")
def torchrun_layouts(tmp_path_factory):
    """One ``torchrun --nproc-per-node 2`` launch (gloo on the CPU) running
    the CLI under each layout of ``LAYOUTS``, on a tiny Llama and a tiny
    4-expert Mixtral; returns the directory of their result files."""
    import subprocess
    import sys

    root = tmp_path_factory.mktemp("torchrun")
    _tiny_checkpoint(root / "tiny-llama")
    _tiny_checkpoint(root / "tiny-mixtral", mixtral=True)
    (root / "data").mkdir()
    with open(root / "data" / "hotpotqa.jsonl", "w") as f:
        for i in range(2):
            f.write(json.dumps({"input": f"w{i} w{i + 1}", "context": " ".join(
                f"w{(7 * j + i) % 100}" for j in range(90)), "answers": [f"w{i}"],
                "length": 92, "all_classes": None, "_id": str(i)}) + "\n")
    runs = [_layout_argv(root, layout)[1] + LAYOUTS[layout]
            + ["--save_dir", str(root / layout)] for layout in LAYOUTS]
    (root / "argv.json").write_text(json.dumps(runs))
    (root / "cli.py").write_text(_TORCHRUN_CLI)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    done = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "2", str(root / "cli.py"), str(root / "argv.json")],
                          env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return root


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cli_runs_each_layout_under_torchrun(torchrun_layouts, monkeypatch, layout):
    """Under ``torchrun`` the LongBench CLI runs pp, ep (a tiny Mixtral),
    dcn_dp on one host and an sp method (h2o), and rank 0's file equals
    the single-device CLI's line for line.  Both load the checkpoint in
    fp32 (bf16 products would round otherwise on each layout and flip
    greedy near-ties)."""
    import dataclasses

    from kvcache_factory_tpu_torch.models import weights as tweights

    def tload(path, cfg, device):
        return tweights.load_params(path, dataclasses.replace(cfg, dtype="float32"),
                                    dtype=torch.float32, device=device)

    monkeypatch.setattr(tcli, "load_params", tload)
    root = torchrun_layouts
    method, argv = _layout_argv(root, layout)
    tlongbench.main(argv + ["--save_dir", str(root / f"{layout}_single")])
    name = "tiny-mixtral_64" if layout == "ep" else "tiny-llama_64"
    rel = os.path.join(name, "hotpotqa", f"{method}.json")
    got, want = _lines(root / layout / rel), _lines(root / f"{layout}_single" / rel)
    assert len(got) == 2 and got == want


def test_longbench_cli_end_to_end(tmp_path):
    ckpt = tmp_path / "tiny-llama"
    _tiny_checkpoint(ckpt)
    data = tmp_path / "data"
    data.mkdir()
    with open(data / "hotpotqa.jsonl", "w") as f:
        for i in range(2):
            f.write(json.dumps({"input": f"w{i} w{i + 1}", "context": " ".join(
                f"w{j % 100}" for j in range(90)), "answers": [f"w{i}"], "length": 92,
                "all_classes": None, "_id": str(i)}) + "\n")
    out = tmp_path / "out"
    for extra in ([], ["--wq8"]):
        tlongbench.main(["--model_path", str(ckpt), "--save_dir", str(out / str(len(extra))),
                         "--data_dir", str(data), "--datasets", "hotpotqa", "--method",
                         "snapkv", "--max_capacity_prompts", "64", "--device", "cpu",
                         "--prefill_buckets", "128", "256"] + extra)
        path = out / str(len(extra)) / "tiny-llama_64" / "hotpotqa" / "snapkv.json"
        recs = [json.loads(x) for x in _lines(path)]
        assert [r["_id"] for r in recs] == ["0", "1"]
        assert all(isinstance(r["pred"], str) for r in recs)
    rows = tscore.score_results_dir(str(out / "0" / "tiny-llama_64"))
    assert rows[3][0] == "SnapKV" and rows[3][rows[0].index("hotpotqa")] != -1


@pytest.mark.parametrize("flags,widths", [
    (["--method", "snapkv", "--quant_method", "kvquant", "--nbits", "2", "--residual_length",
      "8"], dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1)),
    (["--method", "think", "--think_packed"], {})], ids=["kvquant_nbits2_ring8", "think_packed"])
def test_cli_reaches_the_new_caches_as_jax_does(tmp_path, monkeypatch, flags, widths):
    """The flags the CLI once refused build the grouped quantized cache
    (head_dim 64 here: the default ``q_group_size`` is 64) and ThinK's packed
    cache, and the runner's file equals the JAX CLI's line for line.  Both
    CLIs load the checkpoint in bf16; bf16 products round differently in
    XLA and torch on the CPU and flip greedy near-ties, so here each loader
    is made to load fp32 weights into an fp32 model."""
    import dataclasses

    from kvcache_factory_tpu_torch.cache.quant_cache import QuantizedKVCache
    from kvcache_factory_tpu_torch.cache.think_cache import ThinKCache
    from kvcache_factory_tpu_torch.models import weights as tweights

    def jload(path):
        cfg = dataclasses.replace(jcfg.ModelConfig.from_json(os.path.join(path, "config.json")),
                                  dtype="float32")
        return jweights.load_params(path, cfg, dtype=jnp.float32)

    def tload(path, cfg, device):
        return tweights.load_params(path, dataclasses.replace(cfg, dtype="float32"),
                                    dtype=torch.float32, device=device)

    monkeypatch.setattr(jcli, "load_params", jload)
    monkeypatch.setattr(tcli, "load_params", tload)

    ckpt = tmp_path / "tiny-llama"
    _tiny_checkpoint(ckpt, **widths)
    data = tmp_path / "data"
    data.mkdir()
    with open(data / "hotpotqa.jsonl", "w") as f:
        for i in range(2):
            f.write(json.dumps({"input": f"w{i} w{i + 1}", "context": " ".join(
                f"w{(7 * j + i) % 100}" for j in range(90)), "answers": [f"w{i}"],
                "length": 92, "all_classes": None, "_id": str(i)}) + "\n")
    argv = ["--model_path", str(ckpt), "--data_dir", str(data), "--datasets", "hotpotqa",
            "--max_capacity_prompts", "64", "--prefill_buckets", "128", "256"] + flags
    ap = argparse.ArgumentParser()
    tcli.add_engine_args(ap)
    engine, _, _ = tcli.build_engine_from_args(
        ap.parse_known_args(argv + ["--device", "cpu"])[0])
    ids, res = engine.generate_batch([[5] * 100], 2, return_result=True)
    assert isinstance(res.cache, QuantizedKVCache if "--nbits" in flags else ThinKCache)
    tlongbench.main(argv + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    jlongbench.main(argv + ["--save_dir", str(tmp_path / "jax")])
    method = flags[1]
    rel = os.path.join("tiny-llama_64", "hotpotqa", f"{method}.json")
    got, want = _lines(tmp_path / "port" / rel), _lines(tmp_path / "jax" / rel)
    assert len(got) == 2 and got == want
