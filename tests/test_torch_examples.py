"""The port's examples (``examples/serving_torch.py``,
``examples/visualization_torch.py``) and eval wrappers
(``scripts/**/*_torch.sh``) on the CPU: the examples run to their end, the
wrappers call only the port's modules with flags their parsers take, and
neither the examples nor ``kvcache_factory_tpu_torch.utils`` load JAX."""

import torch_threads  # noqa: F401  (torch's thread share, first)
import argparse
import contextlib
import importlib
import importlib.util
import os
import re
import shlex
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest

REPO = Path(__file__).resolve().parents[1]
WRAPPERS = sorted(str(p.relative_to(REPO)) for p in REPO.glob("scripts/**/*_torch.sh"))


def _example(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def serving():
    return _example("serving_torch")


@pytest.mark.parametrize("flags", [
    pytest.param([], id="defaults"),
    pytest.param(["--prefill_chunk", "128", "--system_prompt_tokens", "64"], id="chunked-64"),
    pytest.param(["--prefill_chunk", "128", "--system_prompt_tokens", "160"], id="chunked-160"),
])
def test_serving_example_finishes_every_request(serving, flags):
    """At its defaults (a tiny random Llama, 10 requests, 4 slots, 24 new
    tokens) and with chunked admission under a shared system prompt, every
    request comes back with its tokens; a prompt longer than a chunk is
    resumed from its snapshot by later admissions."""
    engine, outputs = serving.main(["--device", "cpu", *flags])
    _, args = serving.parse_args(flags)
    assert len(outputs) == args.n_requests
    assert all(len(v) == args.max_new for v in outputs.values())
    assert engine.scheduler.stats()["completed"] == args.n_requests
    if args.prefill_chunk:
        assert engine.prefill_chunks_executed > 0
        assert (engine.prefix_resumes > 0) == (args.system_prompt_tokens >= args.prefill_chunk)


def test_visualization_example_writes_four_pngs(tmp_path):
    """Three layers' heatmaps and the budget allocation."""
    written = _example("visualization_torch").main(["--device", "cpu", "--out_dir",
                                                    str(tmp_path)])
    assert sorted(os.path.basename(p) for p in written) == [
        "attn_layer0.png", "attn_layer2.png", "attn_layer3.png", "budgets.png"]
    for p in written:
        assert (tmp_path / os.path.basename(p)).read_bytes()[:4] == b"\x89PNG"


def _commands(script):
    """The ``python -m`` commands of a wrapper (continuation lines joined,
    every shell expansion replaced by ``1``) and the other scripts it runs."""
    text = (REPO / script).read_text().replace("\\\n", " ")
    text = re.sub(r"\$\([^)]*\)", "1", text)
    text = re.sub(r"\$\{[^}]*\}|\$[A-Za-z_][A-Za-z_0-9]*", "1", text)
    commands, scripts = [], []
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if "python -m " in line:
            words = shlex.split(line[line.index("python -m "):])
            cut = next((i for i, w in enumerate(words) if w in ("|", ")", ";")), len(words))
            commands.append((words[2], words[3:cut]))
        scripts += re.findall(r"scripts/\S+\.sh", line)
    return commands, scripts


class _Parsed(Exception):
    pass


@contextlib.contextmanager
def _parse_only():
    """``ArgumentParser.parse_args`` parses, then stops the caller."""
    parse = argparse.ArgumentParser.parse_args

    def parse_and_stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))
    with mock.patch.object(argparse.ArgumentParser, "parse_args", parse_and_stop):
        yield


@pytest.mark.parametrize("script", WRAPPERS)
def test_wrapper_calls_only_the_port_with_flags_it_takes(script):
    """``bash -n`` passes; every ``python -m`` is a module of the port and
    its flags parse with that module's own parser; every script it runs is
    a ``*_torch.sh`` wrapper."""
    subprocess.run(["bash", "-n", str(REPO / script)], check=True)
    commands, scripts = _commands(script)
    assert commands or scripts
    assert all(s.endswith("_torch.sh") and (REPO / s).exists() for s in scripts), scripts
    for module, argv in commands:
        assert module.startswith("kvcache_factory_tpu_torch."), module
        with _parse_only(), pytest.raises(_Parsed) as parsed:
            importlib.import_module(module).main(argv)
        assert isinstance(parsed.value.args[0], argparse.Namespace)


def test_every_jax_wrapper_has_its_port_twin():
    """Eight JAX wrappers, eight port wrappers, by name."""
    jax_wrappers = [str(p.relative_to(REPO)) for p in REPO.glob("scripts/**/*.sh")
                    if not p.name.endswith("_torch.sh")]
    assert sorted(w[:-3] + "_torch.sh" for w in jax_wrappers) == WRAPPERS
    assert len(WRAPPERS) == 8


def test_examples_and_utils_load_no_jax(tmp_path):
    """In a fresh interpreter whose import hook refuses jax and the JAX
    package: ``kvcache_factory_tpu_torch.utils`` imports and both examples
    run on the CPU."""
    code = (
        "import importlib.abc, importlib.util, sys\n"
        "BANNED = ('jax', 'jaxlib', 'kvcache_factory_tpu')\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BANNED:\n"
        "            raise ImportError(f'imported {name}')\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "before = set(sys.modules)\n"
        "import kvcache_factory_tpu_torch.utils\n"
        "def run(name, argv):\n"
        "    spec = importlib.util.spec_from_file_location(name, f'examples/{name}.py')\n"
        "    m = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(m)\n"
        "    return m.main(argv)\n"
        "run('serving_torch', ['--device', 'cpu', '--n_requests', '2', '--max_new', '4'])\n"
        f"run('visualization_torch', ['--device', 'cpu', '--prompt_len', '32', '--out_dir', "
        f"{str(tmp_path)!r}])\n"
        "bad = [m for m in set(sys.modules) - before if m.split('.')[0] in BANNED]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")
