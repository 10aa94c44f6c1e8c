"""The port's model, generation loop and engine against the JAX package.

A 2-layer model (hidden 256, ffn 512, Hq 4, Hkv 2, head_dim 128, vocab
512) in fp32 on the CPU; the JAX weights are carried across with
``params_from_jax``, prompts come from ``np.random.default_rng``.  The port's
kernel wrappers run their plain versions here.  Tolerances: logits agree
to fp32 summation-order error, ~1e-6 on values of order 1, checked at
1e-4 (the error compounds over two layers and the 512-way lm_head sum);
token streams must be identical.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.runtime import engine as jengine
from kvcache_factory_tpu.runtime.generate import generate as jax_generate
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.models import chunked_prefill as tchunked
from kvcache_factory_tpu_torch.models import llama as tllama
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.runtime import batching as tbatching
from kvcache_factory_tpu_torch.runtime import engine as tengine
from kvcache_factory_tpu_torch.runtime import generate as tgenerate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(model_type="llama", vocab_size=512, hidden_size=256,
             intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=128, rope_theta=10000.0, dtype="float32")
COMP = dict(method="snapkv", max_capacity_prompt=64, window_size=8, kernel_size=7,
            pooling="maxpool", group_reduce="none")
S = 256  # prompt bucket
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"], size=n) for n in (200, 40)]
    toks = np.zeros((2, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, toks=toks, lens=lens,
                jcomp=jcfg.CompressionConfig(**COMP), tcomp=tcfg.CompressionConfig(**COMP))


def _prefill_both(s, cap):
    jres = jllama.prefill(s["jp"], s["jc"], s["jcomp"], jnp.asarray(s["toks"]),
                          jnp.asarray(s["lens"]), cap)
    tres = tllama.prefill(s["tp"], s["tc"], s["tcomp"], torch.tensor(s["toks"]),
                          torch.tensor(s["lens"]), cap)
    return jres, tres


def test_prefill_matches_jax(setup):
    """200 tokens are compressed to 64, 40 take the no-compress branch."""
    s = setup
    cap = s["jcomp"].layer_capacity(2, S) + 8 + 1
    jres, tres = _prefill_both(s, cap)
    np.testing.assert_allclose(tres.logits_last.numpy(), np.asarray(jres.logits_last),
                               **LOGITS_TOL)
    lens = np.asarray(jres.cache.lengths)
    np.testing.assert_array_equal(tres.cache.lengths.numpy(), lens)
    assert (lens[:, 0] == 64).all() and (lens[:, 1] == 40).all()
    np.testing.assert_array_equal(tres.cache.positions.numpy(), np.asarray(jres.cache.positions))
    assert tres.cache.k.shape == jres.cache.k.shape
    jk, jv = np.asarray(jres.cache.k), np.asarray(jres.cache.v)
    for li in range(2):
        for b in range(2):
            for h in range(lens.shape[2]):
                n = lens[li, b, h]
                np.testing.assert_allclose(tres.cache.k[li, b, h, :n].numpy(),
                                           jk[li, b, h, :n], rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(tres.cache.v[li, b, h, :n].numpy(),
                                           jv[li, b, h, :n], rtol=1e-5, atol=1e-5)


def test_teacher_forced_decode_matches_jax(setup):
    s = setup
    cap = s["jcomp"].layer_capacity(2, S) + 8 + 1
    jres, tres = _prefill_both(s, cap)
    jstep = jax.jit(lambda p, tok, c: jllama.decode_step(p, s["jc"], tok, c))
    jcache, tcache = jres.cache, tres.cache
    forced = np.random.default_rng(1).integers(0, MODEL["vocab_size"], size=(8, 2))
    for tok in forced:
        jlogits, jcache = jstep(s["jp"], jnp.asarray(tok, jnp.int32), jcache)
        tlogits, tcache = tllama.decode_step(s["tp"], s["tc"], torch.tensor(tok), tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **LOGITS_TOL)
    np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))
    np.testing.assert_array_equal(tcache.positions.numpy(), np.asarray(jcache.positions))


@pytest.mark.parametrize("eos_step,min_new", [(None, 1), (4, 1), (4, 8)])
def test_generate_matches_jax(setup, eos_step, min_new):
    """Greedy streams, with an EOS that row 0 emits at ``eos_step`` when
    unconstrained, and with EOS held back by ``min_new_tokens``."""
    s = setup
    max_new = 12
    cap = s["jcomp"].layer_capacity(2, S) + max_new + 1

    def run_jax(gen):
        r = jax_generate(s["jp"], s["jc"], s["jcomp"], gen, jnp.asarray(s["toks"]),
                               jnp.asarray(s["lens"]), cap)
        return np.asarray(r.tokens), np.asarray(r.num_tokens)

    eos = ()
    if eos_step is not None:
        free, _ = run_jax(jcfg.GenerationConfig(max_new_tokens=max_new))
        eos = (int(free[0, eos_step]),)
    jtoks, jnum = run_jax(jcfg.GenerationConfig(max_new_tokens=max_new, eos_token_ids=eos,
                                                min_new_tokens=min_new))
    tres = tgenerate.generate(s["tp"], s["tc"], s["tcomp"],
                              tcfg.GenerationConfig(max_new_tokens=max_new,
                                                    eos_token_ids=eos,
                                                    min_new_tokens=min_new),
                              s["toks"], s["lens"], cap, device="cpu")
    np.testing.assert_array_equal(tres.tokens.numpy(), jtoks)
    np.testing.assert_array_equal(tres.num_tokens.numpy(), jnum)
    if eos_step is not None and min_new == 1:
        assert jnum[0] == eos_step + 1  # the EOS itself counts


@pytest.mark.parametrize("lengths", [(200, 40, 130), (40,)])
def test_engine_generate_batch_matches_jax(setup, lengths):
    s = setup
    kw = dict(prefill_buckets=(128, 256))
    jeng = jengine.InferenceEngine(
        s["jp"], jcfg.EngineConfig(model=s["jc"], compression=s["jcomp"], **kw))
    teng = tengine.InferenceEngine(
        s["tp"], tcfg.EngineConfig(model=s["tc"], compression=s["tcomp"], **kw),
        device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, MODEL["vocab_size"], size=n).tolist() for n in lengths]
    want = jeng.generate_batch(prompts, 10)
    assert teng.generate_batch(prompts, 10) == want
    if len(prompts) == 1:
        assert teng.generate_ids(prompts[0], 10) == want[0]


@pytest.mark.parametrize("what", ["cache_prefix", "sparse_chunked", "sampling"])
def test_unported_paths_raise(setup, what):
    """Prefix caching waits for its ROADMAP item, and chunked prefill
    refuses MInference's sparse masks, as the JAX package does
    (sliding-window models run: ``tests/test_torch_sliding_window.py``).
    Sampling is ported: its case now holds that the refusal is gone and
    that temperature 1e-6 gives the greedy stream (parity with JAX in
    ``tests/test_torch_sampling.py``).  The grouped quantized cache is
    ported: ``tests/test_torch_grouped_quant.py``."""
    s = setup
    if what == "sampling":
        args = (s["tp"], s["tc"], s["tcomp"])
        greedy = tgenerate.generate(*args, tcfg.GenerationConfig(max_new_tokens=6),
                                    s["toks"], s["lens"], 80, device="cpu")
        sampled = tgenerate.generate(*args, tcfg.GenerationConfig(
            max_new_tokens=6, do_sample=True, temperature=1e-6), s["toks"], s["lens"], 80,
            device="cpu", rng=torch.Generator().manual_seed(3))
        assert torch.equal(sampled.tokens, greedy.tokens)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "cache_prefix":
            eng = tbatching.ContinuousBatchingEngine(
                s["tp"], tcfg.EngineConfig(model=s["tc"], compression=s["tcomp"]),
                prefill_chunk_tokens=128, device="cpu")
            eng.cache_prefix([1, 2, 3])
        else:
            comp = tcfg.CompressionConfig(method="minference", sparse_prefill=("ashape", 1, 1, 4))
            tchunked.prefill_chunked(s["tp"], s["tc"], comp, torch.tensor(s["toks"]),
                                     torch.tensor(s["lens"]), 80, chunk_size=64)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port (the serving, loading, cache, checkpoint
    and eval modules named below among them), and chip_smoke.py, import
    without pulling in jax or kvcache_factory_tpu, nor ml_dtypes,
    transformers, orbax or safetensors (the CLI imports transformers'
    tokenizer only when it builds an engine).  An import hook refuses those names, so an import fails even
    where something else loaded one of them first."""
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "BANNED = ('jax', 'jaxlib', 'kvcache_factory_tpu', 'ml_dtypes', 'transformers',\n"
        "          'safetensors', 'orbax')\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BANNED:\n"
        "            raise ImportError(f'the port imported {name}')\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "before = set(sys.modules)\n"
        "import kvcache_factory_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in set(sys.modules) - before if m.split('.')[0] in BANNED]\n"
        "assert not bad, bad\n"
        "for m in ('models.chunked_prefill', 'runtime.native', 'runtime.batching',\n"
        "          'models.weights', 'evals.cli_common', 'evals.longbench', 'evals.ruler',\n"
        "          'evals.needle', 'evals.needle_viz', 'evals.metrics', 'evals.score',\n"
        "          'cache.quant_cache', 'cache.kv_cache', 'cache.think_cache',\n"
        "          'cache.offload_cache', 'cache.ssm_cache', 'cache.encdec_cache',\n"
        "          'runtime.checkpoint', 'policies.think'):\n"
        "    assert 'kvcache_factory_tpu_torch.' + m in sys.modules, m\n"
        "print(sum(m.startswith('kvcache_factory_tpu_torch') for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 36  # the whole package was imported
