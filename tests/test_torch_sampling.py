"""Sampling in the port (``runtime/generate.py``) against the JAX package,
on the CPU.

* The masked logits' support (which entries stay finite) equals JAX's
  ``sample_token`` exactly over a grid of temperature / top-k / top-p, with
  ties planted at the k-th value and at the top-p cutoff; JAX's masked
  logits are what it hands ``jax.random.categorical``.
* With ``generate.gumbel_draw`` replaced by JAX's ``jax.random.gumbel``
  along JAX's key chain (``fold_in(rng, 7)``, then splits), the sampled
  streams equal JAX's ``generate``, with EOS and ``min_new_tokens > 1``.
* The port's own draws: a seeded chi-square test against the softmax of
  the masked logits; two runs from one seed bitwise equal; temperature
  1e-6 gives the greedy stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.runtime.generate import generate as jax_generate
from kvcache_factory_tpu.runtime.generate import sample_token as jax_sample_token
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.runtime import generate as tgenerate

MODEL = dict(model_type="llama", vocab_size=256, hidden_size=128, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=32,
             rope_theta=10000.0, dtype="float32")
COMP = dict(method="snapkv", max_capacity_prompt=48, window_size=8, kernel_size=7,
            pooling="maxpool", group_reduce="none")
S = 128


def planted_logits(V=64):
    """Rows of fp32 logits: random ones, one with a tie of three at the 5th
    largest value, one whose top-p cutoff (0.5 and 0.9) falls on a value
    held four times, and one flat row."""
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal(V).astype(np.float32) * 2 for _ in range(3)]
    tie_k = rng.standard_normal(V).astype(np.float32)
    order = np.argsort(-tie_k)
    tie_k[order[4:7]] = tie_k[order[4]]  # 5th, 6th, 7th largest equal
    # Cumulative mass 0.32 after one entry, then four equal entries (0.12
    # each) take it past 0.5 and 0.75; the rest is spread thin.
    tie_p = np.full(V, np.log(0.15 / (V - 5)), np.float32)
    tie_p[[7, 30, 2, 50]] = np.log(0.12)
    tie_p[11] = np.log(0.37)
    flat = np.zeros(V, np.float32)
    return np.stack(rows + [tie_k, tie_p, flat])


GRID = [(t, k, p) for t in (1.0, 0.7, 1e-6) for k in (0, 1, 5, 12) for p in (1.0, 0.9, 0.5)]


def jax_masked(logits, gen):
    """The logits JAX's ``sample_token`` hands ``jax.random.categorical``."""
    seen = []
    real = jax.random.categorical

    def capture(key, masked, axis=-1):
        seen.append(np.asarray(masked))
        return real(key, masked, axis=axis)
    jax.random.categorical = capture
    try:
        jax_sample_token(jnp.asarray(logits), gen, jax.random.PRNGKey(0))
    finally:
        jax.random.categorical = real
    return seen[0]


@pytest.mark.parametrize("temperature,top_k,top_p", GRID)
def test_masked_support_matches_jax(temperature, top_k, top_p):
    logits = planted_logits()
    kw = dict(do_sample=True, temperature=temperature, top_k=top_k, top_p=top_p)
    want = np.isfinite(jax_masked(logits, jcfg.GenerationConfig(**kw)))
    masked = tgenerate.mask_logits(torch.from_numpy(logits), tcfg.GenerationConfig(**kw))
    np.testing.assert_array_equal(torch.isfinite(masked).numpy(), want)
    if top_k == 5 and top_p == 1.0:
        assert want[3].sum() == 7  # the tie at the 5th value is kept whole
    if temperature == 1.0 and top_k == 0 and top_p == 0.5:
        assert want[4].sum() == 5  # the cutoff's four equal entries stay
    # Kept entries carry the tempered logits.
    np.testing.assert_allclose(masked.numpy()[want], (logits / max(temperature, 1e-6))[want],
                               rtol=1e-6)


@pytest.fixture(scope="module")
def setup():
    jc, tc = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"], size=n) for n in (110, 30)]
    toks = np.zeros((2, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, toks=toks, lens=lens,
                jcomp=jcfg.CompressionConfig(**COMP), tcomp=tcfg.CompressionConfig(**COMP))


def jax_noise(seed):
    """``gumbel_draw`` with JAX's noise: step 0 from ``k0`` of
    ``split(fold_in(PRNGKey(seed), 7))``, each later step from the next
    split of the running key, as JAX's ``generate`` draws."""
    sample_rng, k0 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 7))
    keys = [k0]

    def draw(rng, step, shape):
        nonlocal sample_rng
        while len(keys) <= step:
            sample_rng, k = jax.random.split(sample_rng)
            keys.append(k)
        return torch.from_numpy(np.array(jax.random.gumbel(keys[step], shape, jnp.float32)))
    return draw


CASES = [dict(temperature=0.7, top_k=20, top_p=0.9), dict(temperature=1.3),
         dict(top_p=0.6), dict(top_k=3)]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("eos,min_new", [(False, 1), (True, 1), (True, 6)])
def test_sampled_streams_match_jax_under_jax_noise(setup, monkeypatch, case, eos, min_new):
    s = setup
    max_new, seed = 10, 5
    cap = s["jcomp"].layer_capacity(2, S) + max_new + 1
    kw = dict(max_new_tokens=max_new, do_sample=True, min_new_tokens=min_new, **CASES[case])

    def run_jax(gen_kw):
        r = jax_generate(s["jp"], s["jc"], s["jcomp"], jcfg.GenerationConfig(**gen_kw),
                         jnp.asarray(s["toks"]), jnp.asarray(s["lens"]), cap,
                         rng=jax.random.PRNGKey(seed))
        return np.asarray(r.tokens), np.asarray(r.num_tokens)

    if eos:  # an id row 0 draws at step 3 when nothing stops it
        kw["eos_token_ids"] = (int(run_jax(dict(kw, min_new_tokens=1))[0][0, 3]),)
    jtoks, jnum = run_jax(kw)
    monkeypatch.setattr(tgenerate, "gumbel_draw", jax_noise(seed))
    tres = tgenerate.generate(s["tp"], s["tc"], s["tcomp"], tcfg.GenerationConfig(**kw),
                              s["toks"], s["lens"], cap, device="cpu")
    np.testing.assert_array_equal(tres.tokens.numpy(), jtoks)
    np.testing.assert_array_equal(tres.num_tokens.numpy(), jnum)
    if eos and min_new == 1:
        assert jnum[0] <= 4


def test_port_draws_follow_the_masked_softmax():
    """20000 draws of one planted row through ``sample_token`` with the
    port's own noise: chi-square against the masked softmax, at a level
    that a correct sampler fails once in 10^4 seeds (the seed is fixed)."""
    gen = tcfg.GenerationConfig(do_sample=True, temperature=0.8, top_k=12, top_p=0.95)
    row = torch.from_numpy(planted_logits()[0])
    masked = tgenerate.mask_logits(row, gen)
    p = torch.softmax(masked, dim=-1).numpy().astype(np.float64)
    support = np.isfinite(masked.numpy())
    n = 20000
    rng = torch.Generator().manual_seed(1234)
    noise = tgenerate.gumbel_draw(rng, 0, (n, row.shape[0]))
    draws = tgenerate.sample_token(row.expand(n, -1), gen, noise).numpy()
    assert support[draws].all()
    counts = np.bincount(draws, minlength=row.shape[0])[support]
    expected = n * p[support]
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < stats.chi2.ppf(1 - 1e-4, df=support.sum() - 1), (chi2, counts, expected)


def test_sampling_repeats_from_one_seed_and_tends_to_greedy(setup):
    s = setup
    cap = s["tcomp"].layer_capacity(2, S) + 11

    def run(seed, **kw):
        rng = None if seed is None else torch.Generator().manual_seed(seed)
        return tgenerate.generate(s["tp"], s["tc"], s["tcomp"],
                                  tcfg.GenerationConfig(max_new_tokens=10, **kw), s["toks"],
                                  s["lens"], cap, device="cpu", rng=rng).tokens
    kw = dict(do_sample=True, temperature=1.5)
    first = run(7, **kw)
    assert torch.equal(first, run(7, **kw))
    assert not torch.equal(first, run(8, **kw))
    assert torch.equal(run(7, do_sample=True, temperature=1e-6), run(None))
