"""The port's sequence-parallel path (``ShardingConfig(sp=n)``: ring-attention
prefill over spawned gloo ranks, decode on every rank) against the JAX
package's sp engine and the port's single-device engine.

Models: ``tests/test_torch_generate.py``'s (2 layers, hidden 256, Hq 4,
Hkv 2, head_dim 128, vocab 512, fp32) and the same widths as a Mistral
with a 70-token sliding window, under which rank 3 of 4 skips its hop over
shard 0.  JAX weights are carried across with ``params_from_jax``; prompts
come from ``np.random.default_rng``: 200, 130 and 60 tokens on a 256-row
bucket, so the SnapKV window's q rows of the second straddle two ranks at
sp 2 and sp 4, and the last rows lie on different ranks.  Token streams
must be identical; the ranks' first-token logits bitwise equal; the
single-device engine's within 1e-4 (fp32 in another summation order, as
``tests/test_torch_generate.py`` holds the port to JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_worker
from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu.runtime import engine as jengine
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.models.weights import params_from_jax
from kvcache_factory_tpu_torch.policies.scoring import (window_attention_scores,
                                                        window_query_rows)
from kvcache_factory_tpu_torch.runtime import engine as tengine

MODEL = dict(model_type="llama", vocab_size=512, hidden_size=256,
             intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=128, rope_theta=10000.0, dtype="float32")
MODELS = {"dense": MODEL, "sw": dict(MODEL, model_type="mistral", sliding_window=70)}
COMP = dict(method="snapkv", max_capacity_prompt=64, window_size=8, kernel_size=7,
            pooling="maxpool", group_reduce="none")
BUCKETS = (256,)
MAX_NEW = 6
# The cases each rank count runs: (model, int8 cache).
CASES = {2: [("dense", None), ("sw", None), ("dense", 8)], 4: [("dense", None), ("sw", None)]}
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    jp = jweights.init_params(jcfg.ModelConfig(**MODEL), jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"], size=n).tolist() for n in (200, 130, 60)]
    return dict(jp=jp, np_params=np_params, tp=params_from_jax(np_params, device="cpu"),
                prompts=prompts)


def _port_cfg(model, nbits=None, sp=1, buckets=BUCKETS):
    return tcfg.EngineConfig(model=tcfg.ModelConfig(**MODELS[model]),
                             compression=tcfg.CompressionConfig(**COMP),
                             quant=None if nbits is None else tcfg.QuantConfig(nbits=nbits),
                             sharding=tcfg.ShardingConfig(sp=sp), prefill_buckets=buckets)


@pytest.fixture(scope="module")
def sp_runs(weights, tmp_path_factory):
    """One spawn of n gloo ranks per n, each running CASES[n]."""
    runs = {}

    def run(n):
        if n not in runs:
            payload = [dict(model=MODELS[m], comp=COMP, nbits=nbits,
                            params=weights["np_params"], prompts=weights["prompts"],
                            max_new=MAX_NEW, buckets=BUCKETS) for m, nbits in CASES[n]]
            runs[n] = torch_sp_worker.spawn(n, tmp_path_factory.mktemp(f"sp{n}"), "engine",
                                            payload)
        return runs[n]
    return run


@pytest.mark.parametrize("n,model", [(2, "dense"), (2, "sw"), (4, "dense"), (4, "sw")])
def test_sp_engine_matches_jax_sp_engine(weights, sp_runs, n, model):
    """Every rank's ids equal JAX ``InferenceEngine(ShardingConfig(sp=n))``'s
    (ring attention on n virtual CPU devices)."""
    jeng = jengine.InferenceEngine(weights["jp"], jcfg.EngineConfig(
        model=jcfg.ModelConfig(**MODELS[model]), compression=jcfg.CompressionConfig(**COMP),
        prefill_buckets=BUCKETS, sharding=jcfg.ShardingConfig(sp=n)))
    want = jeng.generate_batch(weights["prompts"], MAX_NEW)
    i = CASES[n].index((model, None))
    for rank in sp_runs(n):
        assert rank["ids"][i] == want


@pytest.mark.parametrize("n,i", [(n, i) for n in sorted(CASES) for i in range(len(CASES[n]))])
def test_sp_engine_matches_single_device(sp_runs, n, i):
    """The same ids and cache lengths as the port's single-device engine
    (the int8 case too: the JAX engine on the CPU takes its grouped quant
    cache, not the port's per-token one), first-token logits within fp32
    summation error, and every rank's logits and lengths bitwise equal.
    The single-device engine runs in the spawn's rank 0 after its sp runs
    (``torch_sp_worker._engine``), as the ranks run: in a fresh process of
    one thread with no JAX loaded, so nothing of this test process's state
    reaches either side."""
    ranks = sp_runs(n)
    ids, lengths, logits = ranks[0]["single"][i]
    for r, rank in enumerate(ranks):
        assert rank["ids"][i] == ids, f"rank {r}: ids {rank['ids'][i]}, single device {ids}"
        np.testing.assert_array_equal(rank["lengths"][i], lengths,
                                      err_msg=f"rank {r}: cache lengths")
        np.testing.assert_allclose(rank["first_logits"][i], logits, **LOGITS_TOL,
                                   err_msg=f"rank {r}: first-token logits")
        np.testing.assert_array_equal(rank["first_logits"][i], ranks[0]["first_logits"][i],
                                      err_msg=f"rank {r}: logits against rank 0's")


@pytest.mark.parametrize("n", sorted(CASES))
def test_sp_ranks_import_no_jax_and_check_the_group_size(sp_runs, n):
    """The spawned ranks loaded neither JAX nor the JAX package, and an
    engine whose sp differs from the group's size raised."""
    for rank in sp_runs(n):
        assert rank["banned_modules"] == []
        assert "needs a process group of" in rank["size_mismatch"]


@pytest.mark.parametrize("kw,error", [
    (dict(sp=2), None),
    (dict(sp=4, dcn_dp=1), None),
    (dict(sp=2, ep=2), ValueError),           # JAX: sp does not compose with ep
    (dict(sp=2, pp=2), ValueError),           # ... nor with pp
    (dict(sp=0), ValueError),
    (dict(dp=2), NotImplementedError),        # the rest of ROADMAP item 1.11
    (dict(sp=2, tp=2), NotImplementedError),
    (dict(dp=2, sp=2), NotImplementedError),
    (dict(pp=2, pp_microbatches=2), NotImplementedError),
])
def test_sharding_config_validation(kw, error):
    """sp alone is accepted; JAX's ValueErrors hold (and JAX raises them
    too); every other layout waits for ROADMAP item 1.11."""
    if error is None:
        assert tcfg.ShardingConfig(**kw).sp == kw["sp"]
        return
    with pytest.raises(error, match=None if error is ValueError else "item 1.11"):
        tcfg.ShardingConfig(**kw)
    if error is ValueError and kw.get("sp", 1) > 0:
        with pytest.raises(ValueError):
            jcfg.ShardingConfig(**kw)


def test_engine_checks_buckets_then_needs_a_process_group(weights):
    """A bucket that does not split over sp ranks raises ``ValueError`` as
    JAX's engine does (``runtime/engine.py:73-76``); a valid one then needs
    an initialized process group of sp ranks."""
    with pytest.raises(ValueError, match="not divisible by sp=8"):
        tengine.InferenceEngine(weights["tp"], _port_cfg("dense", sp=8, buckets=(96, 100)),
                                device="cpu")
    with pytest.raises(ValueError, match="initialized torch.distributed"):
        tengine.InferenceEngine(weights["tp"], _port_cfg("dense", sp=8, buckets=(96,)),
                                device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("true_len", [200, 130, 5])
def test_window_scores_from_the_window_rows_alone(true_len):
    """What sp prefill computes from the gathered window rows equals
    ``window_attention_scores`` over the whole q, a start clamped to 0
    (true_len under the window) included."""
    rng = np.random.default_rng(true_len)
    k = torch.from_numpy(rng.standard_normal((4, 256, 128)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, 256, 128)).astype(np.float32))
    tl = torch.tensor(true_len)
    rows = window_query_rows(tl, 8, 256)
    want = window_attention_scores(k, q, tl, 8)
    got = window_attention_scores(k, None, tl, 8, q_win=q[:, rows])
    assert torch.equal(got, want)
    assert rows[0] == max(true_len - 8, 0)

