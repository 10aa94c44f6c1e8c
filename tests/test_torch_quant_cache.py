"""The port's per-token int8/int4 caches against the JAX package's.

Inputs come from ``np.random.default_rng``; both sides quantize in fp32 on
the CPU.  Codes are compared value for value: they may differ only at an
exact tie of ``(x - min) / scale`` halfway between two codes, where one
library's last-ulp quotient can land on either side; the tests count such
ties and state the count.  Scales and zeros are the same fp32 operations
and must agree exactly, and so must every dequantized value built from
equal codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcache_factory_tpu import config as jcfg
from kvcache_factory_tpu.cache import quant_cache as jq
from kvcache_factory_tpu.models import llama as jllama
from kvcache_factory_tpu.models import weights as jweights
from kvcache_factory_tpu_torch import config as tcfg
from kvcache_factory_tpu_torch.cache import quant_cache as tq
from kvcache_factory_tpu_torch.models import llama as tllama
from kvcache_factory_tpu_torch.models.weights import params_from_jax

D = 128
JAX_QUANT = {8: jq.quantize_per_token, 4: jq.quantize_per_token4}
JAX_PREFILL = {8: jq.from_packed_prefill_tpu, 4: jq.from_packed_prefill_tpu4}
PORT_QUANT = {8: tq.quantize_per_token, 4: tq.quantize_per_token4}


def jax_codes(codes, nbits):
    """JAX codes as unsigned values: int8 codes are biased by -128."""
    c = np.asarray(codes).astype(np.int32)
    return c + 128 if nbits == 8 else c


def jax_dequantized(cache, nbits):
    """A JAX per-token cache dequantized in numpy: (k, v) [L, B, H, C, D]."""
    sc = np.asarray(cache.scales).astype(np.float32)  # [L, B, H, 4, C]
    out = []
    for codes, row in ((cache.k_codes, 0), (cache.v_codes, 2)):
        c = jq.unpack_tokens_int4(codes) if nbits == 4 else codes
        c = jax_codes(c, nbits).astype(np.float32)
        out.append(c * sc[..., row, :, None] + sc[..., row + 1, :, None])
    return out


def half_way_ties(x, nbits):
    """Where (x - min) / scale lies within a few ulps of k + 1/2 (float64)."""
    x = x.astype(np.float64)
    mn = x.min(-1, keepdims=True)
    scale = np.maximum(x.max(-1, keepdims=True) - mn, 1e-8) / (255.0 if nbits == 8 else 15.0)
    frac = ((x - mn) / scale) % 1.0
    return np.abs(frac - 0.5) < 1e-5


@pytest.mark.parametrize("nbits", [8, 4])
def test_quantize_per_token_matches_jax(nbits):
    """Over 4 x 512 tokens of spans from 1e-6 to 1e3 no code is apart.  Any
    code apart would have to sit on a near-tie (quotient within 1e-5 of a
    half-way point); this input has 4 such values at int8 and 2 at int4,
    and both libraries round them alike."""
    rng = np.random.default_rng(0)
    spans = 10.0 ** rng.uniform(-6, 3, size=(4, 512, 1))
    x = (rng.standard_normal((4, 512, D)) * spans).astype(np.float32)
    x[0, 0] = 0.0  # a constant row: scale max(0, 1e-8) / qmax
    c, s, z = PORT_QUANT[nbits](torch.from_numpy(x))
    jc, js, jz = JAX_QUANT[nbits](jnp.asarray(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    apart = c.numpy().astype(np.int32) != jax_codes(jc, nbits)
    ties = half_way_ties(x, nbits)
    assert not (apart & ~ties).any()
    assert (int(apart.sum()), int(ties.sum())) == (0, {8: 4, 4: 2}[nbits])
    assert int(c.max()) <= (255 if nbits == 8 else 15)


def test_int4_pack_roundtrip():
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, 16, size=(3, 7, D)).astype(np.uint8))
    packed = tq.pack_int4(codes)
    assert packed.shape == (3, 7, D // 2) and packed.dtype == torch.uint8
    # channel 2i in the low nibble, 2i + 1 in the high one
    np.testing.assert_array_equal((packed & 0xF).numpy(), codes[..., 0::2].numpy())
    np.testing.assert_array_equal((packed >> 4).numpy(), codes[..., 1::2].numpy())
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), codes.numpy())


def _packed_stack(seed, C=256):
    rng = np.random.default_rng(seed)
    L, B, H = 2, 2, 2
    k = rng.standard_normal((L, B, H, C, D)).astype(np.float32)
    v = (3 * rng.standard_normal((L, B, H, C, D))).astype(np.float32)
    lens = rng.integers(0, C + 1, size=(L, B, H)).astype(np.int32)
    pos = np.asarray([C + 5, 40], np.int32)
    return k, v, lens, pos


@pytest.mark.parametrize("nbits", [8, 4])
def test_from_packed_prefill_matches_jax(nbits):
    k, v, lens, pos = _packed_stack(2)
    port = tq.from_packed_prefill(torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(lens), torch.from_numpy(pos), nbits)
    jax_cache = JAX_PREFILL[nbits](jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                                   jnp.asarray(pos))
    assert isinstance(port, tq.Int8KVCache if nbits == 8 else tq.Int4KVCache)
    assert port.capacity == jax_cache.capacity == k.shape[3]
    for got, want in zip(tq.dequantize_kv(port), jax_dequantized(jax_cache, nbits)):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port.lengths.numpy(), lens)
    np.testing.assert_array_equal(port.positions.numpy(), pos)


@pytest.mark.parametrize("nbits", [8, 4])
def test_quant_cache_from_jax_carries_the_same_values(nbits):
    """A JAX-built cache carried across holds the codes and scalars the
    port's own quantizer stores for the same input, byte for byte."""
    k, v, lens, pos = _packed_stack(3)
    jax_cache = JAX_PREFILL[nbits](jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                                   jnp.asarray(pos))
    carried = tq.quant_cache_from_jax(*(np.asarray(a) for a in jax_cache), nbits=nbits)
    own = tq.from_packed_prefill(torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(lens), torch.from_numpy(pos), nbits)
    for name in ("k_codes", "v_codes", "scales", "lengths", "positions"):
        assert torch.equal(getattr(carried, name), getattr(own, name)), name
    for got, want in zip(tq.dequantize_kv(carried), jax_dequantized(jax_cache, nbits)):
        np.testing.assert_array_equal(got.numpy(), want)


MODEL = dict(model_type="llama", vocab_size=512, hidden_size=256,
             intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=128, rope_theta=10000.0, dtype="float32")
COMP = dict(method="snapkv", max_capacity_prompt=64, window_size=8, kernel_size=7,
            pooling="maxpool", group_reduce="none")


@pytest.mark.parametrize("nbits", [8, 4])
def test_prefill_quantizes_layer_by_layer_as_jax_does_whole(nbits):
    """The port's prefill with ``quant`` against the JAX package's dense
    prefill quantized whole by ``from_packed_prefill_tpu*``.  The two
    prefills' K/V agree to ~1e-6, so a code may move by one step where a
    value sits within that of a rounding boundary: every dequantized value
    is within one code step (its token's scale) of the JAX one, and at most
    a thousandth of them differ at all."""
    jc, tc = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
    jp = jweights.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    S, cap = 256, 128 if nbits == 8 else 256
    toks = np.zeros((2, S), np.int32)
    toks[0, :200] = rng.integers(0, 512, size=200)
    toks[1, :40] = rng.integers(0, 512, size=40)
    lens = np.asarray([200, 40], np.int32)
    jres = jllama.prefill(jp, jc, jcfg.CompressionConfig(**COMP), jnp.asarray(toks),
                          jnp.asarray(lens), cap)
    want_cache = JAX_PREFILL[nbits](jres.cache.k, jres.cache.v, jres.cache.lengths,
                                    jres.cache.positions)
    tres = tllama.prefill(tp, tc, tcfg.CompressionConfig(**COMP), torch.tensor(toks),
                          torch.tensor(lens), cap, quant=tcfg.QuantConfig(nbits=nbits))
    assert isinstance(tres.cache, tq.Int8KVCache if nbits == 8 else tq.Int4KVCache)
    np.testing.assert_array_equal(tres.cache.lengths.numpy(), np.asarray(jres.cache.lengths))
    np.testing.assert_array_equal(tres.cache.positions.numpy(), lens)
    np.testing.assert_allclose(tres.logits_last.numpy(), np.asarray(jres.logits_last),
                               rtol=1e-4, atol=1e-4)
    sc = np.asarray(want_cache.scales).astype(np.float32)
    step = {"k": sc[..., 0, :, None], "v": sc[..., 2, :, None]}
    L = np.asarray(jres.cache.lengths)
    for name, got, want in zip("kv", tq.dequantize_kv(tres.cache),
                               jax_dequantized(want_cache, nbits)):
        valid = np.arange(cap)[None, None, None, :] < L[..., None]
        diff = np.abs(got.numpy() - want)[valid]
        assert (diff <= 1.01 * np.broadcast_to(step[name], want.shape)[valid]).all()
        assert (diff > 0).mean() < 1e-3, (name, (diff > 0).mean())
