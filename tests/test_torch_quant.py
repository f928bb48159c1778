"""PyTorch port, ``ops/quant.py`` against the JAX ``ops/quant.py``: the
quantizers give the same bytes, dequantization the same values, and
``quantize_llama_params`` the same leaves as the JAX ``maybe_quantize``
(bridged through ``params_from_jax``, which strips the TPU tile padding).
Every comparison is exact."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.models.builder import maybe_quantize
from matryoshka_mm_tpu.models.llama import _quantize_kv_slots as jax_kv_slots
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.ops import quant as jq
from matryoshka_mm_torch.config import LlamaConfig, LlavaConfig
from matryoshka_mm_torch.models.convert import params_from_jax, strip_padding
from matryoshka_mm_torch.models.llama import init_kv_cache
from matryoshka_mm_torch.ops import quant as tq

QUANT = {8: (jq.quantize_array, tq.quantize_array, "qint8"),
         4: (jq.quantize_array_int4, tq.quantize_array_int4, "qint4")}


def _weights(shape, dtype, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape) * 0.05
    w = jnp.asarray(w, jnp.float32).astype(dtype)
    return w, torch.tensor(np.asarray(w.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _assert_leaf_equal(jleaf, tleaf, key):
    np.testing.assert_array_equal(tleaf[key].numpy(), np.asarray(jleaf[key]))
    np.testing.assert_array_equal(tleaf["scale"].numpy(),
                                  np.asarray(jleaf["scale"]))
    assert tleaf[key].dtype == torch.int8
    assert tleaf["scale"].dtype == torch.float32


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(64, 128), (300, 11008 // 4), (7, 10)])
def test_quantizers_byte_identical_2d(bits, dtype, shape):
    jfn, tfn, key = QUANT[bits]
    jw, tw = _weights(shape, dtype)
    _assert_leaf_equal(jfn(jw), tfn(tw), key)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantizers_byte_identical_stacked_and_per_layer(bits, dtype):
    """A stacked leaf, whole and one layer at a time (the port's per-layer
    leaves take the ``stacked`` form)."""
    jfn, tfn, key = QUANT[bits]
    jw, tw = _weights((3, 96, 64), dtype, seed=1)
    jleaf = jfn(jw)
    _assert_leaf_equal(jleaf, tfn(tw), key)
    for i in range(3):
        _assert_leaf_equal({k: v[i] for k, v in jleaf.items()},
                           tfn(tw[i], stacked=True), key)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequantize_matches_jax_exactly(bits, dtype):
    jfn, tfn, key = QUANT[bits]
    jw, tw = _weights((48, 80), jnp.float32, seed=2)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jq.dequantize_array(jfn(jw), jdt).astype(jnp.float32))
    got = tq.dequantize_array(tfn(tw), dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert tq.dequantize_array(tw) is tw          # a float leaf as it is


@pytest.mark.parametrize("bits", [4, 8])
def test_strip_padding_undoes_the_tpu_tiles(bits):
    """A leaf padded by ``pad_int4_leaf`` / ``pad_int8_leaf`` (N 2050 -> 4096,
    packed K 515 -> 1024) comes back to the unpadded bytes."""
    jfn, _, key = QUANT[bits]
    jw, _ = _weights((2050, 1030), jnp.float32, seed=3)
    leaf = jfn(jw)
    pad = jq.pad_int4_leaf if bits == 4 else jq.pad_int8_leaf
    padded = jax.tree.map(np.asarray, pad(leaf))
    assert padded[key].shape[0] == 4096 and "orig_shape" in padded
    got = strip_padding(padded)
    np.testing.assert_array_equal(got[key], np.asarray(leaf[key]))
    np.testing.assert_array_equal(got["scale"], np.asarray(leaf["scale"]))


def test_kv_slot_quantizer_matches_jitted_jax():
    x = np.random.default_rng(4).standard_normal((1, 2, 50, 4, 16)) * 3
    x = x.astype(np.float32)
    jq8, js = jax.jit(jax_kv_slots)(jnp.asarray(x))
    tq8, ts = tq._quantize_kv_slots(torch.from_numpy(x))
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxLlavaConfig.tiny_debug()
    jparams = init_llava_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, LlavaConfig.tiny_debug()


@pytest.mark.parametrize("bits,fuse", [(4, True), (8, True), (4, False)])
def test_quantize_llama_params_matches_maybe_quantize(tiny, bits, fuse):
    """Same leaves quantized (``lm_head`` included, norms and the embedding
    not), same fused layout, same bytes."""
    jcfg, jparams, tcfg = tiny
    jq_params = maybe_quantize(jax.tree.map(lambda a: a, jparams),
                               load_8bit=bits == 8, load_4bit=bits == 4,
                               fuse=fuse)
    want = params_from_jax(jax.tree.map(np.asarray, jq_params), tcfg)
    got = tq.quantize_llama_params(
        params_from_jax(jax.tree.map(np.asarray, jparams), tcfg), bits,
        fuse=fuse)
    key = "qint4" if bits == 4 else "qint8"

    def walk(a, b, path):
        if tq.is_quantized(b):
            assert tq.is_quantized(a), path
            _assert_leaf_equal({k: v.numpy() for k, v in b.items()}, a, key)
        elif isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                walk(a[k], b[k], path + (k,))
        elif isinstance(b, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        else:
            assert not tq.is_quantized(a), path
            assert torch.equal(a, b), path

    walk(got["llama"], want["llama"], ())
    llama = got["llama"]
    assert tq.is_quantized(llama["lm_head"])
    assert not tq.is_quantized(llama["embed_tokens"])
    assert ("qkv_proj" in llama["layers"][0]["self_attn"]) == fuse
    assert ("gateup_proj" in llama["layers"][0]["mlp"]) == fuse


def test_disable_fused_proj_nests():
    assert tq.fused_proj_enabled()
    with tq.disable_fused_proj():
        assert not tq.fused_proj_enabled()
        with tq.disable_fused_proj():
            assert not tq.fused_proj_enabled()
        assert not tq.fused_proj_enabled()
    assert tq.fused_proj_enabled()


def test_kv_cache_dtype_config_and_cache():
    cfg = LlamaConfig.tiny_debug()
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        dataclasses.replace(cfg, kv_cache_dtype="float16")
    for kvd in ("", "float32"):
        cache = init_kv_cache(dataclasses.replace(cfg, kv_cache_dtype=kvd),
                              2, 8, device="cpu")
        assert cache.k.dtype == torch.float32 and cache.k_scale is None
    cache = init_kv_cache(dataclasses.replace(cfg, kv_cache_dtype="int8"),
                          2, 8, device="cpu")
    assert cache.k.dtype == torch.int8 and cache.v.dtype == torch.int8
    assert cache.k_scale.shape == cache.k.shape[:4]
    assert cache.v_scale.dtype == torch.float32
