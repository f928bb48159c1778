"""PyTorch port: the LLaMA decoder against the JAX package on the tiny
config, with the JAX parameters bridged through ``params_from_jax``.
Float32 throughout; hidden states and logits within ``atol=1e-4``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.models import llama as jl
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.models import llama as tl
from matryoshka_mm_torch.models.convert import params_from_jax

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = JaxLlavaConfig.tiny_debug()
    jparams = init_llava_params(jax.random.PRNGKey(0), jcfg)
    tcfg = LlavaConfig.tiny_debug()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams["llama"], tcfg, tparams["llama"]


def _left_padded_batch(cfg, seed=0, B=2, S=12, pads=(0, 5)):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, S, cfg.hidden_size)).astype(np.float32)
    valid = np.ones((B, S), bool)
    for b, p in enumerate(pads):
        valid[b, :p] = False
    pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    return emb, valid, pos


def test_bridge_shapes_and_dtypes(models):
    _, jp, tcfg, tp = models
    assert len(tp["layers"]) == tcfg.llama.num_hidden_layers
    q = tp["layers"][2]["self_attn"]["q_proj"]
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jp["layers"]["self_attn"]["q_proj"][2]))
    assert q.dtype == torch.float32


def test_building_blocks(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    pos = np.array([[0, 5, 9, 40], [1, 2, 3, 100]], np.int32)[:, :3]
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    got = tl.apply_rope(torch.from_numpy(x).transpose(1, 2), tc, ts)
    want = jl.apply_rope(jnp.asarray(x).transpose(0, 2, 1, 3), jc, js)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    h = x.reshape(2, 3, 64)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(h), tp["norm"], 1e-5).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(h), jp["norm"], 1e-5)),
        atol=1e-5)
    ids = np.array([[1, -200, 5, 511, 600]], np.int32)   # sentinel + overflow
    np.testing.assert_array_equal(
        tl.embed_tokens(tp, torch.from_numpy(ids)).numpy(),
        np.asarray(jl.embed_tokens(jp, jnp.asarray(ids))))


def test_forward_without_cache(models):
    jcfg, jp, tcfg, tp = models
    emb, valid, pos = _left_padded_batch(tcfg.llama)
    want, _ = jl.llama_forward(jp, jcfg.llama, jnp.asarray(emb),
                               position_ids=jnp.asarray(pos),
                               attn_valid=jnp.asarray(valid))
    got, cache = tl.llama_forward(tp, tcfg.llama, torch.from_numpy(emb),
                                  position_ids=torch.from_numpy(pos),
                                  attn_valid=torch.from_numpy(valid))
    assert cache is None
    # padded rows attend to nothing and are never read: compare real rows
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_cached_prefill_then_decode(models, impl):
    jcfg, jp, tcfg, tp = models
    tcfg_llama = tcfg.with_attn_impl(impl).llama
    B, S, steps = 2, 12, 3
    capacity = S + steps
    emb, valid, pos = _left_padded_batch(tcfg.llama, seed=2, B=B, S=S)
    jcache = jl.init_kv_cache(jcfg.llama, B, capacity)
    tcache = tl.init_kv_cache(tcfg_llama, B, capacity, device="cpu")
    jh, jcache = jl.llama_forward(jp, jcfg.llama, jnp.asarray(emb),
                                  position_ids=jnp.asarray(pos),
                                  attn_valid=jnp.asarray(valid),
                                  cache=jcache)
    th, tcache = tl.llama_forward(tp, tcfg_llama, torch.from_numpy(emb),
                                  position_ids=torch.from_numpy(pos),
                                  attn_valid=torch.from_numpy(valid),
                                  cache=tcache)
    np.testing.assert_allclose(
        tl.lm_head(tp, th[:, -1]).numpy(),
        np.asarray(jl.lm_head(jp, jh[:, -1])), atol=ATOL)

    rng = np.random.default_rng(3)
    next_pos = valid.sum(axis=1).astype(np.int32)
    for step in range(steps):
        ids = rng.integers(4, tcfg.llama.vocab_size, (B, 1)).astype(np.int32)
        p = (next_pos + step)[:, None]
        alive = np.array([[True], [step != 1]])   # row 1 "finished" once
        jh, jcache = jl.llama_forward(
            jp, jcfg.llama, jl.embed_tokens(jp, jnp.asarray(ids)),
            position_ids=jnp.asarray(p), attn_valid=jnp.asarray(alive),
            cache=jcache)
        th, tcache = tl.llama_forward(
            tp, tcfg_llama, tl.embed_tokens(tp, torch.from_numpy(ids)),
            position_ids=torch.from_numpy(p),
            attn_valid=torch.from_numpy(alive), cache=tcache)
        np.testing.assert_allclose(
            tl.lm_head(tp, th[:, 0]).numpy(),
            np.asarray(jl.lm_head(jp, jh[:, 0])), atol=ATOL)
    assert tcache.write_idx == int(jcache.write_idx) == capacity
    np.testing.assert_array_equal(tcache.valid.numpy(),
                                  np.asarray(jcache.valid))
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
