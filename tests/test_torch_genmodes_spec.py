"""PyTorch port, ``speculative_generate`` and ``chunked_prefill`` against
the JAX package on the tiny config, the JAX weights carried across by
``params_from_jax``; float32 on both sides.  The speculative tokens are
set by greedy verification, so both draft paths give the JAX tokens
exactly; the chunked prefill's logits and cache agree to 1e-5 with the
JAX function's and with the port's one-shot prefill."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGenConfig,
                                        chunked_prefill as jax_chunked,
                                        speculative_generate as jax_spec)
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.ops.quant import quantize_llama_params_int4
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_torch.generate import (GenerationConfig, _buffer_propose,
                                          _ngram_propose, chunked_prefill,
                                          generate, speculative_generate)
from matryoshka_mm_torch.models.convert import params_from_jax
from matryoshka_mm_torch.models.llama import (embed_tokens, init_kv_cache,
                                              llama_forward, lm_head)
from tests.test_torch_anyres import jax_init

SCALE = "ver=v0_numtoks=4"


@pytest.fixture(scope="module")
def models():
    jcfg = JaxLlavaConfig.tiny_debug()
    jparams = init_llava_params(jax.random.PRNGKey(0), jcfg)
    tcfg = LlavaConfig.tiny_debug()
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _prompt(with_image):
    """A prompt whose text repeats, so the drafts are accepted in part."""
    if with_image:
        ids = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42, 9, 17, 42, 9, 17, 42]],
                       np.int32)
        return ids, np.random.default_rng(0).standard_normal(
            (1, 3, 56, 56)).astype(np.float32), SCALE
    ids = np.tile(np.random.default_rng(1).integers(5, 100, (1, 6)), 3)
    return ids.astype(np.int32), None, None


def _both(models, ids, px, scale, gen, **kw):
    jcfg, jp, tcfg, tp = models
    want = np.asarray(jax_spec(jp, jcfg, ids, px,
                               matryoshka_vis_token_scale=scale,
                               gen_cfg=JaxGenConfig(**gen), **kw))
    got = speculative_generate(tp, tcfg, ids, px,
                               matryoshka_vis_token_scale=scale,
                               gen_cfg=GenerationConfig(**gen), **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return got


def test_ngram_and_buffer_proposers():
    ids = [1, 2, 3, 9, 9, 1, 2, 3, 7, 8, 1, 2, 3]
    assert _ngram_propose(ids, 4, 3) == [7, 8, 1, 2]
    assert _ngram_propose([4, 5, 6], 3, 3) == [6, 6, 6]
    assert _ngram_propose([1, 2, 3, 5, 1, 2, 3], 3, 3) == [5, 1, 2]
    buf = np.zeros(20, np.int64)
    buf[:13] = ids
    # the buffer rule reads on past the match, and clips the start so k fit
    assert _buffer_propose(buf, 13, 99, 4, 3) == [7, 8, 1, 2]
    assert _buffer_propose(buf, 13, 99, 8, 3) == [7, 8, 1, 2, 3, 0, 0, 0]
    assert _buffer_propose(buf, 5, 99, 3, 3) == [99, 99, 99]


@pytest.mark.parametrize("draft", ["buffer", "ngram"])
@pytest.mark.parametrize("with_image", [False, True])
def test_speculative_equals_jax_and_greedy(models, with_image, draft):
    _, _, tcfg, tp = models
    ids, px, scale = _prompt(with_image)
    gen = dict(max_new_tokens=16, decode_chunk=4, eos_token_id=-1)
    kw = dict(k=4, ngram=3)
    if draft == "ngram":
        kw["propose_fn"] = _ngram_propose
    got = _both(models, ids, px, scale, gen, **kw)
    want = generate(tp, tcfg, ids, px, matryoshka_vis_token_scale=scale,
                    gen_cfg=GenerationConfig(**gen))
    np.testing.assert_array_equal(got[:, :want.shape[1]], want)


@pytest.mark.parametrize("draft", ["buffer", "ngram"])
def test_speculative_eos_and_budget_equal_jax(models, draft):
    """An EOS inside an accepted draft, and budgets that end inside a
    verify step."""
    _, _, tcfg, tp = models
    ids, px, scale = _prompt(False)
    kw = dict(k=4) if draft == "buffer" else dict(k=4,
                                                  propose_fn=_ngram_propose)
    free = generate(tp, tcfg, ids, px, gen_cfg=GenerationConfig(
        max_new_tokens=24, eos_token_id=-1))[0]
    _both(models, ids, px, scale, dict(max_new_tokens=24,
                                       eos_token_id=int(free[5])), **kw)
    for budget in (1, 2, 7):
        _both(models, ids, px, scale, dict(max_new_tokens=budget,
                                           eos_token_id=-1), **kw)


def test_speculative_under_the_int4_quantizer_equals_jax(models):
    """The JAX int4 weights (``tests/test_speculative.py``'s) carried
    across: (k + 1)-row verify products dequantize on both sides."""
    jcfg, jp, tcfg, _ = models
    jq = dict(jp, llama=quantize_llama_params_int4(
        copy.deepcopy(jp["llama"]), min_size=1024))
    tq = params_from_jax(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    ids, px, scale = _prompt(True)
    _both((jcfg, jq, tcfg, tq), ids, px, scale,
          dict(max_new_tokens=12, eos_token_id=-1))


def test_speculative_through_the_facade_equals_jax(models):
    from matryoshka_mm_tpu.models.builder import LlavaModel as JaxLlavaModel
    from matryoshka_mm_torch.models.builder import LlavaModel

    jcfg, jp, tcfg, tp = models
    ids, px, scale = _prompt(True)
    kw = dict(images=px, matryoshka_vis_token_scale=scale,
              speculative=True, max_new_tokens=10, eos_token_id=-1)
    want = JaxLlavaModel(jp, jcfg).generate(ids, **kw)
    got = LlavaModel(tp, tcfg).generate(ids, **kw)
    assert got.shape == (1, 10)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_speculative_errors(models):
    _, _, tcfg, tp = models
    ids, px, _ = _prompt(True)
    with pytest.raises(ValueError, match="batch_size=1"):
        speculative_generate(tp, tcfg, np.repeat(ids, 2, 0))
    with pytest.raises(ValueError, match="greedy-only"):
        speculative_generate(tp, tcfg, ids, px, gen_cfg=GenerationConfig(
            do_sample=True, temperature=0.7))
    with pytest.raises(ValueError, match="ver=v0"):
        speculative_generate(tp, tcfg, ids, px,
                             matryoshka_vis_token_scale="ver=v2_numtoks=[1,4]"
                                                        "_pickby=entropy")


@pytest.mark.parametrize("attn_impl", ["reference", "auto"])
def test_chunked_prefill_equals_jax_and_one_shot(attn_impl):
    """Two chunks of 128 against a 272-slot cache, one row left-padded;
    JAX through its reference attention or its flash kernel (interpret
    mode), the port through its reference attention or the flash kernel's
    plain version with ``q_index_offset``.  Two heads of Dh = 32: at the
    tiny config's Dh = 16 the JAX flash kernel gives NaN on the pad rows,
    which see no key (``ROADMAP.md``, Queue 3)."""
    jl = dataclasses.replace(
        JaxLlavaConfig.tiny_debug().llama, num_attention_heads=2,
        num_key_value_heads=2,
        attn_impl="flash" if attn_impl == "auto" else "reference")
    jcfg = dataclasses.replace(JaxLlavaConfig.tiny_debug(), llama=jl)
    jp = jax_init(jax.random.PRNGKey(1), jcfg)
    base = LlavaConfig.tiny_debug()
    tcfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, num_attention_heads=2, num_key_value_heads=2,
        attn_impl=attn_impl))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tl = tcfg.llama

    B, S, cap = 2, 256, 272
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 100, (B, S)).astype(np.int32)
    valid = np.ones((B, S), bool)
    valid[1, :37] = False                        # a left-padded row
    pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    jlogits, jcache = jax_chunked(
        jp, jcfg, embed_tokens_jax(jp, ids), jnp.asarray(pos),
        jnp.asarray(valid), cap, chunk=128)

    embeds = embed_tokens(tp["llama"], torch.as_tensor(ids))
    got, cache = chunked_prefill(tp, tcfg, embeds, torch.as_tensor(pos),
                                 torch.as_tensor(valid), cap, chunk=128)
    one = init_kv_cache(tl, B, cap, device="cpu")
    hidden, one = llama_forward(tp["llama"], tl, embeds,
                                position_ids=torch.as_tensor(pos),
                                attn_valid=torch.as_tensor(valid), cache=one)
    want = lm_head(tp["llama"], hidden[:, -1:, :])[:, 0]
    assert cache.host_idx == int(cache.write_idx) == S
    for a, b in ((got, jlogits), (got, want), (cache.k, jcache.k),
                 (cache.v, jcache.v), (cache.k, one.k), (cache.v, one.v)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5,
                                   rtol=0)
    for name in ("valid", "positions"):
        np.testing.assert_array_equal(getattr(cache, name).numpy(),
                                      np.asarray(getattr(jcache, name)))
    with pytest.raises(ValueError, match="multiple of chunk"):
        chunked_prefill(tp, tcfg, embeds[:, :200], torch.as_tensor(pos),
                        torch.as_tensor(valid), cap, chunk=128)


def embed_tokens_jax(params, ids):
    from matryoshka_mm_tpu.models.llama import embed_tokens as jax_embed

    return jax_embed(params["llama"], jnp.asarray(ids))
