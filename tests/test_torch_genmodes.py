"""PyTorch port, ``ver=v2`` combine-logits and ``stream_generate`` against
the JAX package on the tiny config, the JAX weights carried across by
``params_from_jax``.  Both sides run float32 on the CPU: combined logits
agree to 1e-6 and greedy tokens exactly.

Where the port differs from the JAX package on purpose: each scale's v2
prefill takes the ``attention_mask`` (the JAX one drops it, so a
left-padded row attends to its pads), and a v2 spec on an anyres tile
stack raises before any work (the JAX package fails in its CLIP tower's
reshape with the same ``TypeError``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGenConfig,
                                        _combine_logits as jax_combine,
                                        generate as jax_generate,
                                        stream_generate as jax_stream)
from matryoshka_mm_tpu.kvconfig import parse_kv_from_string as jax_kvs
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_torch.generate import (GenerationConfig, LogitCombiner,
                                          generate, stream_generate)
from matryoshka_mm_torch.kvconfig import parse_kv_from_string
from matryoshka_mm_torch.models.convert import params_from_jax
from tests.test_torch_anyres import _cfgs, jax_init

# the two specs of tests/test_generate.py's v2 parity test
V2_SPECS = ("ver=v2_numtoks=[4,16]_betas=[1.0,0.5]_gamma=0.1",
            "ver=v2_numtoks=[1,4,16]_pickby=entropy")
KW = dict(max_new_tokens=7, decode_chunk=3, eos_token_id=-1)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxLlavaConfig.tiny_debug()
    jparams = init_llava_params(jax.random.PRNGKey(0), jcfg)
    tcfg = LlavaConfig.tiny_debug()
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _prompt(batch, seed=3):
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((batch, 3, 56, 56)).astype(np.float32)
    ids = np.array([[1, 23, 57, IMAGE_TOKEN_INDEX, 88, 91, 14],
                    [0, 0, 1, IMAGE_TOKEN_INDEX, 301, 77, 5]],
                   np.int32)[:batch]
    return ids, px, (ids != 0 if batch > 1 else None)


def _int8(cfg):
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, kv_cache_dtype="int8"))


@pytest.mark.parametrize("spec", [
    "ver=v2_numtoks=[1,4,16]_betas=[0.2,0.3,0.5]",
    "ver=v2_numtoks=[1,4,16]_betas=[0.2,0.3,0.5]_gamma=0.1",
    "ver=v2_numtoks=[1,4,16]_pickby=entropy"])
def test_combine_logits_equals_jax(spec):
    logits = np.random.default_rng(0).standard_normal(
        (3, 4, 512)).astype(np.float32) * 4
    want = np.asarray(jax_combine(jnp.asarray(logits), jax_kvs(spec)))
    got = LogitCombiner(parse_kv_from_string(spec), "cpu")(
        torch.from_numpy(logits)).numpy()
    assert got.shape == (4, 512)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    if "gamma" in spec:
        assert np.isinf(want).any() and np.isfinite(want).any(axis=1).all()


def test_combine_logits_rejects_a_bad_spec():
    with pytest.raises(ValueError, match="betas=... or pickby"):
        LogitCombiner(parse_kv_from_string(
            "ver=v2_numtoks=[1,4]_pickby=loss"), "cpu")
    with pytest.raises(ValueError, match="3 betas for 2 scales"):
        LogitCombiner(parse_kv_from_string(
            "ver=v2_numtoks=[1,4]_betas=[1,1,1]"), "cpu")


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("spec", V2_SPECS)
def test_v2_greedy_tokens_equal_jax(models, spec, kv):
    jcfg, jp, tcfg, tp = models
    if kv:
        jcfg, tcfg = _int8(jcfg), _int8(tcfg)
    ids, px, _ = _prompt(1)
    want = jax_generate(jp, jcfg, ids, px, matryoshka_vis_token_scale=spec,
                        gen_cfg=JaxGenConfig(**KW))
    got = generate(tp, tcfg, ids, px, matryoshka_vis_token_scale=spec,
                   gen_cfg=GenerationConfig(**KW))
    assert got.shape == (1, 7)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_v2_single_beta_equals_v0(models):
    """One scale with beta 1 decodes as ver=v0 at that scale; all weight on
    the second of two scales does too."""
    _, _, tcfg, tp = models
    ids, px, mask = _prompt(2)

    def run(spec):
        return generate(tp, tcfg, ids, px, attention_mask=mask,
                        matryoshka_vis_token_scale=spec,
                        gen_cfg=GenerationConfig(**KW))

    v0 = run("ver=v0_numtoks=16")
    np.testing.assert_array_equal(run("ver=v2_numtoks=[16]_betas=[1]"), v0)
    np.testing.assert_array_equal(run("ver=v2_numtoks=[1,16]_betas=[0,1]"),
                                  v0)


@pytest.mark.parametrize("spec", V2_SPECS)
def test_v2_padded_rows_equal_each_row_alone(models, spec):
    """The port passes the mask to every scale's prefill, so a left-padded
    row decodes as it does alone.  The JAX v2 path drops the mask
    (``matryoshka_mm_tpu/generate.py:388-390``): its padded row attends to
    its pad slots and gives other tokens than the same row alone."""
    jcfg, jp, tcfg, tp = models
    ids, px, mask = _prompt(2)
    gen = GenerationConfig(**KW)
    both = generate(tp, tcfg, ids, px, attention_mask=mask,
                    matryoshka_vis_token_scale=spec, gen_cfg=gen)
    for b in range(2):
        row = ids[b:b + 1, int((~mask[b]).sum()):]
        alone = generate(tp, tcfg, row, px[b:b + 1],
                         matryoshka_vis_token_scale=spec, gen_cfg=gen)
        np.testing.assert_array_equal(both[b:b + 1], alone)
    jax_both = np.asarray(jax_generate(
        jp, jcfg, ids, px, attention_mask=mask,
        matryoshka_vis_token_scale=spec, gen_cfg=JaxGenConfig(**KW)))
    np.testing.assert_array_equal(jax_both[0], both[0])   # unpadded row
    assert not np.array_equal(jax_both[1], both[1])


def test_v2_errors_before_any_work(models):
    jcfg, jp, tcfg, tp = models
    ids = np.array([[1, 5, IMAGE_TOKEN_INDEX, 7]], np.int32)
    tiles = np.random.default_rng(0).standard_normal(
        (1, 3, 3, 56, 56)).astype(np.float32)
    spec = V2_SPECS[0]
    # the JAX package takes no anyres branch under v2 and fails in the
    # CLIP tower's reshape of the tile stack
    with pytest.raises(TypeError, match="cannot reshape"):
        jax_generate(jp, jcfg, ids, tiles, image_sizes=[(56, 56)],
                     matryoshka_vis_token_scale=spec,
                     gen_cfg=JaxGenConfig(**KW))
    with pytest.raises(TypeError, match="cannot reshape"):
        generate(tp, tcfg, ids, tiles, image_sizes=[(56, 56)],
                 matryoshka_vis_token_scale=spec,
                 gen_cfg=GenerationConfig(**KW))
    multi = np.array([[1, IMAGE_TOKEN_INDEX, 5, IMAGE_TOKEN_INDEX]], np.int32)
    with pytest.raises(ValueError, match="one image per sample"):
        generate(tp, tcfg, multi, tiles[0, :2],
                 matryoshka_vis_token_scale=spec,
                 gen_cfg=GenerationConfig(**KW))


def test_v2_on_a_text_prompt_decodes_as_jax(models):
    """A v2 spec on a text prompt decodes as the JAX package does: as
    v0 text."""
    jcfg, jp, tcfg, tp = models
    ids = np.array([[1, 5, 17, 42, 9]], np.int32)
    want = jax_generate(jp, jcfg, ids, matryoshka_vis_token_scale=V2_SPECS[1],
                        gen_cfg=JaxGenConfig(**KW))
    got = generate(tp, tcfg, ids, matryoshka_vis_token_scale=V2_SPECS[1],
                   gen_cfg=GenerationConfig(**KW))
    np.testing.assert_array_equal(got, np.asarray(want))


def _streams(jax_args, torch_args, jax_kw, torch_kw, n_chunks):
    want = [np.asarray(x) for x in jax_stream(*jax_args, **jax_kw)]
    got = list(stream_generate(*torch_args, **torch_kw))
    assert len(got) == len(want) == n_chunks
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("case", ["text", "image", "multi", "v2"])
def test_stream_yields_equal_jax(models, case):
    jcfg, jp, tcfg, tp = models
    ids, px, _ = _prompt(1)
    scale = "ver=v0_numtoks=4"
    if case == "text":
        ids, px, scale = np.array([[1, 5, 17, 42, 9]], np.int32), None, None
    elif case == "multi":
        ids = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42, 9,
                         IMAGE_TOKEN_INDEX, 7, 11]], np.int32)
        px = np.random.default_rng(0).standard_normal(
            (2, 3, 56, 56)).astype(np.float32)
    elif case == "v2":
        scale = V2_SPECS[0]
    # 7 tokens, chunks of 3: the first token, then 3 + 3 (v2: one yield)
    got = _streams((jp, jcfg, ids, px), (tp, tcfg, ids, px),
                   dict(matryoshka_vis_token_scale=scale,
                        gen_cfg=JaxGenConfig(**KW)),
                   dict(matryoshka_vis_token_scale=scale,
                        gen_cfg=GenerationConfig(**KW)),
                   1 if case == "v2" else 3)
    np.testing.assert_array_equal(got[-1], generate(
        tp, tcfg, ids, px, matryoshka_vis_token_scale=scale,
        gen_cfg=GenerationConfig(**KW)))
    if case != "v2":
        assert [g.shape[1] for g in got] == [1, 4, 7]


def test_stream_of_an_anyres_stack_equals_jax():
    jcfg, tcfg = _cfgs()
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ids = np.array([[1, 5, 17, IMAGE_TOKEN_INDEX, 42, 9]], np.int32)
    tiles = np.random.default_rng(2).standard_normal(
        (1, 5, 3, 56, 56)).astype(np.float32)
    kw = dict(image_sizes=[(500, 500)],
              matryoshka_vis_token_scale="ver=v0_numtoks=16")
    _streams((jp, jcfg, ids, tiles), (tp, tcfg, ids, tiles),
             dict(kw, gen_cfg=JaxGenConfig(**KW)),
             dict(kw, gen_cfg=GenerationConfig(**KW)), 3)


def test_stream_stops_after_the_chunk_of_an_eos(models):
    """The EOS ends the stream after its chunk's yield, padded as
    generate pads it, like the JAX stream."""
    jcfg, jp, tcfg, tp = models
    ids, px, _ = _prompt(1)
    scale = "ver=v0_numtoks=4"
    free = generate(tp, tcfg, ids, px, matryoshka_vis_token_scale=scale,
                    gen_cfg=GenerationConfig(**KW))
    kw = dict(KW, max_new_tokens=12, eos_token_id=int(free[0, 2]))
    got = _streams((jp, jcfg, ids, px), (tp, tcfg, ids, px),
                   dict(matryoshka_vis_token_scale=scale,
                        gen_cfg=JaxGenConfig(**kw)),
                   dict(matryoshka_vis_token_scale=scale,
                        gen_cfg=GenerationConfig(**kw)), 2)
    assert got[-1].shape == (1, 4) and (got[-1][0, 2:] == 0).all()
