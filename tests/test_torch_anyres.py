"""PyTorch port, LLaVA-NeXT's anyres tiles and multi-image prompts against
the JAX package on the tiny anyres config of ``tests/test_anyres.py``
(56-pixel tiles, pinpoints of one and two tiles a side, ``spatial_unpad``).
The JAX weights are carried across by ``params_from_jax`` with their
``image_newline``; both sides run float32 on the CPU, so features agree to
``ATOL`` and greedy tokens exactly.  Each JAX function runs once here."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGenConfig,
                                        generate as jax_generate)
from matryoshka_mm_tpu.models import llava as jl
from matryoshka_mm_tpu.models.clip import ClipVisionConfig as JaxClip
from matryoshka_mm_tpu.models.llama import LlamaConfig as JaxLlama
from matryoshka_mm_torch.config import (ClipVisionConfig, LlamaConfig,
                                        LlavaConfig, M3Preset)
from matryoshka_mm_torch.generate import GenerationConfig, generate
from matryoshka_mm_torch.models import llava as tl
from matryoshka_mm_torch.models.convert import init_params, params_from_jax

PINPOINTS = "[(112, 56), (56, 112), (112, 112)]"   # in 56-pixel tiles
SCALES = "ver=v0_numtoks=[1,4,16]"
ATOL = 1e-5          # float32 on both sides, sums in another order
MOE = "t=dense_ft=cls_obj=weightedlm"
# (image size, tiles in its stack): square, wide, tall, 4:3
SIZES = (((500, 500), 5), ((300, 120), 3), ((120, 300), 3), ((640, 480), 5))
# the JAX side compiled: each call op by op costs seconds
jax_init = jax.jit(jl.init_llava_params, static_argnums=1)
jax_encode = jax.jit(jl.encode_anyres_features, static_argnums=(1, 3, 4))


def _cfgs(merge="spatial_unpad", moe=None):
    kw = dict(mm_patch_merge_type=merge, image_aspect_ratio="anyres",
              image_grid_pinpoints=PINPOINTS, tokenizer_model_max_length=256,
              router_feature_types=("cls",) if moe else ())
    return (jl.LlavaConfig(llama=JaxLlama.tiny_debug(),
                           vision=JaxClip.tiny_debug(),
                           preset=jl.M3Preset(matryoshka_vis_token_scale=SCALES,
                                              moe=moe), **kw),
            LlavaConfig(llama=LlamaConfig.tiny_debug(),
                        vision=ClipVisionConfig.tiny_debug(),
                        preset=M3Preset(matryoshka_vis_token_scale=SCALES,
                                        moe=moe), **kw))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _tiles(n, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, 56, 56)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0)


def _same_splice(got, want):
    _close(got.embeds, want.embeds)
    for name in ("labels", "attn_mask", "position_ids", "lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)))


def test_params_carry_the_image_newline(models):
    _, jp, tcfg, tp = models
    assert tp["image_newline"].shape == (tcfg.llama.hidden_size,)
    np.testing.assert_array_equal(tp["image_newline"].numpy(),
                                  np.asarray(jp["image_newline"]))


@pytest.mark.parametrize("merge,want", [("spatial_unpad", True),
                                        ("spatial", False), ("flat", False)])
def test_init_params_adds_the_newline_of_an_unpad_merge(merge, want):
    _, tcfg = _cfgs(merge)
    params = init_params(tcfg, device="cpu", seed=0)
    assert ("image_newline" in params) == want
    if want:
        t = params["image_newline"]
        assert t.shape == (tcfg.llama.hidden_size,) and t.device.type == "cpu"
        assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())
        again = init_params(tcfg, device="cpu", seed=0)["image_newline"]
        assert torch.equal(t, again)


def test_unpad_image_features_equals_jax():
    grid = np.random.default_rng(0).standard_normal((8, 12, 12)).astype(
        np.float32)
    for size in ((100, 300), (300, 100), (200, 200), (640, 480)):
        got = tl.unpad_image_features(torch.from_numpy(grid), size, (12, 12))
        want = jl.unpad_image_features(jnp.asarray(grid), size, (12, 12))
        assert got.shape == want.shape, size
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_anyres_token_count_equals_jax():
    for merge in ("spatial_unpad", "spatial", "flat"):
        jcfg, tcfg = _cfgs(merge)
        for w in (40, 120, 300, 500, 1000):
            for h in (40, 120, 300, 500, 1000):
                for n_stacks in (1, 3, 5):
                    for numtoks in (1, 4, 16):
                        assert tl.anyres_token_count(
                            tcfg, (w, h), n_stacks, numtoks) == \
                            jl.anyres_token_count(jcfg, (w, h), n_stacks,
                                                  numtoks)


# (merge, image size, tiles): every SIZES case under spatial_unpad, and one
# each of the spatial and flat merges
ENCODE_CASES = [("spatial_unpad",) + c for c in SIZES] + [
    ("spatial", (300, 120), 3), ("flat", (120, 300), 3)]


@pytest.mark.parametrize("merge,size,n", ENCODE_CASES)
def test_encode_anyres_features_equals_jax(models, merge, size, n):
    _, jp, _, tp = models
    jcfg, tcfg = _cfgs(merge)
    px = _tiles(n, seed=n)
    got = tl.encode_anyres_features(tp, tcfg, torch.from_numpy(px), size, 16)
    want = jax_encode(jp, jcfg, jnp.asarray(px), size, 16)
    assert got.shape == want.shape
    assert got.shape[0] == tl.anyres_token_count(tcfg, size, n, 16)
    if (merge, size) == ("spatial_unpad", (500, 500)):
        assert got.shape[0] == 88      # 16 + (2 * 4) rows x (2 * 4 + 1)
    _close(got, want)


def test_a_base_tile_alone_ends_with_the_newline(models):
    jcfg, jp, tcfg, tp = models
    px = _tiles(1)
    got = tl.encode_anyres_features(tp, tcfg, torch.from_numpy(px),
                                    (56, 56), 4)
    want = jax_encode(jp, jcfg, jnp.asarray(px), (56, 56), 4)
    assert got.shape == (5, tcfg.llama.hidden_size)
    _close(got, want)
    np.testing.assert_array_equal(got[-1].numpy(),
                                  tp["image_newline"].numpy())


def test_prepare_multimodal_anyres_equals_jax(models):
    jcfg, jp, tcfg, tp = models
    ids = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42]], np.int32)
    px = _tiles(5)
    got = tl.prepare_multimodal_anyres(
        tp, tcfg, torch.as_tensor(ids, dtype=torch.int64),
        torch.from_numpy(px), (500, 500), numtoks=16, out_len=128)
    want = jax.jit(lambda p, i, x: jl.prepare_multimodal_anyres(
        p, jcfg, i, x, (500, 500), numtoks=16, out_len=128))(
        jp, jnp.asarray(ids), jnp.asarray(px))
    _same_splice(got, want)
    assert int(got.lengths[0]) == 3 + 88


def _three_images():
    ids = np.array([[1, 23, IMAGE_TOKEN_INDEX, 57, IMAGE_TOKEN_INDEX, 88,
                     IMAGE_TOKEN_INDEX, 14, 9]], np.int32)
    return ids, _tiles(3, seed=5)


def test_prepare_multimodal_multi_equals_jax(models):
    jcfg, jp, tcfg, tp = models
    ids, px = _three_images()
    got, _ = tl.prepare_multimodal_multi(
        tp, tcfg, torch.as_tensor(ids, dtype=torch.int64),
        torch.from_numpy(px), numtoks=4, padding_side="left", out_len=64)
    want, _ = jax.jit(lambda p, i, x: jl.prepare_multimodal_multi(
        p, jcfg, i, x, numtoks=4, padding_side="left", out_len=64))(
        jp, jnp.asarray(ids), jnp.asarray(px))
    _same_splice(got, want)
    assert int(got.lengths[0]) == 9 - 3 + 3 * 4


GEN = dict(max_new_tokens=6, decode_chunk=4, eos_token_id=-1)


def test_anyres_generate_equals_jax(models):
    jcfg, jp, tcfg, tp = models
    ids = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42]], np.int32)
    px = _tiles(5)[None]
    kw = dict(image_sizes=[(500, 500)],
              matryoshka_vis_token_scale="ver=v0_numtoks=16")
    want = jax_generate(jp, jcfg, ids, px, gen_cfg=JaxGenConfig(**GEN), **kw)
    got = generate(tp, tcfg, ids, px, gen_cfg=GenerationConfig(**GEN), **kw)
    assert got.shape == (1, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_three_image_generate_equals_jax(models):
    jcfg, jp, tcfg, tp = models
    ids, px = _three_images()
    spec = "ver=v0_numtoks=4"
    want = jax_generate(jp, jcfg, ids, px, matryoshka_vis_token_scale=spec,
                        gen_cfg=JaxGenConfig(**GEN))
    got = generate(tp, tcfg, ids, px, matryoshka_vis_token_scale=spec,
                   gen_cfg=GenerationConfig(**GEN))
    assert got.shape == (1, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def _raises_like_jax(exc, jfn, tfn, match):
    with pytest.raises(exc, match=match):
        jfn()
    with pytest.raises(exc, match=match):
        tfn()


def test_anyres_and_multi_image_errors_equal_jax(models):
    jcfg, jp, tcfg, tp = models
    spec = "ver=v0_numtoks=16"
    # anyres at B > 1
    ids2 = np.array([[5, IMAGE_TOKEN_INDEX, 42], [6, IMAGE_TOKEN_INDEX, 43]],
                    np.int32)
    px2 = np.stack([_tiles(5), _tiles(5, seed=3)])
    _raises_like_jax(
        ValueError,
        lambda: jax_generate(jp, jcfg, ids2, px2, image_sizes=[(500, 500)] * 2,
                             matryoshka_vis_token_scale=spec),
        lambda: generate(tp, tcfg, ids2, px2, image_sizes=[(500, 500)] * 2,
                         matryoshka_vis_token_scale=spec),
        "batch_size=1")
    # a padded anyres prompt
    ids = np.array([[0, 5, IMAGE_TOKEN_INDEX, 42]], np.int32)
    _raises_like_jax(
        ValueError,
        lambda: jax_generate(jp, jcfg, ids, px2[:1], image_sizes=[(500, 500)],
                             attention_mask=ids != 0,
                             matryoshka_vis_token_scale=spec),
        lambda: generate(tp, tcfg, ids, px2[:1], image_sizes=[(500, 500)],
                         attention_mask=ids != 0,
                         matryoshka_vis_token_scale=spec),
        "unpadded")
    # several images under ver=v2
    ids3, px3 = _three_images()
    v2 = "ver=v2_numtoks=[1,4]_betas=[0.5,0.5]"
    _raises_like_jax(
        ValueError,
        lambda: jax_generate(jp, jcfg, ids3, px3,
                             matryoshka_vis_token_scale=v2),
        lambda: generate(tp, tcfg, ids3, px3, matryoshka_vis_token_scale=v2),
        "one image per sample")


def test_gateprobargmax_on_a_tile_stack_fails_as_in_jax():
    """The JAX package's router reads one image a row: its CLIP tower fails
    to reshape a tile stack with a TypeError, and so does the port."""
    jcfg, tcfg = _cfgs(moe=MOE)
    jp = jax_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ids = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42]], np.int32)
    px = _tiles(5)[None]
    kw = dict(image_sizes=[(500, 500)],
              matryoshka_vis_token_scale="ver=v0_numtoks=gateprobargmax")
    _raises_like_jax(TypeError,
                     lambda: jax_generate(jp, jcfg, ids, px, **kw),
                     lambda: generate(tp, tcfg, ids, px, **kw), "reshape")
