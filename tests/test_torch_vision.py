"""PyTorch port: the vision half (CLIP tower, projector, M3 pooling, splice,
``prepare_multimodal``) against the JAX package on the tiny config, with
the JAX parameters bridged through ``params_from_jax``.  Float32."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_tpu.models import clip as jclip
from matryoshka_mm_tpu.models import projector as jproj
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params,
                                            prepare_multimodal as jprep)
from matryoshka_mm_tpu.ops.pooling import matryoshka_pool as jpool
from matryoshka_mm_tpu.ops.splice import splice_multimodal as jsplice
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.models import clip as tclip
from matryoshka_mm_torch.models import projector as tproj
from matryoshka_mm_torch.models.convert import params_from_jax
from matryoshka_mm_torch.models.llava import prepare_multimodal as tprep
from matryoshka_mm_torch.ops.pooling import matryoshka_pool as tpool
from matryoshka_mm_torch.ops.splice import splice_multimodal as tsplice


@pytest.fixture(scope="module")
def models():
    jcfg = JaxLlavaConfig.tiny_debug()
    jparams = init_llava_params(jax.random.PRNGKey(1), jcfg)
    tcfg = LlavaConfig.tiny_debug()
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _pixels(seed, B=2, size=56):
    return np.random.default_rng(seed).standard_normal(
        (B, 3, size, size)).astype(np.float32)


def test_clip_patch_features(models):
    jcfg, jp, tcfg, tp = models
    px = _pixels(0)
    want = jclip.clip_vision_forward(jp["vision_tower"], jnp.asarray(px),
                                     jcfg.vision)
    got = tclip.clip_vision_forward(tp["vision_tower"], torch.from_numpy(px),
                                    tcfg.vision)
    for key in ("patch", "cls_patch"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4)


def test_projector(models):
    jcfg, jp, tcfg, tp = models
    x = np.random.default_rng(2).standard_normal((2, 16, 32)) \
        .astype(np.float32)
    want = jproj.apply_projector(jp["mm_projector"], "mlp2x_gelu",
                                 jnp.asarray(x))
    got = tproj.apply_projector(tp["mm_projector"], "mlp2x_gelu",
                                torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("numtoks", [1, 4, 9, 16])
def test_pooling_every_tiny_scale(numtoks):
    x = np.random.default_rng(numtoks).standard_normal((2, 16, 8)) \
        .astype(np.float32)
    got = tpool(torch.from_numpy(x), numtoks)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpool(jnp.asarray(x), numtoks)),
                               atol=1e-6)
    t = torch.from_numpy(x).reshape(2, 4, 4, 8).permute(0, 3, 1, 2)
    h = int(numtoks ** 0.5)
    ref = torch.nn.functional.adaptive_avg_pool2d(t, h)
    np.testing.assert_allclose(
        got.numpy(), ref.permute(0, 2, 3, 1).reshape(2, numtoks, 8).numpy(),
        atol=1e-6)


def _splice_inputs(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 500, (3, 10)).astype(np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    ids[1, 6] = IMAGE_TOKEN_INDEX
    ids[2, 8] = IMAGE_TOKEN_INDEX
    mask = np.ones((3, 10), bool)
    mask[1, 8:] = False        # right padding
    mask[2, :3] = False        # left padding
    emb = rng.standard_normal((3, 10, 6)).astype(np.float32)
    feats = rng.standard_normal((3, 1, 4, 6)).astype(np.float32)
    labels = rng.integers(0, 500, (3, 10)).astype(np.int32)
    return ids, emb, feats, labels, mask


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("out_len", [16, 11])      # 11 truncates row 0
def test_splice_exact(side, out_len):
    ids, emb, feats, labels, mask = _splice_inputs(3)
    want = jsplice(jnp.asarray(ids), jnp.asarray(emb), jnp.asarray(feats),
                   labels=jnp.asarray(labels), attn_mask=jnp.asarray(mask),
                   out_len=out_len, padding_side=side)
    got = tsplice(torch.from_numpy(ids), torch.from_numpy(emb),
                  torch.from_numpy(feats), labels=torch.from_numpy(labels),
                  attn_mask=torch.from_numpy(mask), out_len=out_len,
                  padding_side=side)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("numtoks", [1, 4, 16])
def test_prepare_multimodal(models, numtoks):
    jcfg, jp, tcfg, tp = models
    ids = np.array([[1, 7, IMAGE_TOKEN_INDEX, 9, 11, 13],
                    [0, 0, 1, IMAGE_TOKEN_INDEX, 5, 6]], np.int32)
    mask = ids != 0
    px = _pixels(4)
    L = 6 - 1 + numtoks
    want, _ = jprep(jp, jcfg, jnp.asarray(ids), jnp.asarray(px),
                    numtoks=numtoks, attn_mask=jnp.asarray(mask), out_len=L,
                    padding_side="left")
    got, gating = tprep(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(px),
                        numtoks=numtoks, attn_mask=torch.from_numpy(mask),
                        out_len=L, padding_side="left")
    assert gating is None
    np.testing.assert_allclose(got.embeds.numpy(), np.asarray(want.embeds),
                               atol=1e-4)
    for name in ("labels", "attn_mask", "position_ids", "lengths"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("scales,size", [((56, 112), 112), ((56, 112, 168), 168),
                                          ((56,), 56)])
def test_s2_multiscale_forward(models, scales, size):
    """``s2_multiscale_forward`` against JAX's at the shapes of
    ``tests/test_s2.py`` (and three scales, a 3 x 3 grid shrunk by an
    antialiased resize), float32 within 1e-4; one scale gives the tower's
    patch features bit for bit."""
    jcfg, jp, tcfg, tp = models
    px = _pixels(4, size=size)
    want = np.asarray(jclip.s2_multiscale_forward(
        jp["vision_tower"], jnp.asarray(px), jcfg.vision, scales=scales))
    got = tclip.s2_multiscale_forward(tp["vision_tower"],
                                      torch.from_numpy(px), tcfg.vision,
                                      scales=scales)
    assert got.shape == (2, 16, 32 * len(scales)) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    if len(scales) == 1:
        one = tclip.clip_vision_forward(tp["vision_tower"],
                                        torch.from_numpy(px), tcfg.vision)
        assert torch.equal(got, one["patch"])
    with pytest.raises(ValueError, match="image size"):
        tclip.s2_multiscale_forward(tp["vision_tower"], torch.from_numpy(px),
                                    tcfg.vision, scales=(112,))
