"""PyTorch port, ``beam_generate`` against the JAX package on the tiny
configs (one image a row, and the anyres tiles of
``tests/test_torch_anyres.py``), the JAX weights carried across by
``params_from_jax``; float32 on both sides, so the chosen hypothesis is
the same token for token."""

import jax
import numpy as np
import pytest

from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGenConfig,
                                        beam_generate as jax_beam)
from matryoshka_mm_tpu.models.builder import LlavaModel as JaxLlavaModel
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_torch.generate import (GenerationConfig, beam_generate,
                                          generate)
from matryoshka_mm_torch.models.builder import LlavaModel
from matryoshka_mm_torch.models.convert import params_from_jax
from tests.test_torch_anyres import _cfgs, jax_init

SCALE = "ver=v0_numtoks=4"


@pytest.fixture(scope="module")
def models():
    jcfg = JaxLlavaConfig.tiny_debug()
    jparams = init_llava_params(jax.random.PRNGKey(0), jcfg)
    tcfg = LlavaConfig.tiny_debug()
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _image(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (1, 3, 56, 56)).astype(np.float32)


def _both(models, ids, px, num_beams, new=6, eos=2, **kw):
    jcfg, jp, tcfg, tp = models
    want = np.asarray(jax_beam(jp, jcfg, ids, px, num_beams=num_beams,
                               gen_cfg=JaxGenConfig(max_new_tokens=new,
                                                    eos_token_id=eos), **kw))
    got = beam_generate(tp, tcfg, ids, px, num_beams=num_beams,
                        gen_cfg=GenerationConfig(max_new_tokens=new,
                                                 eos_token_id=eos), **kw)
    assert got.dtype == np.int32 and got.shape[0] == 1
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("num_beams", [1, 3])
@pytest.mark.parametrize("case", ["text", "image"])
def test_beam_equals_jax(models, case, num_beams):
    if case == "text":
        ids, px, kw = np.array([[5, 9, 12, 7]], np.int32), None, {}
    else:
        ids = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42, 9]], np.int32)
        px, kw = _image(), dict(matryoshka_vis_token_scale=SCALE)
    got = _both(models, ids, px, num_beams, **kw)
    if num_beams == 1:
        _, _, tcfg, tp = models
        greedy = generate(tp, tcfg, ids, px,
                          gen_cfg=GenerationConfig(max_new_tokens=6), **kw)
        np.testing.assert_array_equal(got, greedy)


def test_beam_with_length_penalty_eos_and_stopping_criteria(models):
    """An EOS that beams bank (the 2nd greedy token), a length penalty, and
    a stopping criterion that cuts the chosen hypothesis after the search:
    the JAX result in each."""
    _, _, tcfg, tp = models
    ids = np.array([[7, IMAGE_TOKEN_INDEX, 11, 3]], np.int32)
    px = _image(2)
    kw = dict(matryoshka_vis_token_scale=SCALE)
    free = generate(tp, tcfg, ids, px, gen_cfg=GenerationConfig(
        max_new_tokens=6, eos_token_id=-1), **kw)[0]
    _both(models, ids, px, 3, new=7, eos=int(free[1]), length_penalty=0.6,
          **kw)
    stop = int(free[2])
    _both(models, ids, px, 3, new=7, eos=-1, length_penalty=1.3,
          stopping_criteria=lambda row: stop in row, **kw)


def test_beam_of_an_anyres_stack_equals_jax():
    jcfg, tcfg = _cfgs()
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ids = np.array([[1, 5, 17, IMAGE_TOKEN_INDEX, 42, 9]], np.int32)
    tiles = np.random.default_rng(2).standard_normal(
        (1, 3, 3, 56, 56)).astype(np.float32)
    _both((jcfg, jp, tcfg, tp), ids, tiles, 3, image_sizes=[(300, 120)],
          matryoshka_vis_token_scale="ver=v0_numtoks=16")


def test_beam_through_the_facade_equals_jax(models):
    jcfg, jp, tcfg, tp = models
    ids = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42, 9]], np.int32)
    kw = dict(images=_image(3), matryoshka_vis_token_scale=SCALE,
              num_beams=3, max_new_tokens=5)
    want = JaxLlavaModel(jp, jcfg).generate(ids, **kw)
    got = LlavaModel(tp, tcfg).generate(ids, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_beam_errors(models):
    _, _, tcfg, tp = models
    ids = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42]], np.int32)
    with pytest.raises(ValueError, match="batch_size=1"):
        beam_generate(tp, tcfg, np.repeat(ids, 2, 0), np.repeat(_image(), 2, 0))
    with pytest.raises(ValueError, match="does not compose"):
        beam_generate(tp, tcfg, ids, _image(),
                      matryoshka_vis_token_scale="ver=v2_numtoks=[1,4]_"
                                                 "betas=[0.5,0.5]")
    with pytest.raises(ValueError, match="one image per prompt"):
        beam_generate(tp, tcfg, ids, np.repeat(_image(), 2, 0))
