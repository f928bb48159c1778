"""The port's own copies of the framework-free modules (constants, kvconfig,
conversation, mm_utils, image_processing) give what the JAX package's
originals give.  Everything here is exact: the copies run the same numpy /
PIL code."""

import numpy as np
import pytest

from matryoshka_mm_tpu import (constants as jc, conversation as jconv,
                               image_processing as jip, kvconfig as jkv,
                               mm_utils as jmm)
from matryoshka_mm_torch import (constants as tc, conversation as tconv,
                                 image_processing as tip, kvconfig as tkv,
                                 mm_utils as tmm)

SPECS = ["ver=v0_numtoks=9", "ver=v0_numtoks=[1,9,36,144,576]",
         "ver=v0_numtoks=gateprobargmax",
         "ver=v2_numtoks=[1,4]_betas=[0.5,0.5]", "ver=v1_numtoks=144_x=1.5"]


def test_constants_equal():
    names = [n for n in dir(jc) if n.isupper()]
    assert names and names == [n for n in dir(tc) if n.isupper()]
    for n in names:
        assert getattr(tc, n) == getattr(jc, n), n


@pytest.mark.parametrize("spec", SPECS)
def test_kvconfig_parsers_equal(spec):
    want = jkv.parse_kv_from_string(spec)
    assert tkv.parse_kv_from_string(spec) == want
    if isinstance(want["numtoks"], str) and want["numtoks"].startswith("["):
        assert tkv.parse_list(want["numtoks"]) == \
            jkv.parse_list(want["numtoks"])
    if want["numtoks"] != "gateprobargmax":
        assert tkv.tokscales_from_spec(spec) == jkv.tokscales_from_spec(spec)


@pytest.mark.parametrize("template", ["llava_v1", "vicuna_v1"])
def test_conversation_prompts_equal(template):
    prompts = []
    for mod in (jconv, tconv):
        conv = mod.conv_templates[template].copy()
        conv.append_message(conv.roles[0], "<image>\nWhat is shown?")
        conv.append_message(conv.roles[1], "A cat.")
        conv.append_message(conv.roles[0], "And now?")
        conv.append_message(conv.roles[1], None)
        prompts.append((conv.get_prompt(), conv.sep_style.name, conv.sep,
                        conv.sep2))
    assert prompts[0] == prompts[1]
    assert sorted(jconv.conv_templates) == sorted(tconv.conv_templates)


class _Tok:
    """Whitespace tokenizer with a BOS, enough for tokenizer_image_token."""

    bos_token_id = 1

    def __call__(self, text):
        ids = [self.bos_token_id] + [3 + (sum(map(ord, w)) % 500)
                                     for w in text.split()]
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


@pytest.mark.parametrize("prompt", ["<image>\nWhat is shown?", "no image",
                                    "a <image> b <image> c", ""])
def test_tokenizer_image_token_equal(prompt):
    want = jmm.tokenizer_image_token(prompt, _Tok())
    assert tmm.tokenizer_image_token(prompt, _Tok()) == want
    np.testing.assert_array_equal(
        tmm.tokenizer_image_token(prompt, _Tok(), return_tensors="np"),
        jmm.tokenizer_image_token(prompt, _Tok(), return_tensors="np"))
    assert tmm.get_model_name_from_path("a/b/checkpoint-7/") == \
        jmm.get_model_name_from_path("a/b/checkpoint-7/")
    crit = [m.KeywordsStoppingCriteria(["7 8"], _Tok(), 2)
            for m in (jmm, tmm)]
    for ids in ([5, 6, 7], [5, 6, 7, 8], [1, 2]):
        assert crit[0](ids) == crit[1](ids)


def _pil_only(monkeypatch):
    """The JAX package's processor takes its optional C++ path when a
    compiler is around; the copy carries the PIL path only."""
    import matryoshka_mm_tpu.native as native

    monkeypatch.setattr(native, "native_available", lambda: False)


@pytest.mark.parametrize("size", [(80, 64), (336, 336), (500, 340)])
def test_clip_preprocess_pil_path_exact(size, monkeypatch):
    from PIL import Image

    _pil_only(monkeypatch)
    arr = np.random.default_rng(sum(size)).integers(
        0, 256, (size[1], size[0], 3)).astype(np.uint8)
    img = Image.fromarray(arr)
    want = jip.ClipImageProcessor().preprocess(img)["pixel_values"]
    got = tip.ClipImageProcessor().preprocess(img)["pixel_values"]
    assert got.dtype == np.float32 and got.shape == (1, 3, 336, 336)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["pad", "anyres", None])
def test_process_images_equal(mode, monkeypatch):
    from PIL import Image

    _pil_only(monkeypatch)
    rng = np.random.default_rng(5)
    imgs = [Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
            for h, w in ((90, 120), (200, 100))]
    cfg = type("Cfg", (), {"image_aspect_ratio": mode,
                           "image_grid_pinpoints": "[[672, 672], [336, 672]]"})
    small = dict(size={"shortest_edge": 56},
                 crop_size={"height": 56, "width": 56})
    want = jip.process_images(imgs, jip.ClipImageProcessor(**small), cfg)
    got = tip.process_images(imgs, tip.ClipImageProcessor(**small), cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tip.expand2square(imgs[0], (1, 2, 3)).size == \
        jip.expand2square(imgs[0], (1, 2, 3)).size == (120, 120)
    assert tip.get_anyres_image_grid_shape((100, 200), [[672, 672],
                                                        [336, 672]], 336) == \
        jip.get_anyres_image_grid_shape((100, 200), [[672, 672], [336, 672]],
                                        336)
    assert not hasattr(tip, "normalize_images_jnp")
