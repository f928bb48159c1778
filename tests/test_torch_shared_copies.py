"""The port's own copies of the framework-free modules (constants, kvconfig,
conversation, mm_utils, image_processing with its native hook, igvlm/grid,
train/data, train/sampler) give what the JAX package's originals give, and
its copied data (the lmms-eval task corpus, the metric and filter tables,
the IG-VLM judge rubrics, config/model_config.py) equals the originals.
Everything here is exact: the copies run the same numpy / PIL / C++
code."""

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
    """Both processors take their optional C++ path when a compiler is
    around: here they take the PIL path."""
    import matryoshka_mm_torch.native as tnative
    import matryoshka_mm_tpu.native as native

    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setattr(tnative, "native_available", lambda: False)


@pytest.mark.parametrize("size", [(80, 64), (336, 336), (500, 340)])
def test_clip_preprocess_native_hook_exact(size, monkeypatch):
    """The port's processor takes its native path where the JAX package's
    does, with the same bits, which are the PIL path's."""
    from PIL import Image

    import matryoshka_mm_torch.native as tnative
    import matryoshka_mm_tpu.native as native

    if not (native.native_available() and tnative.native_available()):
        pytest.skip("no C++ compiler here")
    calls = []
    real = tnative.clip_preprocess_native
    monkeypatch.setattr(tnative, "clip_preprocess_native",
                        lambda *a: calls.append(a) or real(*a))
    arr = np.random.default_rng(sum(size)).integers(
        0, 256, (size[1], size[0], 3)).astype(np.uint8)
    img = Image.fromarray(arr)
    want = jip.ClipImageProcessor().preprocess(img)["pixel_values"]
    got = tip.ClipImageProcessor().preprocess(img)["pixel_values"]
    assert len(calls) == 1
    np.testing.assert_array_equal(got, want)
    _pil_only(monkeypatch)
    np.testing.assert_array_equal(
        tip.ClipImageProcessor().preprocess(img)["pixel_values"], got)
    assert len(calls) == 1


def test_grid_copy_equal(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from matryoshka_mm_torch.igvlm import grid as tgrid
    from matryoshka_mm_tpu.igvlm import grid as jgrid

    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((40, 60), (48, 64), (40, 50), (30, 70), (44, 44))]
    for n in (1, 2, 5):
        assert tgrid.default_max_per_row(n) == jgrid.default_max_per_row(n)
        np.testing.assert_array_equal(tgrid.create_grid_view(frames[:n]),
                                      jgrid.create_grid_view(frames[:n]))
    path = str(tmp_path / "v.avi")
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    for i in range(20):
        out.write(np.full((48, 64, 3), 10 * i, np.uint8))
    out.release()
    for kw in ({}, {"ts": (0.5, 1.5)}):
        got = tgrid.extract_frames(path, 6, **kw)
        want = jgrid.extract_frames(path, 6, **kw)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


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


# ---------------------------------------------------------------------------
# train/data.py and train/sampler.py
# ---------------------------------------------------------------------------

class _WordTok:
    """Whitespace tokenizer with the attributes the preprocessors read."""

    bos_token_id, pad_token_id, model_max_length, legacy = 1, 0, 64, True

    def __call__(self, text):
        ids = [1] + [2 if w == "</s>" else 3 + (sum(map(ord, w)) % 400)
                     for w in text.replace("</s>", " </s> ").split()]
        return type("Enc", (), {"input_ids": ids})()


_SOURCE = [{"from": "human", "value": "<image>\nwhat is this"},
           {"from": "gpt", "value": "a small tree"},
           {"from": "human", "value": "and the colour"},
           {"from": "gpt", "value": "green all over"}]


@pytest.mark.parametrize("template", ["v1", "plain", "llama_2", "mpt", "v0"])
def test_preprocess_equal(template):
    import copy

    from matryoshka_mm_tpu.train import data as jdata
    from matryoshka_mm_torch.train import data as tdata

    outs = []
    for conv, data in ((jconv, jdata), (tconv, tdata)):
        old = conv.default_conversation
        conv.default_conversation = conv.conv_templates[template]
        try:
            args = data.DataArguments(is_multimodal=True)
            src = data.preprocess_multimodal(
                [copy.deepcopy(_SOURCE[:2] if template == "plain"
                               else _SOURCE)], args)
            outs.append(data.preprocess(src, _WordTok(), has_image=True))
        finally:
            conv.default_conversation = old
    for key in ("input_ids", "labels"):
        np.testing.assert_array_equal(outs[1][key][0], outs[0][key][0])
    assert (outs[1]["labels"][0] == tc.IGNORE_INDEX).any()


def test_collator_and_dataset_equal(tmp_path):
    import json

    from PIL import Image

    from matryoshka_mm_tpu.train import data as jdata
    from matryoshka_mm_torch.train import data as tdata

    Image.new("RGB", (40, 30), (10, 200, 30)).save(tmp_path / "a.png")
    rows = [{"id": "0", "image": "a.png", "conversations": _SOURCE},
            {"id": "1", "conversations": _SOURCE[2:]}]
    (tmp_path / "d.json").write_text(json.dumps(rows))
    small = dict(size={"shortest_edge": 56},
                 crop_size={"height": 56, "width": 56})
    batches = []
    for data, ip in ((jdata, jip), (tdata, tip)):
        args = data.DataArguments(
            data_path=str(tmp_path / "d.json"), image_folder=str(tmp_path),
            is_multimodal=True, image_aspect_ratio="pad",
            image_processor=ip.ClipImageProcessor(**small))
        module = data.make_supervised_data_module(_WordTok(), args)
        ds = module["train_dataset"]
        assert len(ds) == 2
        batches.append((module["data_collator"]([ds[0], ds[1]]), ds.lengths,
                        ds.modality_lengths))
    (got, glen, gmod), (want, wlen, wmod) = batches[1], batches[0]
    assert set(got) == set(want) and glen == wlen and gmod == wmod
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["input_ids"].shape[1] % 64 == 0


@pytest.mark.parametrize("kw", [{}, {"group_by_modality": True},
                                {"variable_length": True}])
def test_samplers_equal(kw):
    from matryoshka_mm_tpu.train import sampler as jsamp
    from matryoshka_mm_torch.train import sampler as tsamp

    lengths = [int(x) for x in
               np.random.default_rng(0).integers(-50, 200, 37)]
    if not kw.get("group_by_modality"):
        lengths = [abs(x) + 1 for x in lengths]
    orders = [list(mod.LengthGroupedSampler(
        4, 2, lengths=lengths, generator=np.random.default_rng(5), **kw))
        for mod in (jsamp, tsamp)]
    assert orders[0] == orders[1] and sorted(orders[0]) == list(range(37))
    assert tsamp.split_to_even_chunks(list(range(10)), lengths[:10], 3) == \
        jsamp.split_to_even_chunks(list(range(10)), lengths[:10], 3)


# ---------------------------------------------------------------------------
# the harness's task corpus and tables, the IG-VLM rubrics, model presets
# ---------------------------------------------------------------------------

def _task_files(pkg):
    import importlib
    from pathlib import Path

    here = Path(importlib.import_module(f"{pkg}.lmms_eval.tasks").__file__)
    return sorted(p.name for p in here.parent.glob("*.yaml")), here.parent


def test_task_corpus_copied():
    """Every task file of the port is the JAX YAML, byte for byte, and
    loads to the same config."""
    yaml = pytest.importorskip("yaml")
    names, tdir = _task_files("matryoshka_mm_torch")
    jnames, jdir = _task_files("matryoshka_mm_tpu")
    assert names == jnames and len(names) == 46
    for n in names:
        assert (tdir / n).read_text() == (jdir / n).read_text(), n
        assert yaml.safe_load((tdir / n).read_text()) == \
            yaml.safe_load((jdir / n).read_text())


def test_metric_tables_and_rubrics_copied():
    from matryoshka_mm_torch.igvlm import evaluation as tev
    from matryoshka_mm_torch.lmms_eval.api import metrics as tm
    from matryoshka_mm_torch.lmms_eval.filters import FILTER_REGISTRY as tfr
    from matryoshka_mm_torch.lmms_eval.tasks import task_utils as ttu
    from matryoshka_mm_tpu.igvlm import evaluation as jev
    from matryoshka_mm_tpu.lmms_eval.api import metrics as jm
    from matryoshka_mm_tpu.lmms_eval.filters import FILTER_REGISTRY as jfr
    from matryoshka_mm_tpu.lmms_eval.tasks import task_utils as jtu

    assert {k: f.__name__ for k, f in tm.METRICS.items()} == \
        {k: f.__name__ for k, f in jm.METRICS.items()}
    assert sorted(tm.AGGREGATIONS) == sorted(jm.AGGREGATIONS)
    assert {k: f.__name__ for k, f in tfr.items()} == \
        {k: f.__name__ for k, f in jfr.items()}
    assert {k.name: v for k, v in tev._RUBRICS.items()} == \
        {k.name: v for k, v in jev._RUBRICS.items()}
    assert tev._CONSISTENCY_RUBRIC == jev._CONSISTENCY_RUBRIC
    assert tev._DICT_CONTRACT == jev._DICT_CONTRACT
    for name in ("_LLAVA_BENCH_RUBRIC", "_MMMU_DOMAINS", "_CMMMU_DOMAINS",
                 "_OPTION_LETTERS", "_MATHVISTA_KEYS"):
        assert getattr(ttu, name) == getattr(jtu, name), name


def test_model_config_presets_copied():
    from matryoshka_mm_torch import config as tcfg
    from matryoshka_mm_torch.config import model_config as tmc
    from matryoshka_mm_tpu import config as jcfg
    from matryoshka_mm_tpu.config import model_config as jmc

    assert tmc.MODEL_CONFIG_DICTS == jmc.MODEL_CONFIG_DICTS
    assert tcfg.ModelConfig == jcfg.ModelConfig
    assert sorted(tcfg.ModelConfig) == ["finetune_v0", "finetune_v4",
                                        "pretune_v0", "pretune_v4"]


def test_video_to_grid_image_copied(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from matryoshka_mm_torch.igvlm import grid as tgrid
    from matryoshka_mm_tpu.igvlm import grid as jgrid

    path = str(tmp_path / "v.mp4")
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 24))
    rng = np.random.default_rng(4)
    for _ in range(7):
        out.write(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    out.release()
    for n in (1, 4, 6):
        np.testing.assert_array_equal(
            np.asarray(tgrid.video_to_grid_image(path, n)),
            np.asarray(jgrid.video_to_grid_image(path, n)))
