"""PyTorch port: the lmms-eval ``llava`` adapter against the JAX package's.

Both packages load the same tiny LLaVA directory (the one of
``tests/test_torch_eval_generators.py``: ``transformers`` random-init
models, 2 decoder layers 32 wide, a CLIP tower 48 wide at 336 pixels),
cast it to float32, and number words by CRC-32.  Then:

``generate_until`` runs through ``simple_evaluate`` on a local
POPE-style task of 4 docs over seeded images (8 new tokens at most): the
port's ``results`` (every metric and its ``_stderr``; ``time_s`` is a wall
clock) and ``samples`` equal the JAX package's at ``batch_size`` 1 and 2,
and the port's batch 2 equals its batch 1.
``tests/test_torch_lmms_eval_loglik.py`` holds ``loglikelihood`` on the
same fixtures.
"""

import json

import numpy as np
import pytest
from PIL import Image

from matryoshka_mm_tpu.lmms_eval.api import registry as jreg
from matryoshka_mm_tpu.lmms_eval import evaluator as jev
from matryoshka_mm_tpu.lmms_eval.models import llava as jllava
from matryoshka_mm_tpu.models import builder as jax_builder
from matryoshka_mm_torch.lmms_eval.api import registry as treg
from matryoshka_mm_torch.lmms_eval import evaluator as tev
from matryoshka_mm_torch.lmms_eval.models import llava as tllava
from matryoshka_mm_torch.models import builder
from tests.test_torch_eval_generators import (_f32_jax, _f32_torch,
                                             model_dir)  # noqa: F401
from tests.test_torch_families_loader import _crc_words

SCALE = "ver=v0_numtoks=16"
NEW_TOKENS = 8
SIZES = [(500, 375), (640, 480)]
OBJECTS = ["dog", "car", "clock", "chair"]


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """A 4-doc POPE-style task (two questions an image, equal word counts)
    registered in both packages while this module runs; yields its config
    and the image folder."""
    root = tmp_path_factory.mktemp("lmms")
    rng = np.random.default_rng(19)
    for i, (w, h) in enumerate(SIZES):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            root / f"img{i}.png")
    docs = [{"question": f"Is there a {obj} in the image?",
             "answer": "yes" if i % 3 == 0 else "no",
             "image": f"img{i // 2}.png"} for i, obj in enumerate(OBJECTS)]
    (root / "pope.json").write_text(json.dumps(docs))
    cfg = {"task": "pope_local_19", "dataset_path": str(root / "pope.json"),
           "doc_to_visual": "image", "doc_to_text": "{question}",
           "post_prompt": "\nAnswer the question using a single word or "
                          "phrase.",
           "doc_to_target": "answer",
           "dataset_kwargs": {"image_folder": str(root)},
           "generation_kwargs": {"max_new_tokens": NEW_TOKENS,
                                 "temperature": 0.0},
           "metric_list": [{"metric": "exact_match"},
                           {"metric": "pope_yes_no"}]}
    for reg in (jreg, treg):
        reg.register_task(cfg["task"], cfg)
    yield cfg, root
    for reg in (jreg, treg):
        reg.TASK_REGISTRY.pop(cfg["task"])


@pytest.fixture(scope="module")
def both():
    """Both adapters load float32 weights and number words by CRC-32."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (builder.DebugTokenizer, jax_builder.DebugTokenizer):
            mp.setattr(cls, "__call__", _crc_words)
        for mod, f32 in ((jllava, _f32_jax), (tllava, _f32_torch)):
            real = mod.load_pretrained_model

            def load(*a, _real=real, _f32=f32, **kw):
                tok, model, proc, ctx = _real(*a, **kw)
                return tok, _f32(model), proc, ctx

            mp.setattr(mod, "load_pretrained_model", load)
        yield


@pytest.fixture(scope="module")
def runs(both, task, model_dir):  # noqa: F811
    """``simple_evaluate`` results by (package, batch size), on demand."""
    cache = {}

    def get(pkg, bs):
        if (pkg, bs) not in cache:
            ev = jev if pkg == "jax" else tev
            args = f"pretrained={model_dir},batch_size={bs}"
            if pkg == "torch":
                args += ",device=cpu"
            cache[pkg, bs] = ev.simple_evaluate(
                model="llava", model_args=args, tasks=[task[0]["task"]],
                matryoshka_vis_token_scale=SCALE, log_samples=True)
        return cache[pkg, bs]

    return get


def _comparable(results):
    out = json.loads(json.dumps(results, default=str))
    for agg in out["results"].values():
        agg.pop("time_s")
    return out


@pytest.mark.parametrize("bs", [1, 2])
def test_generate_until_through_simple_evaluate_as_jax(runs, task, bs):
    got, want = _comparable(runs("torch", bs)), _comparable(runs("jax", bs))
    name = task[0]["task"]
    assert got == want
    agg = got["results"][name]
    assert agg["samples"] == len(OBJECTS)
    assert {"exact_match", "exact_match_stderr", "pope_yes_no",
            "pope_yes_no_stderr"} <= set(agg)
    resps = [s["resps"] for s in got["samples"][name]]
    assert all(isinstance(r[0], str) for r in resps)
    if bs == 2:
        first = _comparable(runs("torch", 1))
        assert got["samples"] == first["samples"]
        assert got["results"] == first["results"]
