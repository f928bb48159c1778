"""PyTorch port: the lmms-eval adapters that answer through a server.

* ``llava_sglang``: a 3-doc task through ``simple_evaluate`` and the
  adapter's in-process SGLang worker (paged continuous batcher with the
  prefix cache, ``parallel=3``, ``max_batch=2``) over the tiny LLaVA
  directory of ``tests/test_torch_eval_generators.py`` in float32: every
  answer equals the port's own ``generate`` on the same prompt and image,
  ``close()`` leaves no thread behind, and a second run in the same
  process answers the same.  ``loglikelihood`` raises
  ``NotImplementedError``.  The JAX worker is not the reference here: with
  ``prefix_cache=True`` its batcher drifts from its own ``generate`` on
  prompts that share their first pages (ROADMAP.md Queue 3).
* ``gpt4v``: one fake ``post_fn`` in both packages gives equal payloads and
  answers; without a key the port raises ``ConfigError`` at once.
"""

import base64
import io
import json
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from matryoshka_mm_tpu.lmms_eval.api import registry as jreg
from matryoshka_mm_tpu.lmms_eval.api.task import ConfigurableTask as JTask
from matryoshka_mm_torch.lmms_eval import evaluator as tev
from matryoshka_mm_torch.lmms_eval.api import registry as treg
from matryoshka_mm_torch.lmms_eval.api.task import ConfigurableTask as TTask
from matryoshka_mm_torch.models import builder
from tests.test_torch_eval_generators import _f32_torch, model_dir  # noqa: F401
from tests.test_torch_families_loader import _crc_words

SCALE = "ver=v0_numtoks=16"
NEW_TOKENS = 6


@pytest.fixture(scope="module")
def model_worker():
    """The port's worker module; importing it sends stdout and stderr into
    its logger, so they are restored."""
    saved = sys.stdout, sys.stderr
    try:
        from matryoshka_mm_torch.serve import model_worker as mw
    finally:
        sys.stdout, sys.stderr = saved
    return mw


def _task(root, name):
    rng = np.random.default_rng(7)
    for i, (w, h) in enumerate([(320, 240), (200, 300)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            root / f"g{i}.png")
    docs = [{"question": "What color is it?", "answer": "green",
             "image": "g0.png"},
            {"question": "How many dogs are there?", "answer": "0",
             "image": "g1.png"},
            {"question": "Is it indoors or outdoors?", "answer": "outdoors",
             "image": "g0.png"}]
    (root / "docs.json").write_text(json.dumps(docs))
    return {"task": name, "dataset_path": str(root / "docs.json"),
            "doc_to_visual": "image", "doc_to_text": "{question}",
            "doc_to_target": "answer",
            "dataset_kwargs": {"image_folder": str(root)},
            "generation_kwargs": {"max_new_tokens": NEW_TOKENS,
                                  "temperature": 0.0},
            "metric_list": [{"metric": "exact_match"}]}


def _direct_answers(model_dir, task):  # noqa: F811
    """The port's ``generate`` on each doc's prompt and PNG image, decoded
    as the adapter reads the worker's text."""
    from matryoshka_mm_torch.conversation import conv_templates
    from matryoshka_mm_torch.mm_utils import (process_images,
                                              tokenizer_image_token)

    tok, model, proc, _ = builder.load_pretrained_model(model_dir,
                                                        device="cpu")
    model = _f32_torch(model)
    out = []
    for inst in TTask(task).build_instances():
        context, gen_kwargs, visual = inst.arguments
        conv = conv_templates["vicuna_v1"].copy()
        conv.append_message(conv.roles[0], "<image>\n" + context)
        conv.append_message(conv.roles[1], None)
        ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tok),
                         np.int32)[None]
        buf = io.BytesIO()
        visual.convert("RGB").save(buf, format="PNG")
        image = Image.open(io.BytesIO(buf.getvalue())).convert("RGB")
        px = np.asarray(process_images([image], proc, model.config),
                        np.float32)
        gen = model.generate(ids, images=px, matryoshka_vis_token_scale=SCALE,
                             max_new_tokens=gen_kwargs["max_new_tokens"],
                             eos_token_id=2, pad_token_id=0)
        text = tok.batch_decode(gen, skip_special_tokens=True)[0]
        out.append(text.split(conv.sep2)[0].strip())
    return out


def test_llava_sglang_answers_equal_generate(model_worker, model_dir,  # noqa: F811
                                             tmp_path, monkeypatch):
    monkeypatch.setattr(builder.DebugTokenizer, "__call__", _crc_words)
    real = model_worker.load_pretrained_model

    def load(*a, **kw):
        tok, model, proc, ctx = real(*a, **kw)
        return tok, _f32_torch(model), proc, ctx

    monkeypatch.setattr(model_worker, "load_pretrained_model", load)
    task = _task(tmp_path, "toy_sglang_19")
    monkeypatch.setitem(treg.TASK_REGISTRY, task["task"], task)
    want = _direct_answers(model_dir, task)
    before = set(threading.enumerate())
    runs = []
    for _ in range(2):
        res = tev.simple_evaluate(
            model="llava_sglang",
            model_args=f"pretrained={model_dir},parallel=3,max_batch=2,"
                       f"device=cpu",
            tasks=[task["task"]], matryoshka_vis_token_scale=SCALE,
            log_samples=True)
        runs.append([s["resps"][0] for s in res["samples"][task["task"]]])
        assert res["results"][task["task"]]["samples"] == 3
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
        assert not left, left
    assert runs[0] == want and runs[1] == want
    assert all(isinstance(t, str) for t in want) and any(want), want


def test_llava_sglang_loglikelihood_unsupported():
    cls = treg.get_model("llava_sglang")
    lm = cls.__new__(cls)           # no worker needed for this
    with pytest.raises(NotImplementedError):
        lm.loglikelihood([])


def _fake_post(calls):
    def post(payload):
        calls.append(payload)
        parts = payload["messages"][0]["content"]
        n_img = sum(p["type"] == "image_url" for p in parts)
        return {"choices": [{"message": {"content": f" red {n_img} "}}]}
    return post


def test_gpt4v_payloads_and_answers_as_jax(tmp_path, monkeypatch):
    task = _task(tmp_path, "toy_api_19")
    task["generation_kwargs"] = {"max_new_tokens": 8, "temperature": 0.0}
    got, want = [], []
    outs = []
    for reg, Task, calls in ((jreg, JTask, want), (treg, TTask, got)):
        lm = reg.get_model("gpt4v")(model_version="test-model",
                                    post_fn=_fake_post(calls))
        insts = Task(task).build_instances()
        # one request with two images, one with none
        insts[1].arguments = (insts[1].arguments[0], insts[1].arguments[1],
                              [insts[0].arguments[2]] * 2)
        insts[2].arguments = (insts[2].arguments[0], {}, None)
        outs.append(lm.generate_until(insts))
        with pytest.raises(NotImplementedError):
            lm.loglikelihood(insts)
    assert outs[1] == outs[0] == ["red 1", "red 2", "red 0"]
    assert got == want and len(got) == 3
    url = got[0]["messages"][0]["content"][1]["image_url"]["url"]
    assert Image.open(io.BytesIO(base64.b64decode(
        url.split(",", 1)[1]))).size == (320, 240)
    assert [c["max_tokens"] for c in got] == [8, 8, 128]

    from matryoshka_mm_torch.lmms_eval.models.gpt4v import ConfigError

    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    lm = treg.get_model("gpt4v")(max_retries=3)
    with pytest.raises(ConfigError, match="OPENAI_API_KEY"):
        lm.generate_until(TTask(task).build_instances()[:1])
