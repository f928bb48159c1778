"""PyTorch port: the lmms-eval ``llava`` adapter's ``loglikelihood``
against the JAX package's, on the fixtures of
``tests/test_torch_lmms_eval.py`` (one tiny LLaVA directory loaded by both
packages in float32, CRC-32 word ids):

* 3 requests, two with an image and one text-only whose continuation is
  the model's own greedy word: the logprob within 1e-4 relative, the
  greedy flag exact;
* a splice clipped before the continuation: the port raises, where the
  JAX adapter answers (0.0, True) (a fault of the reference);
* a ``loglikelihood`` task through ``simple_evaluate``: the port's samples
  equal the JAX adapter's ``loglikelihood`` on the same requests, while the
  JAX package's ``simple_evaluate`` cannot run such a task (a fault of the
  reference: its instances carry the generation kwargs where the adapter
  reads the continuation).
"""

import json
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from matryoshka_mm_tpu.lmms_eval import evaluator as jev
from matryoshka_mm_tpu.lmms_eval.api import instance as jinst
from matryoshka_mm_tpu.lmms_eval.api import registry as jreg
from matryoshka_mm_tpu.lmms_eval.tasks import task_utils as jtu
from matryoshka_mm_torch.lmms_eval import evaluator as tev
from matryoshka_mm_torch.lmms_eval.api import instance as tinst
from matryoshka_mm_torch.lmms_eval.api import registry as treg
from matryoshka_mm_torch.lmms_eval.tasks import task_utils as ttu
from tests.test_torch_lmms_eval import SCALE, both, model_dir, task  # noqa: F401

RTOL = 1e-4          # logprob, float32 on both sides


def _greedy_word(lm, context, tokenizer):
    """A word whose CRC-32 id is the port model's greedy next token after
    the text-only ``context`` prompt."""
    from matryoshka_mm_torch.models.llama import llama_logits

    ids = tokenizer(lm._build_prompt(context, False)).input_ids
    with torch.inference_mode():
        logits = llama_logits(lm.model.params["llama"], lm.model.cfg.llama,
                              torch.tensor([ids]))
    target = int(logits[0, -1].argmax())
    span = tokenizer.vocab_size - 100
    words = (f"w{k}" for k in range(10**6))
    word = next((w for w in words
                 if zlib.crc32(w.encode()) % span + 100 == target), None)
    assert word is not None, f"no short word maps to token {target}"
    return word


def _requests(mod, task, greedy_word):
    """The first is the task's first doc as its instance carries it; the
    two image requests splice to one length, so the JAX side compiles its
    ops for one shape."""
    cfg, root = task
    img = [Image.open(root / f"img{i}.png").convert("RGB") for i in range(2)]
    post = cfg["post_prompt"]
    rows = [("Is there a dog in the image?" + post, " yes", img[0]),
            ("Which colours are here?" + post, " mostly red and blue",
             img[1]),
            ("Name one animal.", " " + greedy_word, None)]
    return [mod.Instance("loglikelihood", {}, r, 0, "ll", i)
            for i, r in enumerate(rows)]


@pytest.fixture(scope="module")
def adapters(both, model_dir):  # noqa: F811
    kw = dict(pretrained=model_dir, matryoshka_vis_token_scale=SCALE)
    return (jreg.get_model("llava")(**kw),
            treg.get_model("llava")(device="cpu", **kw))


def test_loglikelihood_as_jax(adapters, task):
    jlm, tlm = adapters
    word = _greedy_word(tlm, "Name one animal.", tlm.tokenizer)
    want = jlm.loglikelihood(_requests(jinst, task, word))
    got = tlm.loglikelihood(_requests(tinst, task, word))
    assert [g for _, g in got] == [g for _, g in want]
    assert got[2][1], "the greedy word must be scored greedy"
    np.testing.assert_allclose([lp for lp, _ in got],
                               [lp for lp, _ in want], rtol=RTOL)
    assert all(np.isfinite(lp) and lp < 0 for lp, _ in got)


def test_clipped_continuation_raises_where_jax_scores_nothing(
        adapters, task, monkeypatch):
    """A splice clipped to ``tokenizer_model_max_length`` just before the
    continuation: the port raises ``ValueError``, while the JAX adapter
    scores no token and answers (0.0, True), probability 1 and greedy (a
    fault of the reference, ROADMAP.md Queue 3)."""
    import dataclasses

    from matryoshka_mm_torch.mm_utils import tokenizer_image_token

    jlm, tlm = adapters
    context = _requests(tinst, task, "cat")[0].arguments[0]
    n_ctx = len(tokenizer_image_token(tlm._build_prompt(context, True),
                                      tlm.tokenizer))
    numtoks = int(SCALE.rsplit("=", 1)[1])
    for lm in (jlm, tlm):       # the image's tokens replace the sentinel
        monkeypatch.setattr(lm.model, "cfg", dataclasses.replace(
            lm.model.cfg, tokenizer_model_max_length=n_ctx + numtoks - 1))
    assert jlm.loglikelihood(
        _requests(jinst, task, "cat")[:1]) == [(0.0, True)]
    with pytest.raises(ValueError, match="keeps 0 of the continuation"):
        tlm.loglikelihood(_requests(tinst, task, "cat")[:1])


def test_loglikelihood_task_through_simple_evaluate(adapters, task,
                                                    monkeypatch):
    """The port's instances carry ``(context, " " + target, visual)``;
    its samples equal the JAX adapter's on those requests.  The JAX
    package's own ``simple_evaluate`` fails on the same task."""
    cfg, root = task
    hook = {"greedy": lambda doc, result: {"greedy": float(result[1])}}
    for tu in (jtu, ttu):
        monkeypatch.setattr(tu, "ll_greedy_19", hook["greedy"],
                            raising=False)
    ll = dict(cfg, task="pope_ll_19", output_type="loglikelihood",
              process_results="task_utils.ll_greedy_19",
              metric_list=[{"metric": "greedy"}])
    for reg in (jreg, treg):
        monkeypatch.setitem(reg.TASK_REGISTRY, ll["task"], ll)
    jlm, tlm = adapters
    monkeypatch.setitem(treg.MODEL_REGISTRY, "llava", lambda **kw: tlm)
    got = tev.simple_evaluate(model="llava", model_args="device=cpu",
                              tasks=[ll["task"]], limit=1,
                              matryoshka_vis_token_scale=SCALE,
                              log_samples=True)
    doc = json.loads((root / "pope.json").read_text())[0]
    context = doc["question"] + cfg["post_prompt"]
    img = Image.open(root / doc["image"]).convert("RGB")
    want = jlm.loglikelihood([jinst.Instance(
        "loglikelihood", doc, (context, " " + doc["answer"], img), 0,
        ll["task"], 0)])
    sample = got["samples"][ll["task"]][0]
    assert len(sample["resps"]) == 1
    lp, greedy = sample["resps"][0]
    assert greedy == want[0][1]
    np.testing.assert_allclose(lp, want[0][0], rtol=RTOL)
    assert got["results"][ll["task"]]["greedy"] == float(greedy)

    monkeypatch.setitem(jreg.MODEL_REGISTRY, "llava", lambda **kw: jlm)
    with pytest.raises(AttributeError, match="dict"):
        jev.simple_evaluate(model="llava", tasks=[ll["task"]], limit=1,
                            matryoshka_vis_token_scale=SCALE)
