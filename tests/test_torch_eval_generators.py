"""PyTorch port: the eval answer generators against the JAX package's.

Both packages load the same tiny LLaVA directory, written here from
``transformers`` random-init models (2 layers, hidden size 32, a CLIP
tower 48 wide at 336 pixels), and cast it to float32; both debug
tokenizers number words by CRC-32.  Each generator then runs through its
``build_parser().parse_args`` and ``eval_model`` in both packages on the
same questions and images, and the answers files must agree line for line
on every key but ``answer_id`` (a ``uuid4``): greedy tokens exactly equal.

Where a generator hard-codes ``max_new_tokens=1024`` (model_vqa,
model_vqa_science, model_qa), both packages' ``LlavaModel.generate`` are
wrapped the same way to cap an answer at ``CAP`` tokens, which keeps the
JAX side's decode short on the CPU.
"""

import argparse
import base64
import dataclasses
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from PIL import Image
from safetensors.torch import save_file

from matryoshka_mm_tpu.eval import model_qa as jqa
from matryoshka_mm_tpu.eval import model_vqa as jvqa
from matryoshka_mm_tpu.eval import model_vqa_loader as jloader
from matryoshka_mm_tpu.eval import model_vqa_mmbench as jmmbench
from matryoshka_mm_tpu.eval import model_vqa_qbench as jqbench
from matryoshka_mm_tpu.eval import model_vqa_science as jscience
from matryoshka_mm_tpu.models import builder as jax_builder
from matryoshka_mm_torch.eval import (model_qa, model_vqa, model_vqa_loader,
                                      model_vqa_mmbench, model_vqa_qbench,
                                      model_vqa_science)
from matryoshka_mm_torch.models import builder
from matryoshka_mm_torch.train.train import _cast_floats
from tests.test_torch_anyres_loader import (H_LM, H_VIS, IMG, PATCH, TOWER, V,
                                           _config)
from tests.test_torch_families_loader import _crc_words

CAP = 8                       # new tokens an answer where 1024 is hard-coded
SCALE = "ver=v0_numtoks=16"
IMAGE_SIZES = [(500, 375), (640, 480), (300, 420)]
QUESTIONS = ["Is there a dog in the image?",
             "What color is the car on the left side of the street?",
             "How many people are there?",
             "Is there a clock in the image? Answer the question using a "
             "single word or phrase.",
             "Describe the picture."]
MODELS = {"loader": (jloader, model_vqa_loader),
          "vqa": (jvqa, model_vqa), "science": (jscience, model_vqa_science),
          "qbench": (jqbench, model_vqa_qbench),
          "mmbench": (jmmbench, model_vqa_mmbench), "qa": (jqa, model_qa)}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The tiny LLaVA directory (``image_aspect_ratio: "pad"``), bf16
    safetensors as a released checkpoint holds them."""
    torch.manual_seed(0)
    lm = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=V, hidden_size=H_LM, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        rms_norm_eps=1e-5, rope_theta=10000.0))
    vis = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=H_VIS, intermediate_size=96, num_hidden_layers=3,
        num_attention_heads=4, image_size=IMG, patch_size=PATCH,
        layer_norm_eps=1e-5))
    g = torch.Generator().manual_seed(1)
    sd = dict(lm.state_dict())
    sd.update({TOWER + k: v for k, v in vis.state_dict().items()})
    for name, shape in (("0.weight", (H_LM, H_VIS)), ("0.bias", (H_LM,)),
                        ("2.weight", (H_LM, H_LM)), ("2.bias", (H_LM,))):
        sd[f"model.mm_projector.{name}"] = torch.randn(shape, generator=g) / 4
    path = tmp_path_factory.mktemp("eval") / "llava-tiny-eval"
    path.mkdir()
    save_file({k: v.to(torch.bfloat16).contiguous() for k, v in sd.items()},
              str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump(_config("pad", "flat", None), f)
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seeded images and each generator's question file."""
    root = tmp_path_factory.mktemp("evaldata")
    rng = np.random.default_rng(3)
    images = root / "images"
    images.mkdir()
    names = []
    for i, (w, h) in enumerate(IMAGE_SIZES):
        names.append(f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            images / names[-1])
    vqa = root / "questions.jsonl"
    with open(vqa, "w") as f:
        for i, q in enumerate(QUESTIONS):
            f.write(json.dumps({"question_id": 100 + i, "text": q,
                                "image": names[i % len(names)],
                                "category": "default"}) + "\n")
    science = root / "science.json"
    with open(science, "w") as f:
        json.dump([
            {"id": "s0", "image": names[0], "conversations": [
                {"from": "human", "value": "<image>\nWhich is a mammal?\n"
                 "Context: N/A\nOptions: (A) frog (B) cat"}]},
            {"id": "s1", "conversations": [
                {"from": "human", "value": "What is two plus two?\n"
                 "Options: (A) 3 (B) 4 (C) 5"}]},
            {"id": "s2", "image": names[2], "conversations": [
                {"from": "human", "value": "Which color is shown?\n"
                 "Options: (A) red (B) blue"}]}], f)
    qbench = root / "qbench.json"
    with open(qbench, "w") as f:
        json.dump([{"img_path": names[1], "question": "Is the image blurry?",
                    "candidates": ["yes", "no"], "correct_ans": "no"},
                   {"img_path": names[0], "question": "Which distortion is "
                    "the worst?", "candidates": ["noise", "blur", "none"]}],
                  f)
    mmbench = root / "mmbench.tsv"
    rows = []
    for i, (hint, opts) in enumerate(((None, "ABCD"),
                                      ("A hint about the scene.", "ABC"))):
        buf = io.BytesIO()
        Image.open(images / names[i]).save(buf, format="PNG")
        row = {"index": 7 + i, "question": f"Which object is {i}?",
               "hint": hint, "image": base64.b64encode(buf.getvalue())
               .decode(), "category": "x", "answer": "A"}
        for c in "ABCD":
            row[c] = f"option {c.lower()}{i}" if c in opts else None
        rows.append(row)
    import pandas as pd

    pd.DataFrame(rows).to_csv(mmbench, sep="\t", index=False)
    qa = root / "qa.jsonl"
    with open(qa, "w") as f:
        for i, q in enumerate(QUESTIONS[:2]):
            f.write(json.dumps({"question_id": i, "text": q}) + "\n")
    return {"root": root, "images": str(images), "vqa": str(vqa),
            "science": str(science), "qbench": str(qbench),
            "mmbench": str(mmbench), "qa": str(qa)}


def _as_f32(cfg):
    return dataclasses.replace(
        cfg, llama=dataclasses.replace(cfg.llama, dtype="float32"),
        vision=dataclasses.replace(cfg.vision, dtype="float32"))


def _f32_jax(model):
    params = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if jnp.issubdtype(a.dtype, jnp.floating) else a,
                          model.params)
    return jax_builder.LlavaModel(params, _as_f32(model.cfg))


def _f32_torch(model):
    return builder.LlavaModel(_cast_floats(model.params, torch.float32),
                              _as_f32(model.cfg))


@pytest.fixture
def both(monkeypatch):
    """Both packages' generators over float32 loads, CRC-32 word ids and
    answers capped at ``CAP`` tokens."""
    for cls in (builder.DebugTokenizer, jax_builder.DebugTokenizer):
        monkeypatch.setattr(cls, "__call__", _crc_words)
    for cls in (builder.LlavaModel, jax_builder.LlavaModel):
        real = cls.generate

        def capped(self, *a, _real=real, **kw):
            kw["max_new_tokens"] = min(kw.get("max_new_tokens", 128), CAP)
            return _real(self, *a, **kw)

        monkeypatch.setattr(cls, "generate", capped)
    for jmod, tmod in MODELS.values():
        for mod, f32 in ((jmod, _f32_jax), (tmod, _f32_torch)):
            real = mod.load_pretrained_model

            def load(*a, _real=real, _f32=f32, **kw):
                tok, model, proc, ctx = _real(*a, **kw)
                return tok, _f32(model), proc, ctx

            monkeypatch.setattr(mod, "load_pretrained_model", load)


def _run(mod, args, answers):
    mod.eval_model(argparse.Namespace(**vars(args),
                                      answers_file=str(answers)))
    with open(answers) as f:
        return [json.loads(line) for line in f]


def _args(mod, argv):
    """``argv`` through the port's parser (the JAX generator's flags and
    ``--device``), without the answers file."""
    args = vars(mod.build_parser().parse_args(
        argv + ["--device", "cpu", "--answers-file", "unused"]))
    del args["answers_file"]
    return argparse.Namespace(**args)


def _both(kind, argv, tmp_path, tag):
    """The JAX package's and the port's answers for ``argv``, parsed by the
    port's ``build_parser`` (the JAX generators but the loader build
    theirs under ``__main__``); the JAX ones ignore ``device``."""
    jmod, tmod = MODELS[kind]
    want = _run(jmod, _args(tmod, argv), tmp_path / f"{tag}-jax.jsonl")
    got = _run(tmod, _args(tmod, argv), tmp_path / f"{tag}-torch.jsonl")
    return want, got


def _same(want, got):
    assert len(got) == len(want) and got
    for w, g in zip(want, got):
        assert set(g) == set(w)
        if "answer_id" in g:        # q-bench's records carry none
            assert len(g["answer_id"]) == 8
        assert {k: v for k, v in g.items() if k != "answer_id"} == \
            {k: v for k, v in w.items() if k != "answer_id"}


def _loader_argv(model_dir, data, *extra):
    return ["--model-path", model_dir, "--image-folder", data["images"],
            "--question-file", data["vqa"], "--max_new_tokens", str(CAP),
            "--matryoshka_vis_token_scale", SCALE, *extra]


@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_loader_answers_as_jax(both, model_dir, data, tmp_path, batch_size):
    want, got = _both("loader", _loader_argv(
        model_dir, data, "--batch-size", str(batch_size)), tmp_path, "l")
    _same(want, got)
    assert [g["question_id"] for g in got] == \
        [q["question_id"] for q in jloader.get_chunk(
            [{"question_id": 100 + i} for i in range(len(QUESTIONS))], 1, 0)]
    # greedy rows give batch-1's answers in every batch
    single = _run(model_vqa_loader, _args(model_vqa_loader, _loader_argv(
        model_dir, data)), tmp_path / "b1.jsonl")
    assert [g["text"] for g in got] == [s["text"] for s in single]


def test_loader_chunks_merge_to_the_whole_run(both, model_dir, data,
                                              tmp_path):
    merged = []
    for k in range(2):
        want, got = _both("loader", _loader_argv(
            model_dir, data, "--batch-size", "2", "--num-chunks", "2",
            "--chunk-idx", str(k)), tmp_path, f"c{k}")
        _same(want, got)
        merged += got
    whole = _run(model_vqa_loader, _args(model_vqa_loader, _loader_argv(
        model_dir, data)), tmp_path / "w.jsonl")
    key = lambda r: r["question_id"]   # noqa: E731
    assert [(r["question_id"], r["text"]) for r in sorted(merged, key=key)] \
        == [(r["question_id"], r["text"]) for r in sorted(whole, key=key)]


def test_model_vqa_answers_as_jax(both, model_dir, data, tmp_path):
    _same(*_both("vqa", ["--model-path", model_dir, "--image-folder",
                         data["images"], "--question-file", data["vqa"],
                         "--temperature", "0", "--matryoshka_vis_token_scale",
                         SCALE], tmp_path, "v"))


@pytest.mark.parametrize("single_pred", [False, True])
def test_model_vqa_science_answers_as_jax(both, model_dir, data, tmp_path,
                                          single_pred):
    want, got = _both("science", [
        "--model-path", model_dir, "--image-folder", data["images"],
        "--question-file", data["science"], "--temperature", "0",
        "--matryoshka_vis_token_scale", SCALE]
        + (["--single-pred-prompt"] if single_pred else []), tmp_path, "s")
    _same(want, got)
    prompts = {g["question_id"]: g["prompt"] for g in got}
    assert prompts["s0"].startswith("<image>\n")
    assert not prompts["s1"].startswith("<image>")      # the text-only row
    assert prompts["s1"].endswith("directly.") == single_pred


def test_model_vqa_qbench_answers_as_jax(both, model_dir, data, tmp_path):
    want, got = _both("qbench", [
        "--model-path", model_dir, "--image-folder", data["images"],
        "--questions-file", data["qbench"], "--matryoshka_vis_token_scale",
        SCALE], tmp_path, "q")
    _same(want, got)
    assert all("response" in g for g in got)


def test_model_vqa_mmbench_all_rounds_answer_as_jax(both, model_dir, data,
                                                    tmp_path):
    want, got = _both("mmbench", [
        "--model-path", model_dir, "--question-file", data["mmbench"],
        "--temperature", "0", "--all-rounds", "--single-pred-prompt",
        "--matryoshka_vis_token_scale", SCALE], tmp_path, "m")
    _same(want, got)
    # 4 rounds of the row with four options, 3 of the row with three
    assert sorted((g["question_id"], g["round_id"]) for g in got) == \
        [(7, r) for r in range(4)] + [(8, r) for r in range(3)]
    for g in got:
        chars = "ABCD"[:len(g["options"])]
        r = g["round_id"]
        assert "".join(g["option_char"]) == chars[r:] + chars[:r]


def test_model_qa_layout_as_jax_and_text_fixed(both, model_dir, data,
                                               tmp_path):
    """``model_qa`` samples at temperature 0.7: the JAX package draws from
    ``PRNGKey(0)`` and the port from a ``torch.Generator`` seeded 0, so the
    sampled tokens cannot match across the two frameworks.  The layout and
    ids must; two runs of the port must give the same text."""
    argv = ["--model-path", model_dir, "--question-file", data["qa"]]
    want, got = _both("qa", argv, tmp_path, "qa")
    again = _run(model_qa, _args(model_qa, argv), tmp_path / "qa2.jsonl")
    assert [list(g) for g in got] == [list(w) for w in want]
    for key in ("id", "question_id", "model_id", "metadata"):
        assert [g[key] for g in got] == [w[key] for w in want]
    assert [g["text"] for g in got] == [a["text"] for a in again]


def test_loader_raises_on_a_missing_image(data, tmp_path):
    """The JAX loader's producer dies on a missing image before it queues
    its end marker, and the consumer waits forever; the port raises the
    producer's error on the calling thread and leaves no thread behind."""
    qfile = tmp_path / "q.jsonl"
    with open(qfile, "w") as f:
        for i, image in enumerate(["img0.png", "absent.png", "img1.png"]):
            f.write(json.dumps({"question_id": i, "text": "Is it?",
                                "image": image}) + "\n")
    args = model_vqa_loader.build_parser().parse_args([
        "--model-path", "debug://tiny", "--device", "cpu", "--image-folder",
        data["images"], "--question-file", str(qfile), "--answers-file",
        str(tmp_path / "a.jsonl"), "--max_new_tokens", "2",
        "--matryoshka_vis_token_scale", "ver=v0_numtoks=4"])
    caught = []

    def run():
        try:
            model_vqa_loader.eval_model(args)
        except FileNotFoundError as e:
            caught.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "eval_model hung on a missing image"
    assert caught and "absent.png" in str(caught[0])
    assert not [th for th in threading.enumerate()
                if th.name == "vqa-prefetch"]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_get_chunk_as_jax_and_seeds_random_as_jax(n):
    """Both ``get_chunk`` give the JAX package's chunks (a list, and the
    rows of a DataFrame by position) and leave the process-wide
    ``random`` state where the JAX ones leave it (a quirk reproduced)."""
    import random

    import pandas as pd

    rows = list(range(100, 107))
    frame = pd.DataFrame({"index": rows, "q": [f"q{i}" for i in rows]})
    for k in range(n):
        want = jloader.get_chunk(rows, n, k)
        after = random.random()
        assert model_vqa_loader.get_chunk(rows, n, k) == want
        assert random.random() == after
        assert model_vqa_mmbench.get_chunk(rows, n, k) == want
        assert model_vqa_mmbench.get_chunk(frame, n, k).equals(
            jmmbench.get_chunk(frame, n, k))
        assert list(model_vqa_mmbench.get_chunk(frame, n, k)["index"]) == \
            want
