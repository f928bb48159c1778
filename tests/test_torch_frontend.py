"""PyTorch port: the serving front end's framework-free copies give what the
JAX package's originals give, exactly (the controller's dispatch, heartbeat
expiry and model list, ``_params_from_sglang``, the web server's
``ConversationLogger``, ``StageTimer``, the wandb shim, ``models/utils.py``,
``test_message``'s request, the logging helpers), and the tools: the port's
``make_delta`` / ``apply_delta`` against the JAX ``_delta_leaf`` on the same
arrays, ``consolidate``, ``profiling.trace`` on the CPU, and the port's
native image library bit for bit against the JAX package's."""

import json
import os
import random
import time

import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.serve import controller as jctl
from matryoshka_mm_tpu.serve import sglang_worker as jsgl
from matryoshka_mm_tpu.serve import web_server as jweb
from matryoshka_mm_tpu.utils import logging as jlog
from matryoshka_mm_torch.serve import controller as tctl
from matryoshka_mm_torch.serve import sglang_worker as tsgl
from matryoshka_mm_torch.serve import web_server as tweb
from matryoshka_mm_torch.utils import logging as tlog


def _register(c, name, models, speed=1, qlen=0):
    c.register_worker(name, check_heart_beat=True, worker_status={
        "model_names": models, "speed": speed, "queue_length": qlen})


def _fleet(mod, method):
    c = mod.Controller(method, start_expiry_thread=False)
    _register(c, "http://w1", ["a", "b"], speed=1, qlen=5)
    _register(c, "http://w2", ["b"], speed=3, qlen=2)
    _register(c, "http://w3", ["b", "c"], speed=2, qlen=0)
    return c


@pytest.mark.parametrize("method", ["shortest_queue", "lottery"])
def test_dispatch_equal(method):
    picks = []
    for mod in (jctl, tctl):
        c = _fleet(mod, method)
        random.seed(7)
        picks.append([c.get_worker_address(m)
                      for m in ["b"] * 12 + ["a", "c", "none"]])
        picks[-1].append({a: i.queue_length for a, i in c.worker_info.items()})
    assert picks[0] == picks[1]
    assert picks[0][-2] == ""
    if method == "lottery":
        assert len(set(picks[0][:12])) > 1


def test_heartbeat_expiry_and_model_list_equal():
    states = []
    for mod in (jctl, tctl):
        c = _fleet(mod, "shortest_queue")
        beats = [c.receive_heart_beat("http://w1", 9),
                 c.receive_heart_beat("http://nobody", 1)]
        c.worker_info["http://w2"].last_heart_beat = time.time() - 1000
        c.worker_info["http://w3"].check_heart_beat = False
        c.worker_info["http://w3"].last_heart_beat = time.time() - 1000
        c.remove_stale_workers_by_expiration()
        models = c.list_models()
        c.remove_worker("http://w1")
        states.append((beats, models, sorted(c.worker_info), c.list_models()))
    assert states[0] == states[1]
    assert states[0][2] == ["http://w3"]


@pytest.mark.parametrize("body", [
    {"text": "USER: <image> hi ASSISTANT:", "image_data": "b64",
     "sampling_params": {"temperature": 0.7, "max_new_tokens": 32,
                         "top_p": 0.9, "stop": ["</s>", "###"]},
     "matryoshka_vis_token_scale": "ver=v0_numtoks=9"},
    {"text": "hi"},
    {"text": "x", "image_data": ["a", "b"], "lora": "alpha",
     "sampling_params": {"regex": "[ab]+", "json_schema": {"type": "object"},
                         "lora": "beta"}},
    {"text": "x", "sampling_params": {"lora": "beta"}},
])
def test_params_from_sglang_equal(body):
    assert tsgl._params_from_sglang(body) == jsgl._params_from_sglang(body)
    with pytest.raises(KeyError):
        tsgl._params_from_sglang({"sampling_params": {}})


def test_conversation_logger_records_equal(tmp_path, monkeypatch):
    import base64

    monkeypatch.setattr(time, "time", lambda: 1700000000.123456)
    rows = []
    for name, mod in (("jax", jweb), ("torch", tweb)):
        log = mod.ConversationLogger(str(tmp_path / name))
        img = base64.b64encode(b"\x89PNG not really").decode()
        h = [log.save_image_b64(img), log.save_image_b64(img)]
        log.log("chat", {"model": "m", "images": h, "response": "r"}, ip="1.2.3.4")
        log.log("upvote", {"model": "m", "state": [["q", "a"]]})
        (conv,) = [f for f in os.listdir(log.log_dir) if f.endswith(".json")]
        rows.append((conv, open(os.path.join(log.log_dir, conv)).read(),
                     sorted(os.listdir(log.image_dir))))
    assert rows[0] == rows[1]
    assert tweb.scale2tokens == jweb.scale2tokens
    assert tweb.INDEX_HTML.count("scale2tokens") == \
        jweb.INDEX_HTML.count("scale2tokens")


def test_logging_helpers_equal(monkeypatch):
    import asyncio

    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    assert (tlog.server_error_msg, tlog.moderation_msg) == \
        (jlog.server_error_msg, jlog.moderation_msg)
    assert tlog.violates_moderation("x") is jlog.violates_moderation("x") \
        is False
    sem = asyncio.Semaphore(3)
    for s in (None, sem):
        assert tlog.pretty_print_semaphore(s) == jlog.pretty_print_semaphore(s)
    assert not hasattr(tlog, "disable_jax_init_warnings")
    stream = tlog.StreamToLogger(tlog.logging.getLogger("t"))
    stream.write("partial")
    assert stream.linebuf == "partial"


def test_stage_timer_equal(monkeypatch, tmp_path):
    from matryoshka_mm_tpu.utils import profiling as jprof
    from matryoshka_mm_torch.utils import profiling as tprof

    dumps = []
    for name, mod in (("jax", jprof), ("torch", tprof)):
        clock = iter(np.arange(100) * 0.25)
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
        t = mod.StageTimer(str(tmp_path / f"{name}.jsonl"))
        for stage in ("data", "step", "data"):
            with t.stage(stage):
                pass
        dumps.append((t.summary(), t.dump(),
                      open(tmp_path / f"{name}.jsonl").read()))
    assert dumps[0] == dumps[1]


def test_wandb_shim_equal(tmp_path, monkeypatch):
    from matryoshka_mm_tpu.utils import wandb_shim as jw
    from matryoshka_mm_torch.utils import wandb_shim as tw

    monkeypatch.setattr(time, "time", lambda: 1700000000.5)
    files = []
    for name, mod in (("jax", jw), ("torch", tw)):
        run = mod.init(project="p", name="r", config={"lr": 1.0, "s": "x"},
                       dir=str(tmp_path / name))
        mod.log({"loss": 2.5, "tag": object.__name__})
        mod.log({"loss": np.float32(2.0)}, step=10)
        mod.log({"acc": 1})
        mod.finish()
        files.append((os.path.basename(run.path), open(run.path).read()))
    assert files[0] == files[1]


@pytest.mark.parametrize("case", ["current", "upgrade", "refuse"])
def test_models_utils_auto_upgrade_equal(tmp_path, case):
    from matryoshka_mm_tpu.models import utils as ju
    from matryoshka_mm_torch.models import utils as tu

    cfg = {"current": {"model_type": "llava_llama"},
           "upgrade": {"model_type": "llava", "_name_or_path": "llava-7b"},
           "refuse": {"model_type": "llava", "_name_or_path": "x"}}[case]
    out = []
    for name, mod in (("jax", ju), ("torch", tu)):
        d = tmp_path / name / "ckpt"
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(cfg))
        try:
            res = mod.auto_upgrade(str(d), assume_yes=True)
        except ValueError as e:
            res = str(e)
        out.append((res, json.loads((d / "config.json").read_text())))
    assert out[0] == out[1]


def test_test_message_request_equal(monkeypatch, capsys):
    import requests

    from matryoshka_mm_tpu.serve import test_message as jtm
    from matryoshka_mm_torch.serve import test_message as ttm

    sent = []

    class Resp:
        def iter_content(self, chunk_size=8192):
            yield json.dumps({"text": "P a", "error_code": 0}).encode() + b"\0"
            yield json.dumps({"text": "P ab", "error_code": 1}).encode()

    def fake_post(url, json=None, **kw):
        sent.append((url, json))
        return Resp()

    monkeypatch.setattr(requests, "post", fake_post)
    codes = [mod.run("http://w", "m", "Tell me.", 7, 0.5)
             for mod in (jtm, ttm)]
    assert codes == [1, 1]
    assert sent[0] == sent[1]
    assert sent[0][1]["prompt"].endswith("ASSISTANT:")
    out = capsys.readouterr()
    assert out.err.count("error_code=1") == 2


# ---------------------------------------------------------------------------
# tools
# ---------------------------------------------------------------------------

def _tiny_tree(seed, vocab):
    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.models.convert import init_params

    cfg = LlavaConfig.tiny_debug()
    params = init_params(cfg, device="cpu", seed=seed)
    lm = params["llama"]
    g = torch.Generator().manual_seed(seed)
    for key in ("embed_tokens", "lm_head"):
        w = lm[key]
        lm[key] = torch.cat([w, torch.randn(vocab - w.shape[0], w.shape[1],
                                            generator=g)])[:vocab]
    return params, cfg


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_make_delta_round_trip_equals_jax_delta_leaf(tmp_path):
    from matryoshka_mm_tpu.models.make_delta import _delta_leaf
    from matryoshka_mm_torch.models.make_delta import apply_delta, make_delta
    from matryoshka_mm_torch.utils.checkpoint import (load_checkpoint,
                                                      load_meta,
                                                      save_checkpoint)

    base, cfg = _tiny_tree(1, 512)
    target, _ = _tiny_tree(2, 520)           # two added token rows
    save_checkpoint(str(tmp_path / "base"), base, cfg)
    save_checkpoint(str(tmp_path / "target"), target, cfg)
    make_delta(str(tmp_path / "base"), str(tmp_path / "target"),
               str(tmp_path / "delta"), device="cpu")
    delta, _ = load_checkpoint(str(tmp_path / "delta"), device="cpu")
    assert load_meta(str(tmp_path / "delta"))["is_delta"] is True
    want = dict(_leaves(target["llama"]))
    have = dict(_leaves(delta["llama"]))
    bases = dict(_leaves(base["llama"]))
    assert set(have) == set(want)
    for k, d in have.items():
        ref = _delta_leaf(bases[k].numpy(), want[k].numpy())
        assert d.dtype == torch.float32
        np.testing.assert_array_equal(d.numpy(), ref, err_msg=k)
    assert torch.equal(delta["mm_projector"]["layers"][0]["weight"],
                       target["mm_projector"]["layers"][0]["weight"])
    apply_delta(str(tmp_path / "base"), str(tmp_path / "back"),
                str(tmp_path / "delta"), device="cpu")
    back, _ = load_checkpoint(str(tmp_path / "back"), device="cpu")
    for k, t in _leaves(back["llama"]):
        b, d = bases[k].numpy(), have[k].numpy()
        if b.shape == d.shape:
            ref = b + d
        else:                   # the JAX apply_delta's added rows
            ref = d.copy()
            ref[:b.shape[0]] = b + d[:b.shape[0]]
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=k)
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), atol=1e-6)


def test_consolidate_writes_the_loaded_model(tmp_path):
    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.models.consolidate import consolidate_ckpt
    from matryoshka_mm_torch.utils.checkpoint import load_checkpoint
    from tests.test_torch_frontend_worker import write_hf_dir

    src = write_hf_dir(tmp_path / "hf")
    consolidate_ckpt(src, str(tmp_path / "one"), device="cpu")
    params, cfg = load_checkpoint(str(tmp_path / "one"), device="cpu")
    _, model, _, _ = load_pretrained_model(src, device="cpu")
    assert cfg == model.cfg
    want = dict(_leaves(model.params))
    have = dict(_leaves(params))
    assert set(have) == set(want)
    for k, t in have.items():
        assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k


def test_profiling_trace_on_the_cpu(tmp_path):
    from matryoshka_mm_torch.utils import profiling

    with profiling.trace(str(tmp_path / "t")) as d:
        with profiling.annotate("matmul span"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul span" for e in events)
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


@pytest.mark.parametrize("shape", [(97, 133), (412, 517), (336, 336),
                                   (30, 600)])
def test_native_library_bitwise_equal_to_jax(shape):
    from matryoshka_mm_tpu import native as jnat
    from matryoshka_mm_torch import native as tnat

    if not (jnat.native_available() and tnat.native_available()):
        pytest.skip("no C++ compiler here")
    mean = (0.48145466, 0.4578275, 0.40821073)
    std = (0.26862954, 0.26130258, 0.27577711)
    rgb = np.random.default_rng(sum(shape)).integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tnat.clip_preprocess_native(rgb, 336, 336, mean, std),
        jnat.clip_preprocess_native(rgb, 336, 336, mean, std))
    for oh, ow in ((48, 64), (200, 260)):
        np.testing.assert_array_equal(tnat.resize_bicubic_native(rgb, oh, ow),
                                      jnat.resize_bicubic_native(rgb, oh, ow))
    assert tnat.library_path().parent.name == "native"
    assert tnat.library_path().parent.parent.name == "build"
    with pytest.raises(ValueError, match="H, W, 3"):
        tnat.clip_preprocess_native(rgb[..., 0], 336, 336, mean, std)
