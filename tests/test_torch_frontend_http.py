"""PyTorch port: the front end's aiohttp apps through
``aiohttp.test_utils.TestClient`` (as ``tests/test_serving.py`` and
``tests/test_serve_units.py`` drive the JAX package's): the worker's
endpoints, the controller's registration and proxy (two streams through
the controller interleave, and it answers heartbeats while they run), the
SGLang route (JSON, SSE, 400, a stop list, a json_schema) and the web
server's ``/chat_stream`` against a fake controller."""

import asyncio
import base64
import glob
import json
import os
import re
import threading
import time

import pytest
import requests
from aiohttp.test_utils import TestClient, TestServer

from matryoshka_mm_torch.serve import controller as C
from matryoshka_mm_torch.serve import model_worker as MW
from matryoshka_mm_torch.serve import sglang_worker as SG
from matryoshka_mm_torch.serve import web_server as W


def _run(coro):
    """One event loop a drive; the worker's semaphore is made in the loop
    that first waits on it, so each drive starts without one."""
    MW.model_semaphore = None
    try:
        return asyncio.run(coro)
    finally:
        MW.model_semaphore = None


def _rows(raw) -> list:
    return [json.loads(c) for c in raw.split(b"\0") if c.strip()]


@pytest.fixture(scope="module")
def worker():
    w = MW.ModelWorker("http://localhost:1", "http://localhost:2", "t", True,
                       "debug://tiny", None, None, device="cpu",
                       continuous_batching=True, max_batch=2,
                       kv_backend="paged", prefix_cache=True)
    yield w
    w.batcher.shutdown()


def test_worker_endpoints(worker):
    async def drive():
        async with TestClient(TestServer(MW.build_app(worker))) as client:
            r = await client.post("/worker_get_status")
            status = await r.json()
            assert status["model_names"] == ["tiny"]
            assert status["batcher"]["healthy"] is True
            r = await client.post("/count_token", json={"prompt": "a b c"})
            assert await r.json() == {"count": 4, "error_code": 0}
            r = await client.post("/model_details")
            assert (await r.json())["context_length"] == worker.context_len
            r = await client.post("/worker_generate_stream", json={
                "prompt": "USER: hello ASSISTANT:", "temperature": 0.0,
                "max_new_tokens": 5})
            rows = _rows(await r.read())
            assert rows and all(c["error_code"] == 0 for c in rows)
            assert rows[-1]["text"].startswith("USER: hello ASSISTANT:")
            r = await client.post("/worker_generate_stream", json={
                "prompt": "USER: <image> <image> ASSISTANT:",
                "images": ["x"], "max_new_tokens": 5})
            assert _rows(await r.read()) == [
                {"text": MW.server_error_msg, "error_code": 1}]

    _run(drive())


class _SlowWorker:
    """Worker-protocol stand-in: three chunks, 0.3 s apart."""

    limit_model_concurrency = 5
    context_len = 2048
    model_name = "slow"

    def send_heart_beat(self, block=True):
        pass

    def get_status(self):
        return {"model_names": [self.model_name], "speed": 1,
                "queue_length": 0}

    def generate_stream_gate(self, params):
        for i in range(3):
            time.sleep(0.3)
            yield json.dumps({"text": f"{params['prompt']} {i}",
                              "error_code": 0}).encode() + b"\0"


def test_controller_registers_and_proxies_interleaved_streams():
    """The proxy pulls the worker's chunks off the event loop: two streams
    through one controller overlap in time, and a heartbeat is answered
    while they run (the JAX package's controller runs them one after the
    other and answers the heartbeat after both)."""
    controller = C.Controller("shortest_queue", start_expiry_thread=False)

    async def drive():
        async with TestClient(TestServer(MW.build_app(_SlowWorker()))) as wc, \
                TestClient(TestServer(C.build_app(controller))) as cc:
            addr = str(wc.make_url("")).rstrip("/")
            r = await cc.post("/register_worker", json={
                "worker_name": addr, "check_heart_beat": True})
            assert r.status == 200     # the controller probed the worker
            r = await cc.post("/list_models")
            assert (await r.json())["models"] == ["slow"]
            r = await cc.post("/get_worker_address", json={"model": "slow"})
            assert (await r.json())["address"] == addr
            r = await cc.post("/get_worker_address", json={"model": "x"})
            assert (await r.json())["address"] == ""

            async def stream(prompt):
                r = await cc.post("/worker_generate_stream",
                                  json={"model": "slow", "prompt": prompt})
                t0, rows = time.perf_counter(), []
                async for line in r.content:
                    rows.append((time.perf_counter(), line))
                return t0, rows, _rows(b"".join(l for _, l in rows))

            async def beat():
                await asyncio.sleep(0.2)
                t0 = time.perf_counter()
                r = await cc.post("/receive_heart_beat", json={
                    "worker_name": addr, "queue_length": 3})
                return time.perf_counter() - t0, await r.json()

            t_start = time.perf_counter()
            a, b, (beat_s, beat_body) = await asyncio.gather(
                stream("A"), stream("B"), beat())
            wall = time.perf_counter() - t_start
            for (_, _, rows), p in ((a, "A"), (b, "B")):
                assert [c["text"] for c in rows] == [f"{p} {i}"
                                                     for i in range(3)]
            # each stream takes ~0.9 s: together they end well before 1.8 s
            assert wall < 1.6, wall
            assert beat_body == {"exist": True} and beat_s < 0.5, beat_s
            assert controller.worker_info[addr].queue_length == 3
            r = await cc.post("/worker_get_status")
            assert (await r.json())["model_names"] == ["slow"]
            r = await cc.post("/worker_generate_stream",
                              json={"model": "none", "prompt": "x"})
            assert _rows(await r.read()) == [
                {"text": C.server_error_msg, "error_code": 2}]
            r = await cc.post("/refresh_all_workers")
            assert r.status == 200 and controller.list_models() == ["slow"]

    _run(drive())


def test_sglang_app_json_sse_and_400(worker):
    async def drive():
        async with TestClient(TestServer(SG.build_sglang_app(worker))) as c:
            r = await c.post("/generate", json={
                "text": "USER: say something ASSISTANT:",
                "sampling_params": {"temperature": 0.0,
                                    "max_new_tokens": 6}})
            assert r.status == 200
            body = await r.json()
            assert body["meta_info"]["error_code"] == 0
            assert body["text"] and "ASSISTANT" not in body["text"]
            assert body["meta_info"]["prompt_tokens"] == 5

            r = await c.post("/generate", json={
                "text": "USER: stream me ASSISTANT:", "stream": True,
                "sampling_params": {"temperature": 0.0,
                                    "max_new_tokens": 6}})
            assert r.headers["Content-Type"].startswith("text/event-stream")
            events = [e for e in (await r.read()).split(b"\n\n")
                      if e.startswith(b"data: ")]
            assert events[-1] == b"data: [DONE]" and len(events) >= 2
            last = json.loads(events[-2][len(b"data: "):])
            assert last["meta_info"]["error_code"] == 0

            r = await c.post("/generate", json={"sampling_params": {}})
            assert r.status == 400
            r = await c.get("/get_model_info")
            assert await r.json() == {"model_path": "tiny",
                                      "is_generation": True}

    _run(drive())


def test_sglang_stop_list_and_json_schema(worker):
    from matryoshka_mm_torch.serve.constrained import regex_for_json_schema

    schema = {"type": "object", "properties": {"B": {"type": "boolean"}}}

    async def drive():
        async with TestClient(TestServer(SG.build_sglang_app(worker))) as c:
            r = await c.post("/generate", json={
                "text": "USER: hi ASSISTANT:",
                "sampling_params": {"temperature": 0.0, "max_new_tokens": 24,
                                    "stop": ["yes", "no", "\n###"]}})
            body = await r.json()
            assert r.status == 200 and body["meta_info"]["error_code"] == 0
            assert not any(s in body["text"] for s in ("yes", "no"))
            r = await c.post("/generate", json={
                "text": "USER: emit json ASSISTANT:",
                "sampling_params": {"temperature": 0.0, "max_new_tokens": 48,
                                    "json_schema": schema}})
            body = await r.json()
            assert body["meta_info"]["error_code"] == 0
            assert re.fullmatch(regex_for_json_schema(schema), body["text"]), \
                body["text"]

    _run(drive())


def test_web_server_chat_stream_against_a_fake_controller(tmp_path,
                                                          monkeypatch):
    log_dir = str(tmp_path / "weblogs")
    app = W.build_app("http://fake-controller", log_dir=log_dir,
                      moderate=True, moderate_fn=lambda t: "NAUGHTY" in t)
    posted, threads = [], set()

    class FakeResp:
        def __init__(self, payload):
            self._p = payload

        def json(self):
            return self._p

        def iter_lines(self, decode_unicode=False, delimiter=b"\0"):
            threads.add(threading.current_thread().name)
            prompt = posted[-1][1]["prompt"]
            for text in ("a red", "a red square"):
                yield json.dumps({"text": prompt + text,
                                  "error_code": 0}).encode()

    def fake_post(url, json=None, **kw):
        posted.append((url, json))
        if url.endswith("/get_worker_address"):
            return FakeResp({"address": "http://fake-worker"})
        if url.endswith("/list_models"):
            return FakeResp({"models": ["m2", "m1"]})
        return FakeResp({})

    monkeypatch.setattr(requests, "post", fake_post)
    img_b64 = base64.b64encode(b"not-really-an-image").decode()

    async def drive():
        async with TestClient(TestServer(app)) as client:
            r = await client.get("/")
            assert "LLaVA-M3" in await r.text()
            r = await client.post("/list_models")
            assert (await r.json())["models"] == ["m1", "m2"]
            r = await client.post("/chat_stream", json={
                "message": "what is this?", "model": "m", "scale": 4,
                "history": [["hi", "hello"]], "image_b64": img_b64})
            rows = _rows(await r.read())
            assert [c["text"] for c in rows] == ["a red", "a red square"]
            assert all(c["error_code"] == 0 for c in rows)
            r = await client.post("/chat_stream", json={
                "message": "NAUGHTY text", "model": "m", "history": []})
            rows = _rows(await r.read())
            assert rows[0]["error_code"] == 1
            assert "MODERATION" in rows[0]["text"].upper()
            for vtype in ("upvote", "downvote", "flag"):
                r = await client.post("/vote", json={
                    "type": vtype, "model": "m", "history": [["q", "a"]]})
                assert (await r.json())["ok"] is True
            r = await client.post("/vote", json={"type": "nonsense"})
            assert r.status == 400

    _run(drive())
    (url, pload), = [p for p in posted
                     if p[0].endswith("/worker_generate_stream")]
    assert url == "http://fake-worker/worker_generate_stream"
    assert pload["matryoshka_vis_token_scale"] == "ver=v0_numtoks=144"
    assert pload["images"] == [img_b64] and "<image>" in pload["prompt"]
    assert "hello" in pload["prompt"] and pload["stop"] == "</s>"
    assert threads and threading.main_thread().name not in threads
    (log,) = glob.glob(os.path.join(log_dir, "*-conv.json"))
    rows = [json.loads(line) for line in open(log)]
    assert [r["type"] for r in rows] == ["chat", "flagged", "upvote",
                                         "downvote", "flag"]
    assert rows[0]["response"] == "a red square" and rows[0]["scale"] == 144
    archived = os.path.join(log_dir, "serve_images",
                            rows[0]["images"][0] + ".img")
    assert open(archived, "rb").read() == b"not-really-an-image"
