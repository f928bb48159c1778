"""SGLang-style worker (reference: llava/serve/sglang_worker.py:1-244); the
port's own copy of ``matryoshka_mm_tpu/serve/sglang_worker.py``.

The reference uses SGLang as its high-throughput serving backend:
continuous batching + paged ("radix") KV over the same controller/worker
protocol.  This module provides the equivalent in **local mode**: it
embeds the model behind the paged continuous batcher (serve/batching.py
backend="paged", the paged-attention kernel on the card) and exposes

* the regular llava worker protocol (``/worker_generate_stream``,
  ``/worker_get_status``, ...), so the controller can't tell it apart
  from ``model_worker``; and
* SGLang's native ``POST /generate`` API — ``{"text", "image_data",
  "sampling_params": {...}, "stream"}`` — returning either one JSON body
  or SSE ``data: {...}`` chunks, so SGLang clients can point at it.

**Proxy mode** (``--runtime-url``) keeps the reference's original shape:
forwards generations to an external SGLang runtime for deployments that
have one.

    python -m matryoshka_mm_torch.serve.sglang_worker --model-path debug://7b
"""

from __future__ import annotations

import argparse
import asyncio
import json
import uuid

from ..utils.logging import build_logger, server_error_msg

logger = build_logger("sglang_worker", "sglang_worker.log")


def _params_from_sglang(body: dict) -> dict:
    """Map an SGLang /generate body onto the worker-protocol params."""
    sp = body.get("sampling_params") or {}
    imgs = body.get("image_data")
    if imgs is not None and not isinstance(imgs, list):
        imgs = [imgs]
    return {
        "prompt": body["text"],
        "images": imgs,
        "temperature": float(sp.get("temperature", 0.0)),
        "top_p": float(sp.get("top_p", 1.0)),
        "max_new_tokens": int(sp.get("max_new_tokens", 256)),
        "stop": sp.get("stop"),
        "matryoshka_vis_token_scale": body.get("matryoshka_vis_token_scale"),
        "lora": body.get("lora") or (body.get("sampling_params") or {}).get("lora"),
        # SGLang-native constrained decoding: output must full-match
        "regex": sp.get("regex"),
        "json_schema": sp.get("json_schema"),
    }


def build_sglang_app(worker):
    """Worker-protocol app + SGLang-native /generate on top."""
    from aiohttp import web

    from .model_worker import build_app

    app = build_app(worker)
    routes = web.RouteTableDef()

    @routes.post("/generate")
    async def generate(request):
        from . import model_worker as _mw

        body = await request.json()
        try:
            params = _params_from_sglang(body)
        except KeyError as e:
            return web.json_response(
                {"error": f"missing field: {e}"}, status=400)
        prompt = params["prompt"]
        loop = asyncio.get_event_loop()

        # the SGLang-native route shares the worker-protocol semaphore:
        # without it, concurrency here is unbounded (sampled requests
        # each run a full solo decode) and queue_length/heartbeat load
        # reporting never sees this traffic
        if _mw.model_semaphore is None:
            _mw.model_semaphore = asyncio.Semaphore(
                worker.limit_model_concurrency)
        await _mw.model_semaphore.acquire()
        try:
            return await _generate_inner(request, body, params, prompt, loop)
        finally:
            _mw.model_semaphore.release()

    async def _generate_inner(request, body, params, prompt, loop):
        gen = worker.generate_stream_gate(params)

        def next_chunk():
            return next(gen, None)

        if body.get("stream"):
            resp = web.StreamResponse(
                headers={"Content-Type": "text/event-stream"})
            await resp.prepare(request)
            while True:
                chunk = await loop.run_in_executor(None, next_chunk)
                if chunk is None:
                    break
                for piece in chunk.split(b"\0"):
                    if not piece:
                        continue
                    d = json.loads(piece)
                    out = {"text": d["text"][len(prompt):]
                           if d.get("error_code") == 0 else d["text"],
                           "meta_info": {"error_code": d.get("error_code", 0)}}
                    await resp.write(b"data: " + json.dumps(out).encode()
                                     + b"\n\n")
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp

        last = None
        while True:
            chunk = await loop.run_in_executor(None, next_chunk)
            if chunk is None:
                break
            for piece in chunk.split(b"\0"):
                if piece:
                    last = json.loads(piece)
        if last is None or last.get("error_code", 0) != 0:
            return web.json_response(
                {"text": (last or {}).get("text", server_error_msg),
                 "meta_info": {"error_code": (last or {}).get("error_code", 1)}},
                status=500)
        return web.json_response({
            "text": last["text"][len(prompt):],
            "meta_info": {"error_code": 0,
                          "prompt_tokens": len(worker.tokenizer(prompt).input_ids),
                          "id": uuid.uuid4().hex},
        })

    @routes.get("/get_model_info")
    async def get_model_info(request):
        return web.json_response({"model_path": worker.model_name,
                                  "is_generation": True})

    app.add_routes(routes)
    return app


class SGLangProxyWorker:
    """Proxy mode: forwards /worker_generate_stream to an external SGLang
    runtime endpoint (the reference's original deployment shape)."""

    def __init__(self, controller_addr, worker_addr, runtime_url, model_name):
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.runtime_url = runtime_url
        self.model_name = model_name
        # worker-protocol surface expected by model_worker.build_app
        self.limit_model_concurrency = 5
        self.context_len = 2048

    def send_heart_beat(self, block: bool = True):
        pass

    def get_status(self):
        return {"model_names": [self.model_name], "speed": 1, "queue_length": 0}

    def generate_stream(self, params):
        import requests

        # forward the FULL sampling surface — silently dropping stop/
        # regex/json_schema/lora/scale would give the client an
        # unconstrained generation with no warning
        sp = {"temperature": float(params.get("temperature", 0.0)),
              "top_p": float(params.get("top_p", 1.0)),
              "max_new_tokens": int(params.get("max_new_tokens", 256))}
        for k in ("stop", "regex", "json_schema"):
            if params.get(k) is not None:
                sp[k] = params[k]
        payload = {"text": params["prompt"],
                   "image_data": params.get("images"),
                   "stream": True, "sampling_params": sp}
        if params.get("lora"):
            payload["lora"] = params["lora"]
        if params.get("matryoshka_vis_token_scale"):
            payload["matryoshka_vis_token_scale"] = \
                params["matryoshka_vis_token_scale"]
        try:
            r = requests.post(f"{self.runtime_url}/generate", json=payload,
                              stream=True, timeout=120)
            for line in r.iter_lines():
                if not line or not line.startswith(b"data: "):
                    continue
                payload = line[len(b"data: "):]
                if payload == b"[DONE]":
                    break
                d = json.loads(payload)
                yield json.dumps({"text": params["prompt"] + d["text"],
                                  "error_code": 0}).encode() + b"\0"
        except requests.RequestException as e:
            logger.error(f"runtime error: {e}")
            yield json.dumps({"text": server_error_msg,
                              "error_code": 1}).encode() + b"\0"

    def generate_stream_gate(self, params):
        yield from self.generate_stream(params)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=21003)
    parser.add_argument("--controller-address", default="http://localhost:21001")
    parser.add_argument("--worker-address", default="http://localhost:21003")
    parser.add_argument("--model-path", default="debug://7b")
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--no-register", action="store_true")
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--load-8bit", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--speculative-k", type=int, default=0,
                        help="verify k prompt-lookup drafts per decode "
                             "step (greedy-only)")
    parser.add_argument("--lora-adapters", type=str, default=None,
                        help="name=ckpt,... adapters served on the base")
    parser.add_argument("--runtime-url", default=None,
                        help="external SGLang runtime base URL (proxy mode); "
                             "omit to serve locally through the paged batcher")
    args = parser.parse_args()
    logger.info(f"args: {args}")

    from aiohttp import web

    if args.runtime_url:
        worker = SGLangProxyWorker(args.controller_address,
                                   args.worker_address, args.runtime_url,
                                   args.model_name or "llava-sglang")
        from .model_worker import build_app

        app = build_app(worker)
    else:
        from .model_worker import ModelWorker

        worker = ModelWorker(
            args.controller_address, args.worker_address,
            uuid.uuid4().hex[:6], args.no_register, args.model_path, None,
            args.model_name, load_8bit=args.load_8bit, device=args.device,
            continuous_batching=True, max_batch=args.max_batch,
            kv_backend="paged", prefix_cache=True,
            lora_adapters=args.lora_adapters,
            speculative_k=args.speculative_k)
        app = build_sglang_app(worker)

    web.run_app(app, host=args.host, port=args.port, print=None)


if __name__ == "__main__":
    main()
