"""lmms-eval adapter that evaluates THROUGH the SGLang-style serving
worker (reference: lmms-eval/lmms_eval/models/llava_sglang.py — which
launches an ``sgl.Runtime`` and fans requests out over a thread pool; the
PyTorch port of ``matryoshka_mm_tpu/lmms_eval/models/llava_sglang.py``).

Here the backend is the port's own serving stack: ``serve.sglang_worker``
in local mode (paged continuous batcher + the paged-attention kernel
behind SGLang's ``POST /generate`` API).  Two deployment shapes:

* ``endpoint=http://host:port`` — evaluate against an already-running
  worker (the reference's runtime-as-a-service shape);
* no endpoint — spin up an in-process local-mode worker on an ephemeral
  port (``pretrained=`` selects the checkpoint, ``device=`` its device,
  ``"cuda"`` by default), so a single command e2e-tests benchmark
  protocol -> HTTP -> batcher -> kernels.  ``close()`` stops the server
  thread and shuts the batcher down (its scheduler thread and captured
  round).

Requests fan out over ``parallel`` threads like the reference adapter, so
the continuous batcher actually batches (sequential submission would
serialize into solo decodes and measure nothing).

Like the reference, ``loglikelihood`` is not supported through the
serving API (generate-only benchmarks: reference llava_sglang.py:66-67).
"""

from __future__ import annotations

import base64
import io
import json
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

from ...constants import DEFAULT_IMAGE_TOKEN
from ...conversation import SeparatorStyle, conv_templates
from ..api.instance import Instance
from ..api.model import lmms
from ..api.registry import register_model


def _b64_image(img) -> str:
    """PIL image -> base64 PNG (what the worker's
    load_image_from_base64 decodes).  PNG, not JPEG: eval images may be
    RGBA/paletted, and lossy re-encode would perturb scorer-visible
    pixels."""
    buf = io.BytesIO()
    img.convert("RGB").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@register_model("llava_sglang")
class LlavaSglang(lmms):
    def __init__(self, endpoint: Optional[str] = None,
                 pretrained: str = "debug://tiny",
                 conv_template: str = "vicuna_v1",
                 matryoshka_vis_token_scale: Optional[str] = None,
                 parallel: int = 8, max_batch: int = 8,
                 timeout: float = 600.0, device: str = "cuda", **kwargs):
        super().__init__()
        self.conv_template = conv_template
        self.matryoshka_vis_token_scale = matryoshka_vis_token_scale
        self.parallel = max(int(parallel), 1)
        self.timeout = float(timeout)
        self._worker = None
        self._loop = None
        self._thread = None
        self.endpoint = endpoint or self._start_local_worker(
            pretrained, int(max_batch), device)

    # ---- in-process worker (no endpoint given) ----
    def _start_local_worker(self, pretrained: str, max_batch: int,
                            device: str) -> str:
        import asyncio
        import socket

        from aiohttp import web

        from ...serve.model_worker import ModelWorker
        from ...serve.sglang_worker import build_sglang_app

        worker = ModelWorker(
            "http://localhost:1", "http://localhost:2",
            uuid.uuid4().hex[:6], True, pretrained, None, None,
            device=device, continuous_batching=True, max_batch=max_batch,
            kv_backend="paged", prefix_cache=True)
        app = build_sglang_app(worker)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        loop = asyncio.new_event_loop()
        runner = web.AppRunner(app)
        started = threading.Event()

        def run():
            asyncio.set_event_loop(loop)
            loop.run_until_complete(runner.setup())
            loop.run_until_complete(
                web.TCPSite(runner, "127.0.0.1", port).start())
            started.set()
            loop.run_forever()
            loop.run_until_complete(runner.cleanup())
            # the executor threads that ran the worker's stream
            loop.run_until_complete(loop.shutdown_default_executor())
            loop.close()

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        self._worker = worker
        if not started.wait(120):
            worker.batcher.shutdown()
            raise RuntimeError("local sglang worker did not start")
        self._loop, self._thread = loop, thread
        return f"http://127.0.0.1:{port}"

    def close(self):
        """Stop the in-process worker (no-op against an external
        endpoint): the server thread ends once its app is cleaned up (which
        drops the app's loop-bound semaphore), then the batcher shuts
        down."""
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(60)
            if self._thread.is_alive():
                raise RuntimeError("the local sglang server thread did not "
                                   "stop")
            self._loop = self._thread = None
        if self._worker is not None:
            self._worker.batcher.shutdown()
            self._worker = None

    # ---- harness surface ----
    def _build_prompt(self, context: str, has_image: bool) -> str:
        conv = conv_templates[self.conv_template].copy()
        q = (DEFAULT_IMAGE_TOKEN + "\n" + context) if has_image else context
        conv.append_message(conv.roles[0], q)
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    def _stop_str(self) -> Optional[str]:
        conv = conv_templates[self.conv_template].copy()
        return conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2

    def _generate_one(self, context: str, visual, gen_kwargs: dict) -> str:
        import requests

        prompt = self._build_prompt(context, visual is not None)
        temperature = float(gen_kwargs.get("temperature", 0.0))
        body = {
            "text": prompt,
            "image_data": ([_b64_image(visual)]
                           if visual is not None else None),
            "sampling_params": {
                "temperature": temperature,
                "top_p": float(gen_kwargs.get("top_p", 1.0)),
                "max_new_tokens": int(gen_kwargs.get("max_new_tokens", 16)),
                "stop": self._stop_str(),
            },
        }
        if self.matryoshka_vis_token_scale:
            body["matryoshka_vis_token_scale"] = \
                self.matryoshka_vis_token_scale
        r = requests.post(f"{self.endpoint}/generate", json=body,
                          timeout=self.timeout)
        d = r.json()
        if r.status_code != 200 or d.get("meta_info",
                                         {}).get("error_code", 1) != 0:
            raise RuntimeError(
                f"sglang worker error {r.status_code}: "
                f"{json.dumps(d)[:200]}")
        return d["text"].strip()

    def generate_until(self, requests_: List[Instance]) -> List[str]:
        out: List[Optional[str]] = [None] * len(requests_)

        def work(i: int) -> None:
            context, gen_kwargs, visual = requests_[i].arguments
            out[i] = self._generate_one(context, visual, dict(gen_kwargs))

        with ThreadPoolExecutor(max_workers=self.parallel) as ex:
            futures = {ex.submit(work, i): i for i in range(len(requests_))}
            for f in futures:
                f.result()       # surface worker errors loudly
        for i, t in enumerate(out):
            requests_[i].resps.append(t)
        return out  # type: ignore[return-value]

    def loglikelihood(self, requests_: List[Instance]
                      ) -> List[Tuple[float, bool]]:
        raise NotImplementedError(
            "the serving API is generate-only; use model=llava for "
            "loglikelihood tasks (reference llava_sglang has the same "
            "limitation)")
