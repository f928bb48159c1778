"""Serving controller (the port's own copy of
``matryoshka_mm_tpu/serve/controller.py``; framework-free).

Worker registry with heartbeat expiry and dispatch.  The REST surface and
payload shapes are byte-compatible with the reference's controller
protocol (reference: llava/serve/controller.py:28-298):
``/register_worker``, ``/refresh_all_workers``, ``/list_models``,
``/get_worker_address``, ``/receive_heart_beat``,
``/worker_generate_stream`` (proxy, ``\\0``-delimited JSON chunks) and
``/worker_get_status`` (hierarchical controller-as-worker).  The
implementation is this framework's own: a lock-guarded registry keyed by
worker address with pluggable dispatch policies, on aiohttp (FastAPI and
uvicorn are not needed).

One change from the JAX package's copy: every handler that makes a
blocking HTTP call (the ``/worker_generate_stream`` proxy above all, and
the status probes of ``/register_worker``, ``/refresh_all_workers`` and
``/worker_get_status``) runs it in the app's own thread pool, one chunk at
a time for the proxy, so two streams through the controller interleave and
heartbeats are answered while they run.  The answers are the same.

``requests`` and ``aiohttp`` are imported where they are used.

    python -m matryoshka_mm_torch.serve.controller --port 21001
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from enum import Enum
from typing import Dict, List, Optional

from ..constants import CONTROLLER_HEART_BEAT_EXPIRATION
from ..utils.logging import build_logger, server_error_msg

logger = build_logger("controller", "controller.log")

# threads of the app's pool: a proxied stream holds one while it waits for
# the worker's next chunk, so this bounds the streams in flight
PROXY_THREADS = 64


class DispatchMethod(Enum):
    """Dispatch policy names match the reference CLI flags."""

    LOTTERY = "lottery"
    SHORTEST_QUEUE = "shortest_queue"


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: int
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float

    @classmethod
    def from_status(cls, status: dict, check_heart_beat: bool) -> "WorkerInfo":
        return cls(model_names=list(status["model_names"]),
                   speed=status["speed"],
                   queue_length=status["queue_length"],
                   check_heart_beat=check_heart_beat,
                   last_heart_beat=time.time())


def _probe_worker(address: str) -> Optional[dict]:
    """Ask a worker for its /worker_get_status; None when unreachable."""
    import requests

    try:
        r = requests.post(address + "/worker_get_status", timeout=5)
        return r.json() if r.status_code == 200 else None
    except requests.exceptions.RequestException as e:
        logger.error(f"status probe failed for {address}: {e}")
        return None


class Controller:
    """Thread-safe worker registry + dispatcher."""

    def __init__(self, dispatch_method: str, start_expiry_thread: bool = True):
        self.worker_info: Dict[str, WorkerInfo] = {}
        self.dispatch_method = DispatchMethod(dispatch_method)
        self._lock = threading.Lock()
        if start_expiry_thread:
            threading.Thread(target=self._expiry_loop, daemon=True).start()
        logger.info(f"controller up (dispatch={dispatch_method})")

    # ---- registry ----
    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: Optional[dict]) -> bool:
        status = worker_status or _probe_worker(worker_name)
        if not status:
            return False
        with self._lock:
            fresh = worker_name not in self.worker_info
            self.worker_info[worker_name] = WorkerInfo.from_status(
                status, check_heart_beat)
        logger.info(f"{'new' if fresh else 'refreshed'} worker "
                    f"{worker_name}: {status}")
        return True

    def get_worker_status(self, worker_name: str) -> Optional[dict]:
        return _probe_worker(worker_name)

    def remove_worker(self, worker_name: str):
        with self._lock:
            self.worker_info.pop(worker_name, None)

    def refresh_all_workers(self):
        with self._lock:
            snapshot = list(self.worker_info.items())
            self.worker_info = {}
        for address, info in snapshot:
            if not self.register_worker(address, info.check_heart_beat, None):
                logger.info(f"dropping unreachable worker {address}")

    def list_models(self) -> List[str]:
        with self._lock:
            return sorted({m for info in self.worker_info.values()
                           for m in info.model_names})

    # ---- dispatch ----
    def _serving(self, model_name: str) -> Dict[str, WorkerInfo]:
        return {addr: info for addr, info in self.worker_info.items()
                if model_name in info.model_names}

    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            candidates = self._serving(model_name)
            if not candidates:
                return ""
            if self.dispatch_method is DispatchMethod.LOTTERY:
                # speed-weighted lottery (reference dispatch semantics)
                weights = [info.speed for info in candidates.values()]
                if sum(weights) < 1e-4:
                    return ""
                return random.choices(list(candidates), weights=weights)[0]
            # shortest normalized queue; count the dispatch immediately so
            # a burst of requests spreads before the next heartbeat lands
            addr = min(candidates,
                       key=lambda a: candidates[a].queue_length
                       / candidates[a].speed)
            self.worker_info[addr].queue_length += 1
            return addr

    # ---- liveness ----
    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            info = self.worker_info.get(worker_name)
            if info is None:
                # a worker we forgot (e.g. restart): it will re-register
                logger.info(f"heartbeat from unknown worker {worker_name}")
                return False
            info.queue_length = queue_length
            info.last_heart_beat = time.time()
        return True

    def remove_stale_workers_by_expiration(self):
        deadline = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self._lock:
            stale = [addr for addr, info in self.worker_info.items()
                     if info.check_heart_beat
                     and info.last_heart_beat < deadline]
            for addr in stale:
                del self.worker_info[addr]
        for addr in stale:
            logger.info(f"expired worker {addr}")

    def _expiry_loop(self):
        while True:
            time.sleep(CONTROLLER_HEART_BEAT_EXPIRATION)
            self.remove_stale_workers_by_expiration()

    # ---- controller-as-worker (hierarchical mode) ----
    def worker_api_generate_stream(self, params):
        import requests

        address = self.get_worker_address(params["model"])
        if not address:
            logger.info(f"no live worker serves {params['model']!r}")
            yield json.dumps({"text": server_error_msg,
                              "error_code": 2}).encode() + b"\0"
            return
        try:
            upstream = requests.post(address + "/worker_generate_stream",
                                     json=params, stream=True, timeout=5)
            for chunk in upstream.iter_lines(decode_unicode=False,
                                             delimiter=b"\0"):
                if chunk:
                    yield chunk + b"\0"
        except requests.exceptions.RequestException:
            logger.info(f"worker stream failed: {address}")
            yield json.dumps({"text": server_error_msg,
                              "error_code": 3}).encode() + b"\0"

    def worker_api_get_status(self) -> dict:
        with self._lock:
            addresses = list(self.worker_info)
        statuses = [s for s in (_probe_worker(a) for a in addresses) if s]
        return {
            "model_names": sorted({m for s in statuses
                                   for m in s["model_names"]}),
            "speed": sum(s["speed"] for s in statuses),
            "queue_length": sum(s["queue_length"] for s in statuses),
        }


def build_app(controller: Controller):
    from aiohttp import web

    routes = web.RouteTableDef()
    pool = ThreadPoolExecutor(PROXY_THREADS, thread_name_prefix="controller")

    def off_loop(fn, *args):
        """``fn(*args)`` in the app's thread pool: it blocks on HTTP."""
        return asyncio.get_running_loop().run_in_executor(pool, fn, *args)

    @routes.post("/register_worker")
    async def register_worker(request):
        data = await request.json()
        await off_loop(controller.register_worker, data["worker_name"],
                       data["check_heart_beat"],
                       data.get("worker_status", None))
        return web.json_response({})

    @routes.post("/refresh_all_workers")
    async def refresh_all_workers(request):
        await off_loop(controller.refresh_all_workers)
        return web.json_response({})

    @routes.post("/list_models")
    async def list_models(request):
        return web.json_response({"models": controller.list_models()})

    @routes.post("/get_worker_address")
    async def get_worker_address(request):
        data = await request.json()
        return web.json_response(
            {"address": controller.get_worker_address(data["model"])})

    @routes.post("/receive_heart_beat")
    async def receive_heart_beat(request):
        data = await request.json()
        exist = controller.receive_heart_beat(
            data["worker_name"], data["queue_length"])
        return web.json_response({"exist": exist})

    @routes.post("/worker_generate_stream")
    async def worker_generate_stream(request):
        params = await request.json()
        resp = web.StreamResponse()
        await resp.prepare(request)
        gen = controller.worker_api_generate_stream(params)
        while True:
            chunk = await off_loop(next, gen, None)
            if chunk is None:
                break
            await resp.write(chunk)
        await resp.write_eof()
        return resp

    @routes.post("/worker_get_status")
    async def worker_get_status(request):
        return web.json_response(
            await off_loop(controller.worker_api_get_status))

    async def close_pool(app):
        pool.shutdown(wait=False, cancel_futures=True)

    app = web.Application(client_max_size=64 * 1024 * 1024)
    app.add_routes(routes)
    app.on_cleanup.append(close_pool)
    return app


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=21001)
    parser.add_argument("--dispatch-method", type=str,
                        choices=["lottery", "shortest_queue"],
                        default="shortest_queue")
    args = parser.parse_args()
    logger.info(f"args: {args}")

    from aiohttp import web

    controller = Controller(args.dispatch_method)
    web.run_app(build_app(controller), host=args.host, port=args.port,
                print=None)


if __name__ == "__main__":
    main()
