"""Model worker: serves one model behind the controller protocol (the port
of ``matryoshka_mm_tpu/serve/model_worker.py``).

Port of the reference worker (reference: llava/serve/model_worker.py:44-291):
registration + 15s heartbeats with queue length, a semaphore concurrency
limit, and ``/worker_generate_stream`` streaming cumulative text as
``\\0``-delimited JSON.  Generation runs through the port's chunked decode
(``generate.stream_generate``, a captured CUDA graph a request on the card)
or, with ``--continuous-batching``, through ``serve/batching.py``'s
``ContinuousBatcher`` (``--kv-backend paged``: the paged-attention kernel),
instead of a torch thread + TextIteratorStreamer; with ``--tp-size N``
through the ``TPEngine`` of ``parallel/tp_decode.py`` (N ranks, one card
each).  The model runs on
``--device`` (``cuda`` unless ``cpu`` is asked for).  ``requests`` and
``aiohttp`` are imported where they are used.

    python -m matryoshka_mm_torch.serve.model_worker --model-path debug://7b \\
        --continuous-batching --kv-backend paged --max-batch 8 --warmup
"""

from __future__ import annotations

import argparse
import asyncio
import json
import threading
import time
import uuid
from functools import partial

from typing import Optional

import numpy as np
import torch

from ..constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IMAGE_TOKEN_INDEX,
    WORKER_HEART_BEAT_INTERVAL,
)
from ..mm_utils import load_image_from_base64, process_images, tokenizer_image_token
from ..models.builder import load_pretrained_model
from ..utils.logging import build_logger, pretty_print_semaphore, server_error_msg

worker_id = str(uuid.uuid4())[:6]
logger = build_logger("model_worker", f"model_worker_{worker_id}.log")
global_counter = 0
model_semaphore = None


def resolve_auto_kv_dtype(cfg, weights_bytes: int, max_batch: int,
                          capacity: int, hbm_bytes: Optional[int] = None,
                          workspace_bytes: int = 2 << 30,
                          device="cuda") -> str:
    """Pick the KV-cache dtype from pool pressure (``--kv-cache-dtype
    auto``).

    int8 KV doubles the pages a byte budget holds but costs decode
    throughput (``PERF.md`` has the card's figures), so it is ON only when
    the bf16 pool would not fit next to the weights.  Returns "int8" when
    the bf16 pool for (max_batch x capacity) slots exceeds the device
    memory left after the weights and a workspace, else "" (bf16 KV).

    ``hbm_bytes`` defaults to the total memory of the CUDA device
    ``device``; a CPU device must be given it.
    """
    if hbm_bytes is None:
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError("kv-cache-dtype auto reads the card's memory: "
                             "pass hbm_bytes for a CPU device")
        hbm_bytes = torch.cuda.get_device_properties(device).total_memory
    l = cfg.llama
    pool_bf16 = (2 * l.num_hidden_layers * max_batch * capacity
                 * l.num_key_value_heads * l.head_dim * 2)
    budget = hbm_bytes - weights_bytes - workspace_bytes
    return "int8" if pool_bf16 > budget else ""


def heart_beat_worker(worker):
    while True:
        time.sleep(WORKER_HEART_BEAT_INTERVAL)
        worker.send_heart_beat()


class ModelWorker:
    def __init__(self, controller_addr, worker_addr, worker_id, no_register,
                 model_path, model_base, model_name,
                 load_8bit=False, load_4bit=False, device="cuda",
                 limit_model_concurrency=5,
                 continuous_batching=False, max_batch=4, kv_backend="dense",
                 prefix_cache=False, warmup=False, pool_prefill_len=None,
                 pool_max_new=1024, lora_adapters=None, kv_cache_dtype="",
                 speculative_k=0, tp_size=0):
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = worker_id
        self.no_register = no_register
        self.limit_model_concurrency = limit_model_concurrency
        if model_path.endswith("/"):
            model_path = model_path[:-1]
        if model_name is None:
            model_paths = model_path.split("/")
            if model_paths[-1].startswith("checkpoint-"):
                self.model_name = model_paths[-2] + "_" + model_paths[-1]
            else:
                self.model_name = model_paths[-1]
        else:
            self.model_name = model_name

        self.device = device
        if tp_size > 1 and continuous_batching:
            raise ValueError(
                "--tp-size serves through the solo generate path; the "
                "continuous batcher's kernels run on one card (drop "
                "--continuous-batching)")
        if tp_size > 1 and kv_cache_dtype == "auto":
            # auto sizes one card's pool, after the load, and the ranks'
            # caches are set when the engine starts
            raise ValueError("--kv-cache-dtype auto with --tp-size: give "
                             "int8 or leave it empty")
        logger.info(f"Loading the model {self.model_name} on worker {worker_id} ...")
        auto_kv = kv_cache_dtype == "auto"
        (self.tokenizer, self.model, self.image_processor,
         self.context_len) = load_pretrained_model(
            model_path, model_base, self.model_name, load_8bit, load_4bit,
            device=device, kv_cache_dtype="" if auto_kv else kv_cache_dtype,
            tp_size=tp_size,
            # multi-LoRA targets per-projection leaves: keep the
            # unfused quantized layout when adapters are configured
            quant_fuse=not lora_adapters)
        if auto_kv:
            # pool-pressure policy (resolve_auto_kv_dtype): int8 KV only
            # when the bf16 pool won't fit next to the loaded weights
            from ..ops.quant import tree_nbytes

            cap = ((pool_prefill_len or
                    (min(self.model.cfg.tokenizer_model_max_length, 1024)
                     + self.model.cfg.vision.num_patches)) + pool_max_new
                   if continuous_batching else self.context_len + 1024)
            rows = max_batch if continuous_batching else \
                limit_model_concurrency
            picked = resolve_auto_kv_dtype(
                self.model.cfg, tree_nbytes(self.model.params), rows, cap,
                device=device)
            logger.info(f"kv-cache-dtype auto -> {picked or 'bf16'} "
                        f"(rows={rows}, capacity={cap})")
            if picked:
                self.model.cfg = self.model.cfg.with_kv_cache_dtype(picked)
        self.is_multimodal = ("llava" in self.model_name.lower()
                              or model_path.startswith("debug://"))

        self.batcher = None
        if continuous_batching:
            from .batching import ContinuousBatcher

            # pool sizing: at 7B MHA the KV is 512 KiB a token, so the pool
            # budget (max_batch x (prefill_len + max_new)) must fit next to
            # the weights — expose both knobs
            if pool_prefill_len is None:
                pool_prefill_len = (
                    min(self.model.cfg.tokenizer_model_max_length, 1024)
                    + self.model.cfg.vision.num_patches)
            adapters = None
            if lora_adapters:
                from ..utils.checkpoint import load_checkpoint

                # each a save_lora_checkpoint directory: its "lora" tree
                # is the form ContinuousBatcher(adapters=) takes
                adapters = {}
                for spec in lora_adapters.split(","):
                    name, _, path = spec.partition("=")
                    restored, _ = load_checkpoint(path, device=device)
                    adapters[name] = restored["lora"]
                logger.info(f"loaded LoRA adapters: {sorted(adapters)}")
            gen_cfg = None
            if speculative_k:
                from ..generate import GenerationConfig

                # speculative serving is greedy-only (temperature 0 — the
                # reference eval protocol); sampled requests should use a
                # non-speculative worker
                gen_cfg = GenerationConfig(temperature=0.0, do_sample=False)
            fsm_vocab = None
            if kv_backend == "paged" and not speculative_k:
                # enables regex-constrained requests ("regex" in params /
                # SGLang sampling_params) at zero cost until first use
                from .constrained import vocab_from_tokenizer

                try:
                    fsm_vocab = vocab_from_tokenizer(self.tokenizer)
                except Exception:   # exotic tokenizer: constraints off
                    fsm_vocab = None
            self.batcher = ContinuousBatcher(
                self.model.params, self.model.cfg, max_batch=max_batch,
                prefill_len=pool_prefill_len,
                max_new_tokens=pool_max_new, backend=kv_backend,
                prefix_cache=prefix_cache, adapters=adapters,
                gen_cfg=gen_cfg, speculative_k=speculative_k,
                fsm_vocab=fsm_vocab)
            if warmup:
                dt = self.batcher.warmup(with_image=self.is_multimodal)
                logger.info(f"warmup took {dt:.1f}s")

        if not no_register:
            self.register_to_controller()
            self.heart_beat_thread = threading.Thread(
                target=heart_beat_worker, args=(self,), daemon=True)
            self.heart_beat_thread.start()

    def register_to_controller(self):
        import requests

        logger.info("Register to controller")
        url = self.controller_addr + "/register_worker"
        data = {"worker_name": self.worker_addr, "check_heart_beat": True,
                "worker_status": self.get_status()}
        r = requests.post(url, json=data)
        if r.status_code != 200:
            raise RuntimeError(f"controller {self.controller_addr} refused "
                               f"the registration: HTTP {r.status_code}")

    def send_heart_beat(self, block: bool = True):
        """``block=True`` (the dedicated heartbeat thread) retries until
        the controller answers.  Request-context beats MUST pass
        ``block=False``: they run on (or from) the aiohttp event loop,
        and the retry-forever loop would freeze every endpoint for as
        long as the controller is unreachable."""
        if self.no_register:
            return  # standalone worker: no controller to talk to
        import requests

        logger.info(f"Send heart beat. Models: {[self.model_name]}. "
                    f"Semaphore: {pretty_print_semaphore(model_semaphore)}. "
                    f"global_counter: {global_counter}")
        url = self.controller_addr + "/receive_heart_beat"
        while True:
            try:
                ret = requests.post(url, json={
                    "worker_name": self.worker_addr,
                    "queue_length": self.get_queue_length()}, timeout=5)
                exist = ret.json()["exist"]
                break
            except requests.exceptions.RequestException as e:
                logger.error(f"heart beat error: {e}")
                if not block:
                    return  # the 15s heartbeat thread will retry
            time.sleep(5)
        if not exist:
            self.register_to_controller()

    def get_queue_length(self):
        if model_semaphore is None:
            return 0
        waiters = (len(model_semaphore._waiters)
                   if model_semaphore._waiters is not None else 0)
        return self.limit_model_concurrency - model_semaphore._value + waiters

    def get_status(self):
        status = {"model_names": [self.model_name], "speed": 1,
                  "queue_length": self.get_queue_length()}
        if self.batcher is not None:
            status["batcher"] = {
                "active": int(sum(s is not None for s in self.batcher.slots)),
                "pending": self.batcher.pending.qsize(),
                "backend": self.batcher.backend,
                "healthy": self.batcher.error is None,
                **({"speculative": dict(self.batcher.spec_stats)}
                   if self.batcher.spec_k else {}),
                **(self.batcher.stats
                   if getattr(self.batcher, "index", None) is not None else {}),
            }
        return status

    def generate_stream(self, params):
        from ..generate import GenerationConfig, stream_generate

        tokenizer = self.tokenizer
        model = self.model

        prompt = params["prompt"]
        ori_prompt = prompt
        images = params.get("images", None)
        num_image_tokens = 0
        pixel_values = None
        image_sizes = None
        if images is not None and len(images) > 0 and self.is_multimodal:
            if len(images) != prompt.count(DEFAULT_IMAGE_TOKEN):
                raise ValueError("Number of images does not match number of "
                                 "<image> tokens in prompt")
            images = [load_image_from_base64(image) for image in images]
            image_sizes = [im.size for im in images]
            pixel_values = process_images(images, self.image_processor,
                                          model.config)
            replace_token = DEFAULT_IMAGE_TOKEN
            if getattr(model.config, "mm_use_im_start_end", False):
                replace_token = (DEFAULT_IM_START_TOKEN + replace_token
                                 + DEFAULT_IM_END_TOKEN)
            prompt = prompt.replace(DEFAULT_IMAGE_TOKEN, replace_token)
            num_image_tokens = (prompt.count(replace_token)
                                * model.cfg.vision.num_patches)

        matryoshka_vis_token_scale = params.get("matryoshka_vis_token_scale", None)
        temperature = float(params.get("temperature", 1.0))
        top_p = float(params.get("top_p", 1.0))
        max_context_length = model.cfg.llama.max_position_embeddings
        max_new_tokens = min(int(params.get("max_new_tokens", 256)), 1024)
        # "stop" may be one string or a list (SGLang clients send lists);
        # normalize to a tuple of non-empty strings
        stop = params.get("stop", None)
        if isinstance(stop, str):
            stops = (stop,) if stop else ()
        else:
            stops = tuple(s for s in (stop or ()) if s)

        def stop_cut(text: str):
            """Index of the earliest stop-string hit in ``text``, else
            None — generation must actually TERMINATE at the stop string
            (and never leak it or anything after it), not just strip a
            chunk that happens to end with it."""
            hits = [text.find(s) for s in stops]
            hits = [h for h in hits if h >= 0]
            return min(hits) if hits else None

        do_sample = temperature > 0.001

        input_ids = np.asarray(
            tokenizer_image_token(prompt, tokenizer, IMAGE_TOKEN_INDEX),
            np.int32)[None, :]
        max_new_tokens = min(max_new_tokens,
                             max_context_length - input_ids.shape[-1]
                             - num_image_tokens)
        if max_new_tokens < 1:
            yield json.dumps({
                "text": ori_prompt + "Exceeds max token length. Please start "
                        "a new conversation, thanks.",
                "error_code": 0}).encode() + b"\0"
            return

        gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, do_sample=do_sample,
            eos_token_id=getattr(tokenizer, "eos_token_id", 2),
            pad_token_id=getattr(tokenizer, "pad_token_id", 0) or 0,
            decode_chunk=8)

        # continuous-batching path: greedy v0 fixed-scale requests —
        # single-tile AND anyres multi-tile — share one batched decode
        # pool; everything else (sampling, v2 combine, multi-image) uses
        # the solo stream
        use_batcher = self.batcher is not None and not do_sample
        px_arr = None if pixel_values is None else np.asarray(pixel_values)
        anyres = px_arr is not None and px_arr.ndim == 5
        if anyres:
            if px_arr.shape[0] != 1:
                use_batcher = False   # multi-image anyres: solo stream
            else:
                px_arr = px_arr[0]    # (T_tiles, 3, H, W) single request
        elif px_arr is not None and px_arr.ndim != 4:
            use_batcher = False
        elif px_arr is not None and px_arr.shape[0] > 1:
            # pad-mode multi-image stack: the pool would treat the frames
            # as anyres tiles of one image (batcher.submit rejects it);
            # the solo stream splices image i at sentinel i
            use_batcher = False
        numtoks = None
        if matryoshka_vis_token_scale:
            from ..kvconfig import parse_kv_from_string

            kvs = parse_kv_from_string(matryoshka_vis_token_scale)
            if kvs.get("ver") != "v0" or not isinstance(kvs.get("numtoks"), int):
                use_batcher = False
            else:
                numtoks = int(kvs["numtoks"])
        img_size = (tuple(image_sizes[0]) if anyres and image_sizes
                    else None)
        if use_batcher and not self.batcher.fits(
                input_ids, numtoks,
                px_arr if anyres else None, img_size):
            use_batcher = False     # prompt exceeds the pool prefill region;
            # the solo stream sizes its own prefill, so route there instead
            # of letting a negative left-pad crash the shared scheduler

        lora_id = params.get("lora")
        if lora_id and not (self.batcher is not None
                            and lora_id in self.batcher.lora_names):
            raise ValueError(f"unknown LoRA adapter {lora_id!r}")
        if lora_id and not use_batcher:
            raise ValueError("LoRA requests require the continuous-batching "
                             "greedy v0 path")
        regex = params.get("regex")
        if not regex and params.get("json_schema"):
            from .constrained import regex_for_json_schema

            regex = regex_for_json_schema(params["json_schema"])
        if regex and not (use_batcher
                          and getattr(self.batcher, "fsm_vocab", None)):
            raise ValueError("regex-constrained requests require the "
                             "continuous-batching worker (paged backend; "
                             "the batcher is constructed with the "
                             "tokenizer vocab automatically)")
        if use_batcher:
            from .batching import BatchError

            req = self.batcher.submit(
                input_ids,
                None if px_arr is None else np.asarray(px_arr, np.float32),
                numtoks=numtoks, max_new_tokens=max_new_tokens,
                lora_id=lora_id, image_size=img_size,
                constraint_regex=regex)
            acc = []
            try:
                for chunk_toks in self.batcher.stream(req):
                    # no by-value filtering: the batcher's stream carries
                    # only real tokens (-1 sentinel design) and decode's
                    # skip_special_tokens hides eos — dropping ids equal
                    # to pad would lose genuine content (id 0 is a real
                    # piece for non-llama vocabs)
                    acc.extend(int(t) for t in np.ravel(chunk_toks))
                    new_text = tokenizer.decode(acc,
                                                skip_special_tokens=True)
                    cut = stop_cut(new_text)
                    if cut is not None:
                        # stop string hit: truncate before it, retire the
                        # row (stop burning pool budget), end the stream
                        self.batcher.cancel(req)
                        yield json.dumps(
                            {"text": ori_prompt + new_text[:cut],
                             "error_code": 0}).encode() + b"\0"
                        return
                    yield json.dumps({"text": ori_prompt + new_text,
                                      "error_code": 0}).encode() + b"\0"
            except BatchError as e:
                # aborted mid-stream (pool pressure): tell the client
                # explicitly rather than ending like a completed response
                yield json.dumps({"text": server_error_msg,
                                  "error_code": e.code}).encode() + b"\0"
            return

        px_np = (np.asarray(pixel_values, np.float32)
                 if pixel_values is not None else None)
        if model.tp_engine is not None:
            # tensor-parallel worker: the engine's ranks, the kernels kept
            # on every shard; it raises on the modes it does not cover
            stream = model.tp_engine.stream_generate(
                input_ids, px_np, image_sizes=image_sizes,
                matryoshka_vis_token_scale=matryoshka_vis_token_scale,
                gen_cfg=gen_cfg)
        else:
            stream = stream_generate(
                model.params, model.cfg, input_ids, px_np,
                image_sizes=image_sizes,
                matryoshka_vis_token_scale=matryoshka_vis_token_scale,
                gen_cfg=gen_cfg)
        for ids in stream:
            new_text = tokenizer.decode(
                [int(t) for t in ids[0] if t != gen_cfg.pad_token_id],
                skip_special_tokens=True)
            cut = stop_cut(new_text)
            if cut is not None:
                # abandoning the lazy stream generator stops the decode
                yield json.dumps({"text": ori_prompt + new_text[:cut],
                                  "error_code": 0}).encode() + b"\0"
                return
            generated_text = ori_prompt + new_text
            yield json.dumps({"text": generated_text,
                              "error_code": 0}).encode() + b"\0"

    def generate_stream_gate(self, params):
        try:
            for x in self.generate_stream(params):
                yield x
        except ValueError as e:
            print("Caught ValueError:", e)
            yield json.dumps({"text": server_error_msg,
                              "error_code": 1}).encode() + b"\0"
        except Exception as e:
            print("Caught Unknown Error", e)
            yield json.dumps({"text": server_error_msg,
                              "error_code": 1}).encode() + b"\0"


def build_app(worker: ModelWorker):
    from aiohttp import web

    routes = web.RouteTableDef()

    def release_model_semaphore(fn=None):
        model_semaphore.release()
        if fn is not None:
            fn()

    @routes.post("/worker_generate_stream")
    async def generate_stream_endpoint(request):
        global model_semaphore, global_counter
        global_counter += 1
        params = await request.json()

        if model_semaphore is None:
            model_semaphore = asyncio.Semaphore(worker.limit_model_concurrency)
        await model_semaphore.acquire()
        loop = asyncio.get_event_loop()
        # heartbeats do blocking HTTP — keep them off the event loop, and
        # non-blocking (single attempt) so an unreachable controller
        # can't freeze the server (the 15s thread owns the retries)
        await loop.run_in_executor(
            None, lambda: worker.send_heart_beat(block=False))

        resp = web.StreamResponse()
        await resp.prepare(request)
        try:
            gen = worker.generate_stream_gate(params)
            while True:
                chunk = await loop.run_in_executor(None, lambda: next(gen, None))
                if chunk is None:
                    break
                await resp.write(chunk)
        finally:
            release_model_semaphore()
            loop.run_in_executor(
                None, lambda: worker.send_heart_beat(block=False))
        await resp.write_eof()
        return resp

    @routes.post("/worker_get_status")
    async def get_status(request):
        return web.json_response(worker.get_status())

    @routes.post("/count_token")
    async def count_token(request):
        params = await request.json()
        prompt = params["prompt"]
        try:
            input_ids = worker.tokenizer(prompt).input_ids
            ret = {"count": len(input_ids), "error_code": 0}
        except Exception:
            ret = {"count": 0, "error_code": 1}
        return web.json_response(ret)

    @routes.post("/model_details")
    async def model_details(request):
        return web.json_response({"context_length": worker.context_len})

    async def drop_model_semaphore(app):
        # the semaphore binds itself to this app's event loop: a later app
        # of the same process, on another loop, makes its own
        global model_semaphore
        model_semaphore = None

    app = web.Application(client_max_size=64 * 1024 * 1024)
    app.add_routes(routes)
    app.on_cleanup.append(drop_model_semaphore)
    return app


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=21002)
    parser.add_argument("--worker-address", type=str,
                        default="http://localhost:21002")
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--model-path", type=str, default="debug://7b")
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--model-name", type=str)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--stream-interval", type=int, default=1)
    parser.add_argument("--no-register", action="store_true")
    parser.add_argument("--load-8bit", action="store_true")
    parser.add_argument("--load-4bit", action="store_true")
    parser.add_argument("--use-flash-attn", action="store_true",
                        help="accepted for the reference's command lines: "
                             "attention takes the kernels on the card "
                             "regardless")
    parser.add_argument("--continuous-batching", action="store_true")
    parser.add_argument("--max-batch", type=int, default=4)
    parser.add_argument("--lora-adapters", type=str, default=None,
                        help="comma-separated name=checkpoint_dir LoRA "
                             "adapters served on the shared base "
                             "(request param: lora=<name>)")
    parser.add_argument("--pool-prefill-len", type=int, default=None,
                        help="continuous-batching prompt region (tokens); "
                             "default ctx+num_patches")
    parser.add_argument("--pool-max-new", type=int, default=1024,
                        help="continuous-batching decode region per request")
    parser.add_argument("--warmup", action="store_true",
                        help="build the kernels and capture the decode "
                             "round before serving traffic")
    parser.add_argument("--prefix-cache", action="store_true",
                        help="reuse KV pages across requests sharing a "
                             "prompt prefix (paged backend only)")
    parser.add_argument("--kv-backend", type=str, default="dense",
                        choices=["dense", "paged"],
                        help="continuous-batching KV layout: fixed pool or "
                             "paged (per-row page tables, the paged-"
                             "attention kernel on the card)")
    parser.add_argument("--speculative-k", type=int, default=0,
                        help="continuous batching: verify k prompt-lookup "
                             "draft tokens per step (greedy-only; paged "
                             "backend); 0 disables")
    parser.add_argument("--tp-size", type=int, default=0,
                        help="tensor parallelism over this many cards "
                             "(one rank a card, NCCL): the solo stream "
                             "runs on every rank's shard; not with "
                             "--continuous-batching")
    parser.add_argument("--kv-cache-dtype", type=str, default="",
                        choices=["", "int8", "auto"],
                        help="int8: KV slots stored int8 with per-slot "
                             "scales: half the KV bytes a token (2x pages "
                             "per byte budget under --kv-backend paged) at "
                             "a cost in decode throughput; auto: int8 only "
                             "when the bf16 pool won't fit next to the "
                             "weights (resolve_auto_kv_dtype)")
    args = parser.parse_args()
    logger.info(f"args: {args}")

    worker = ModelWorker(args.controller_address, args.worker_address,
                         worker_id, args.no_register, args.model_path,
                         args.model_base, args.model_name, args.load_8bit,
                         args.load_4bit, args.device,
                         limit_model_concurrency=args.limit_model_concurrency,
                         continuous_batching=args.continuous_batching,
                         max_batch=args.max_batch,
                         kv_backend=args.kv_backend,
                         prefix_cache=args.prefix_cache, warmup=args.warmup,
                         pool_prefill_len=args.pool_prefill_len,
                         pool_max_new=args.pool_max_new,
                         lora_adapters=args.lora_adapters,
                         kv_cache_dtype=args.kv_cache_dtype,
                         speculative_k=args.speculative_k,
                         tp_size=args.tp_size)

    from aiohttp import web

    web.run_app(build_app(worker), host=args.host, port=args.port, print=None)


if __name__ == "__main__":
    main()
