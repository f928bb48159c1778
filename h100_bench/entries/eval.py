"""The eval-sweep entry: ``generate.generate`` called back to back, as
``eval/model_vqa_loader.py --batch-size <rows>`` calls it: one caller in a
closed loop, ``rows`` questions a call, every row of a call at one scale,
the scales cycling, each question left-padded to a multiple of 32.

Set-up makes the weights and images from the seed and warms one call at
every scale.  The window calls until ``--seconds`` have passed (the call
in flight finishes); ``eval_questions_s`` is the rows answered over the
window's seconds.  A traced run then profiles ``TRACE_CALLS`` more calls.

``correct`` is the serving comparison: a sample of the answered rows,
drawn from the seed and holding the longest prompt, against the float32
reference teacher-forced on the prompt and its answer.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import List

import numpy as np
import torch

from .. import traffic
from ..trace import Spans, Tracer
from ..weights import make_weights
from .serve import Served

# calls a traced run profiles, after the window
TRACE_CALLS = 5


@dataclasses.dataclass
class Row:
    req: traffic.Request
    ids: np.ndarray                  # (1, T) unpadded
    tokens: List[int] = dataclasses.field(default_factory=list)


class EvalCell(Served):

    def __init__(self, ctx):
        self.ctx, self.spec = ctx, ctx.spec
        self.w, self.mix = ctx.workload, ctx.traffic

    def setup(self, seed: int) -> None:
        from ..port_config import llava_config

        self.seed, dev = seed, self.ctx.device
        t = time.perf_counter()
        self.weights = make_weights(self.spec, seed, dev)
        self.cfg = llava_config(self.spec, self.ctx.config)
        self.images = traffic.image_pool(seed, int(self.mix["images"]),
                                         self.spec.vision.image)
        t1 = time.perf_counter()
        for b in traffic.eval_batches(self.mix, len(self.mix["scales"]),
                                      seed + 1):
            self.call(b)
        print(f"set-up seconds: weights {t1 - t:.2f}, warm-up "
              f"{time.perf_counter() - t1:.2f}", file=sys.stderr)

    def rows(self, b: traffic.EvalBatch) -> List[Row]:
        vocab = self.spec.decoder.vocab
        out = []
        for j, n in enumerate(b.text_tokens):
            k = b.index * len(b.text_tokens) + j
            req = traffic.Request(k, 0.0, n, int(self.w["max_new_tokens"]),
                                  b.scale, k % int(self.mix["images"]))
            out.append(Row(req, traffic.prompt_ids(self.seed, k, n, vocab,
                                                   traffic.IMAGE_TOKEN)))
        return out

    def call(self, b: traffic.EvalBatch) -> List[Row]:
        """One ``generate`` call over the batch's rows, left-padded to a
        multiple of ``pad_to``; its answers land in the rows."""
        from matryoshka_mm_torch.generate import GenerationConfig, generate

        rows = self.rows(b)
        pad = int(self.mix["pad_to"])
        T = -(-max(r.ids.shape[1] for r in rows) // pad) * pad
        ids = np.zeros((len(rows), T), np.int32)
        mask = np.zeros((len(rows), T), bool)
        for i, r in enumerate(rows):
            ids[i, T - r.ids.shape[1]:] = r.ids[0]
            mask[i, T - r.ids.shape[1]:] = True
        px = self.images[[r.req.image for r in rows]]
        gen = GenerationConfig(max_new_tokens=int(self.w["max_new_tokens"]),
                               eos_token_id=self.spec.decoder.vocab,
                               pad_token_id=0,
                               decode_chunk=int(self.w["max_new_tokens"]))
        out = generate(self.weights, self.cfg, ids, px, attention_mask=mask,
                       matryoshka_vis_token_scale=f"ver=v0_numtoks={b.scale}",
                       gen_cfg=gen, cuda_graph=True)
        for r, toks in zip(rows, out):
            r.tokens = [int(t) for t in toks]
        return rows

    def window(self, seconds: float, trace: bool) -> dict:
        from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

        spans = Spans()
        batches = iter(traffic.eval_batches(self.mix, 1 << 20, self.seed))
        calls, traced, answered = [], [], []

        def one(on: bool) -> None:
            t, t_ns = time.perf_counter(), time.time_ns()
            answered.append(self.call(next(batches)))
            calls.append(time.perf_counter() - t)
            spans.spans.append(("generate call: host", 0, t_ns,
                                time.time_ns()))
            traced.append(on)

        cap0 = CapturedStep.warmup_s + CapturedStep.capture_s
        t0 = time.perf_counter()
        while not calls or time.perf_counter() - t0 < seconds:
            one(False)
        elapsed = time.perf_counter() - t0
        capture_s = CapturedStep.warmup_s + CapturedStep.capture_s - cap0
        tracer = None
        if trace:
            tracer = Tracer(self.ctx.device)
            tracer.start()
            for _ in range(TRACE_CALLS):
                one(True)
            tracer.stop()
        return {"calls": calls, "traced": traced, "answered": answered,
                "elapsed": elapsed, "tracer": tracer, "spans": spans,
                "capture_s": capture_s}

    def sample(self, answered: List[List[Row]], n_calls: int) -> List[Row]:
        """The rows of ``n_calls`` calls drawn from the seed, the call
        holding the longest prompt among them."""
        longest = max(range(len(answered)), key=lambda i: max(
            r.ids.shape[1] + r.req.scale for r in answered[i]))
        rest = [i for i in range(len(answered)) if i != longest]
        pick = traffic.rng(self.seed, 7).permutation(len(rest))[:n_calls - 1]
        return [r for i in [longest] + sorted(rest[j] for j in pick)
                for r in answered[i]]

    def free_program(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
            torch.cuda.empty_cache()


def run(ctx, seed: int, seconds: float, trace: bool, t_process: float) -> dict:
    """One run of an eval-sweep cell: the harness's entry point."""
    cell = EvalCell(ctx)
    cell.setup(seed)
    setup_s = time.perf_counter() - t_process
    win = cell.window(seconds, trace)
    peak = ctx.memory_peak()
    cell.free_program()
    n_rows = sum(len(a) for a, t in zip(win["answered"], win["traced"])
                 if not t)
    failed = sum(1 for a in win["answered"] for r in a
                 if len(r.tokens) != int(ctx.workload["max_new_tokens"]))
    check = ctx.workload["check"]
    sample = cell.sample(win["answered"], int(check["sample_calls"]))
    gap, n_tok = cell.served_gap(sample)
    limit = float(check["max_logit_gap"])
    return {
        "attempted": sum(len(a) for a in win["answered"]), "failed": failed,
        "e2e": {"eval_questions_s": n_rows / win["elapsed"],
                "setup_s": setup_s},
        "memory_peak_bytes": peak, "tracer": win["tracer"],
        "spans": win["spans"], "window": win,
        "extra": {"calls": len(win["calls"]),
                  "served_tokens_compared": n_tok},
        "checks": {"max_logit_gap": [gap, limit],
                   "failed_rows": [failed, 0]},
    }
