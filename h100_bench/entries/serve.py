"""The serving entry: ``ContinuousBatcher.submit`` / ``stream`` under an
open-loop schedule.

Set-up makes the weights and the images from the seed, builds the batcher
and warms it up (kernel build, the captured round, the grouped prefills
of ``warmup_groups`` rows), then a lead-in of ``lead_s`` seconds of the
same traffic fills the pool.  The window submits every request due in
``[lead_s, lead_s + seconds)`` at its due time and waits for each to
finish; a request is timed from when it was due.  A traced run goes on
past the window with the schedule's next arrivals, and once every
request of the window has its first token it profiles ``TRACE_S``
seconds of them.  The profiler opens and closes on the scheduler thread
between two rounds; its start stalls that thread for seconds, so the
arrivals are held while it starts and every later due time moves back by
the hold (:class:`Gate`): the profiled seconds carry the cell's own
open loop.  The benchmark's own spans wrap the scheduler's admission,
round dispatch and round fetch; the readers of the batcher's event log
take the window, which the profiler never touches.

``correct`` compares the served tokens of a sample of the finished
requests, drawn from the seed and holding the one with most served tokens,
with the float32 reference run over each prompt and its served tokens:
the widest gap by which a served token's logit lies below the reference's
best (greedy decoding).
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from .. import traffic
from ..reference import model as ref
from ..trace import Spans, Tracer
from ..weights import make_weights


# seconds past the window's end that the run waits for the last answers
# (the longest request, 256 tokens on MPT's gather path, takes ~36 s)
DRAIN_S = 90
# seconds of arrivals a traced run profiles, after the window
TRACE_S = 1.5
# schedule seconds past the window that a traced run may submit: the
# window's last admissions (a few seconds at most) and the profiled part
TAIL_S = 20.0


class Gate:
    """Holds the arrivals while the profiler starts.  The scheduler thread
    closes it, starts the profiler and reopens it; the submitter waits at
    it, and every due time after it moves back by the seconds it was
    closed (``shift``)."""

    def __init__(self):
        self.shift = 0.0
        self._open = threading.Event()
        self._open.set()
        self._closed_at = 0.0

    def close(self) -> None:
        self._closed_at = time.perf_counter()
        self._open.clear()

    def reopen(self) -> None:
        self.shift += time.perf_counter() - self._closed_at
        self._open.set()

    def wait(self) -> None:
        self._open.wait()


@dataclasses.dataclass
class Rec:
    req: traffic.Request
    ids: np.ndarray
    due: float = 0.0
    submitted: float = 0.0
    first: Optional[float] = None
    last: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    rid: int = -1
    error: Optional[str] = None
    profiled: bool = False          # submitted while the profiler was on

    @property
    def complete(self) -> bool:
        return self.error is None and len(self.tokens) == self.req.new_tokens


def _consume(batcher, rec: Rec, req) -> None:
    try:
        for chunk in batcher.stream(req):
            t = time.perf_counter()
            if rec.first is None:
                rec.first = t
            rec.last = t
            rec.tokens.extend(int(x) for x in chunk)
    except Exception as e:          # noqa: BLE001 - a failed request counts
        rec.error = repr(e)


class Served:
    """What a cell whose answers are served tokens shares: the float32
    reference teacher-forced on a sample of them.  A sample item has
    ``ids`` (its ``(1, T)`` prompt, unpadded), ``req.image``, ``req.scale``
    and ``tokens``; the cell has ``weights``, ``spec``, ``images`` and
    ``ctx``."""

    def reference_logits(self, sample: List[Rec], lin=ref.linear):
        dev = self.ctx.device
        px = torch.as_tensor(np.stack([self.images[r.req.image]
                                       for r in sample]), device=dev)
        with torch.inference_mode(), ref.exact_float32():
            return ref.served_logits(
                self.weights, self.spec, traffic.IMAGE_TOKEN,
                [r.ids[0].tolist() for r in sample], px,
                [r.req.scale for r in sample],
                [r.tokens for r in sample], lin)

    def served_gap(self, sample: List[Rec]) -> tuple:
        """``(widest gap, tokens compared)`` of the served tokens."""
        if not sample:
            return float("inf"), 0
        logits = self.reference_logits(sample)
        gaps = [ref.gap_of(lg, r.tokens) for lg, r in zip(logits, sample)]
        return float(torch.cat(gaps).max()), sum(len(r.tokens)
                                                  for r in sample)



class ServeCell(Served):
    """One serving cell: :meth:`setup`, then one or more :meth:`window`
    calls (the rate sweep and the control run several)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.spec = ctx.spec
        self.w = ctx.workload
        self.mix = ctx.traffic
        self.batcher = None

    # ---- set-up ----
    def setup(self, seed: int) -> None:
        from matryoshka_mm_torch.generate import GenerationConfig
        from matryoshka_mm_torch.serve.batching import ContinuousBatcher

        from ..port_config import llava_config

        self.seed = seed
        dev = self.ctx.device
        t = time.perf_counter()
        self.weights = make_weights(self.spec, seed, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phases = {"weights": time.perf_counter() - t}
        self.cfg = llava_config(self.spec, self.ctx.config)
        bk = dict(self.w["batcher"])
        self.chunk = bk["chunk"]
        self.gen = GenerationConfig(
            max_new_tokens=bk["max_new_tokens"],
            eos_token_id=self.spec.decoder.vocab, pad_token_id=0,
            decode_chunk=bk["chunk"])
        t = time.perf_counter()
        self.batcher = ContinuousBatcher(self.weights, self.cfg,
                                         gen_cfg=self.gen, **bk)
        self.images = traffic.image_pool(seed, int(self.mix["images"]),
                                         self.spec.vision.image)
        phases["batcher"] = time.perf_counter() - t
        t = time.perf_counter()
        self.batcher.warmup(numtoks=max(self.spec.scales),
                            batch_sizes=tuple(self.w["warmup_groups"]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phases["warmup"] = time.perf_counter() - t
        print("set-up seconds: " + ", ".join(f"{k} {v:.2f}"
                                             for k, v in phases.items()),
              file=sys.stderr)

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.shutdown()
            self.batcher = None

    # ---- the window ----
    def window(self, rate: float, seconds: float, trace: bool = False,
               t_process: Optional[float] = None,
               log_events: bool = False) -> dict:
        """Run the schedule and return the timeline; ``setup_s`` counts
        from ``t_process`` to the first timed request's due time.  The
        batcher's event log is kept in a traced window and with
        ``log_events``."""
        lead = float(self.w["lead_s"])
        span = lead + seconds + (TAIL_S if trace else 0.0)
        sched = traffic.open_loop_schedule(self.mix, rate, span, self.seed)
        vocab = self.spec.decoder.vocab
        recs = [Rec(r, traffic.prompt_ids(self.seed, r.index, r.text_tokens,
                                          vocab, traffic.IMAGE_TOKEN))
                for r in sched]
        b = self.batcher
        spans = tracer = None
        rounds: list = []
        gate = Gate()
        if trace or log_events:
            b.events = []
        if trace:
            spans = Spans()
            tracer = Tracer(self.ctx.device)
            tracer.warm()               # before the schedule's clock starts
        clock = (time.perf_counter(), time.time_ns())
        t0 = clock[0] + 0.05
        if trace:
            # the lead-in's and the window's requests, in due order
            before = [r for r in recs if r.req.due_s < lead + seconds]
            t_off = 0.0

            def before_round() -> None:
                """On the scheduler thread, which launches all the device
                work: open or close the profiler between two rounds (never
                while another thread launches), then keep the round's
                input state, which it never writes again once dispatched.
                The profiler opens once every request of the window has
                its first token, with the arrivals held."""
                nonlocal t_off
                if tracer.t1_ns is None:
                    if not tracer.on and before[-1].submitted \
                            and all(r.first is not None or r.error
                                    for r in before):
                        gate.close()
                        tracer.start()
                        gate.reopen()
                        t_off = time.perf_counter() + TRACE_S
                    elif tracer.on and time.perf_counter() >= t_off:
                        tracer.stop()
                rounds.append((time.perf_counter(), b.lengths, b.budget,
                               b.active))

            spans.wrap(b, "_admit_pending", "admit")
            spans.wrap(b, "_process_round", "round.fetch")
            spans.wrap(b, "_decode_round", "round.dispatch",
                       before=before_round)

        threads = []
        for rec in recs:
            while True:
                shift = gate.shift
                rec.due = t0 + rec.req.due_s + shift
                while (now := time.perf_counter()) < rec.due:
                    time.sleep(rec.due - now)
                gate.wait()
                if gate.shift == shift:
                    break
            if tracer is not None and tracer.t1_ns is not None:
                break                   # the profiled arrivals are over
            req = b.submit(rec.ids, self.images[rec.req.image][None],
                           numtoks=rec.req.scale,
                           max_new_tokens=rec.req.new_tokens)
            rec.submitted = time.perf_counter()
            rec.rid = req.rid
            rec.profiled = tracer is not None and tracer.on \
                and tracer.t1_ns is None
            th = threading.Thread(target=_consume, args=(b, rec, req),
                                  daemon=True)
            th.start()
            threads.append(th)
        end = t0 + lead + seconds
        deadline = max(time.perf_counter(), end) + DRAIN_S
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.perf_counter()))
        for rec, th in zip(recs, threads):
            if th.is_alive() and rec.error is None:
                rec.error = "unfinished at the deadline"
        t_done = time.perf_counter()
        if spans is not None:
            spans.unwrap()
        if tracer is not None and tracer.on:
            tracer.stop()      # every request has ended: nothing launches
        counted = [r for r in recs if lead <= r.req.due_s < lead + seconds]
        out = {"recs": recs, "counted": counted, "t0": t0, "lead": lead,
               "seconds": seconds, "t_done": t_done,
               "events": b.events, "rounds": rounds, "spans": spans,
               "clock": clock, "held_s": gate.shift, "tracer": tracer,
               "chunk": self.chunk}
        if t_process is not None:
            out["setup_s"] = t0 + lead - t_process
        b.events = None
        return out

    # ---- correctness ----
    def sample(self, counted: List[Rec], n: int) -> List[Rec]:
        """The finished request with most served tokens (then the longest
        prompt), and ``n - 1`` more drawn from the seed."""
        done = [r for r in counted if r.complete]
        if not done:
            return []
        longest = max(done, key=lambda r: (len(r.tokens), r.req.text_tokens,
                                           -r.req.index))
        rest = [r for r in done if r is not longest]
        pick = traffic.rng(self.seed, 5).permutation(len(rest))[:n - 1]
        return [longest] + [rest[i] for i in sorted(pick)]

    def free_program(self) -> None:
        """Drop the program's state (the pool, the captured round); the
        weights and images stay for the reference."""
        self.close()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
            torch.cuda.empty_cache()


def _p(xs, p):
    return traffic.percentile(xs, p)


def timings(win: dict) -> dict:
    """The end-to-end numbers of a window's counted requests."""
    c = win["counted"]
    ttft = [(r.first - r.due) * 1e3 for r in c if r.first is not None]
    tpot = [(r.last - r.first) * 1e3 / (len(r.tokens) - 1) for r in c
            if r.complete and len(r.tokens) > 1]
    return {"ttft_ms": ttft, "tpot_ms": tpot,
            "failed": sum(1 for r in c if not r.complete),
            "attempted": len(c)}


def run(ctx, seed: int, seconds: float, trace: bool, t_process: float) -> dict:
    """One run of a serving cell: the harness's entry point."""
    cell = ServeCell(ctx)
    cell.setup(seed)
    win = cell.window(float(ctx.workload["rate_per_s"]), seconds, trace,
                      t_process)
    peak = ctx.memory_peak()
    t = timings(win)
    cell.free_program()
    check = ctx.workload["check"]
    sample = cell.sample(win["counted"], int(check["sample"]))
    gap, n_tok = cell.served_gap(sample)
    limit = float(check["max_logit_gap"])
    e2e = {"ttft_p95_ms": _p(t["ttft_ms"], 95),
           "tpot_p95_ms": _p(t["tpot_ms"], 95),
           "setup_s": win["setup_s"]}
    extra = {"generator_late_ms_p99": _p(
                 [r.submitted - r.due for r in win["counted"]], 99) * 1e3,
             "ttft_p50_ms": _p(t["ttft_ms"], 50),
             "tpot_p50_ms": _p(t["tpot_ms"], 50),
             "served_tokens_compared": n_tok}
    profiled = [(r.submitted - r.due) * 1e3 for r in win["recs"]
                if r.profiled]
    if profiled:
        # how long the arrivals were held while the profiler started, and
        # how late the profiled ones came after it
        extra.update(held_s=win["held_s"],
                     profiled_late_ms_max=max(profiled))
    return {
        "attempted": t["attempted"], "failed": t["failed"],
        "e2e": e2e, "memory_peak_bytes": peak, "window": win,
        "tracer": win["tracer"], "spans": win["spans"], "extra": extra,
        "checks": {"max_logit_gap": [gap, limit],
                   "failed_requests": [t["failed"], 0]},
    }
