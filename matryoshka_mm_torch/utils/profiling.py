"""Profiling and tracing hooks over ``torch.profiler`` (port of
``matryoshka_mm_tpu/utils/profiling.py``, which wraps ``jax.profiler``).

The reference has no built-in tracing (SURVEY.md §5: wall-clock logging
only).  This module gives a device trace that opens in Perfetto or
``chrome://tracing``, named spans that show up on that timeline, a
host-side stage timer, and the card's memory counters.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Capture a trace of the host and, where there is a card, the device:
    ``with trace('t'): step(...)`` writes ``t/trace.json`` (Chrome trace
    format) when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named span that appears on the timeline inside a trace."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Host-side stage timer writing a JSONL breakdown (data / H2D / step)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: round(v / max(self.counts[k], 1), 6)
                for k, v in self.totals.items()}

    def dump(self):
        line = json.dumps({"avg_s": self.summary(), "totals_s":
                           {k: round(v, 4) for k, v in self.totals.items()}})
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        return line


def device_memory_stats() -> Dict[str, dict]:
    """Per card: the bytes the caching allocator holds for tensors now
    (``bytes_in_use``) and the card's total memory (``bytes_limit``).  No
    card: an empty dict."""
    out = {}
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
    return out
