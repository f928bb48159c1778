"""The traced window: the profiler's device events, the benchmark's own
host spans, and what both reduce to (busy seconds, the device operations
that took most time, the longest idle gaps by what the host was doing).

Spans are recorded only by the benchmark, around its calls into the
program: :class:`Spans` wraps a method of one object for the traced run
and restores it after.  Times are the host's wall clock in nanoseconds,
the clock the profiler maps the device's timestamps onto (with an offset
that moves by a few milliseconds).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


class Spans:
    """``(name, thread, start_ns, end_ns)`` of each wrapped call."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int, int]] = []
        self._wrapped: List[Tuple[object, str]] = []

    def wrap(self, obj, attr: str, name: str,
             before: Optional[Callable[[], None]] = None) -> None:
        inner = getattr(obj, attr)
        spans = self.spans

        def wrapper(*a, **k):
            if before is not None:
                before()
            t0 = time.time_ns()
            try:
                return inner(*a, **k)
            finally:
                spans.append((name, threading.get_ident(), t0,
                              time.time_ns()))

        setattr(obj, attr, wrapper)
        self._wrapped.append((obj, attr))

    def unwrap(self) -> None:
        for obj, attr in self._wrapped:
            delattr(obj, attr)
        self._wrapped = []

    def at(self, t_ns: int) -> str:
        """The name of a span covering ``t_ns``, the innermost first."""
        best = None
        for name, _, a, b in self.spans:
            if a <= t_ns <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "host: between spans"


class Tracer:
    """``torch.profiler`` over one window, device activity only."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity

        self.device = device
        self.activity = ProfilerActivity.CUDA if device.type == "cuda" \
            else ProfilerActivity.CPU
        self.prof = None
        self.on = False
        self.t0_ns: Optional[int] = None
        self.t1_ns: Optional[int] = None
        self._events: Optional[list] = None

    def warm(self) -> None:
        """Open and close one empty profile: the tracer's first start
        takes seconds, which would otherwise fall inside the window."""
        from torch.profiler import profile

        with profile(activities=[self.activity]):
            torch.zeros((1,), device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import profile

        self.prof = profile(activities=[self.activity])
        self.prof.__enter__()
        self.t0_ns = time.time_ns()
        self.on = True

    def stop(self) -> None:
        self.t1_ns = time.time_ns()
        self.prof.__exit__(None, None, None)
        self.on = False

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def events(self) -> List[Tuple[str, int, int]]:
        """``(name, start_ns, end_ns)`` of every device operation in the
        window (kernels, copies, sets), clipped to it."""
        if self._events is None:
            kinds = torch.autograd.DeviceType
            want = kinds.CUDA if self.device.type == "cuda" else kinds.CPU
            out = []
            for e in self.prof.profiler.kineto_results.events():
                if e.device_type() != want:
                    continue
                a = max(e.start_ns(), self.t0_ns)
                b = min(e.start_ns() + e.duration_ns(), self.t1_ns)
                if b > a:
                    out.append((e.name(), a, b))
            out.sort(key=lambda x: x[1])
            self._events = out
        return self._events

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals."""
        merged: List[List[int]] = []
        for _, a, b in self.events():
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def time_by_name(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """``(seconds, count)`` of the operations whose name matches."""
        sel = [(a, b) for n, a, b in self.events() if match(n)]
        return sum(b - a for a, b in sel) / 1e9, len(sel)

    def breakdown(self, spans: Optional[Spans], top: int = 10) -> dict:
        """The ``top`` device operations by time, and the ``top`` longest
        idle gaps on the device, each named by the host span it fell in."""
        by_name: Dict[str, float] = {}
        for n, a, b in self.events():
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.t0_ns] + [x for iv in self.busy_intervals()
                                for x in iv] + [self.t1_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [[spans.at((a + b) // 2) if spans else "host", (b - a) / 1e9]
                 for a, b in gaps[:top]]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": named}
