"""A decode step captured as a CUDA graph and replayed with one launch.

The JAX package never decodes token by token from the host: each decode
path is one compiled program a chunk (``jax.jit`` over ``lax.scan``,
``matryoshka_mm_tpu/generate.py:152`` ``_decode_chunk_fn``, and the
batcher's ``_pool_decode_fn`` / ``_paged_pool_decode_fn``).  PyTorch
launches every kernel of a step from Python, some 2,000 launches a 7B step,
and the device idles between them.  :class:`CapturedStep` records one call
of a step function into a ``torch.cuda.CUDAGraph`` and replays it.

The step function takes no arguments.  It reads and writes only tensors
that outlive the graph (the static buffers it was built over: row state,
the KV cache, the page table), in place, so a replay does what the recorded
call did, on whatever those tensors hold at the time.  A Python value read
while the step was recorded (a slot index, a length) would be frozen into
every replay: such values live in device tensors instead (the KV cache's
``write_idx``).

* Warm-up: the step runs once eagerly, on the stream the capture uses,
  right before the capture.  That first use builds and loads the kernel
  library, runs the kernels' one-time ``cudaFuncSetAttribute`` calls, and
  lets cuBLAS set up its workspace for the stream and pick its algorithms,
  none of which may happen during a capture.  The warm-up is a real step:
  what it does to the buffers stands.
* Capture: ``capture_error_mode="thread_local"``, so that a batcher can
  capture on its scheduler thread while other threads submit requests.
  Captures are serialised by a process-wide lock (warm-up included), and
  the warm-up waits for its own stream only: a device-wide synchronize in
  one thread while another records fails with "operation not permitted
  when stream is capturing" and invalidates that capture, as two sampled
  requests of the serving worker, each capturing its decode, would.
* Random numbers: a ``torch.Generator`` passed in is registered with the
  graph (``register_generator_state``); each replay draws new numbers from
  it, and the same seed gives the same draws.
* Launch counters: each kernel wrapper counts its launches in a Python
  attribute (``flash_decode_attention.launches``, ...), which moves while
  a step is recorded and not when it is replayed.  The capture's own
  increments, those of the recording thread alone
  (``_kernels.capture_tally``: other threads may launch meanwhile, as the
  serving worker's batcher does beside a request's own decode), are taken
  back and each replay adds them again, so a count says how many kernels
  ran, captured or not.
* Errors: a failed capture or replay raises.  Nothing falls back to the
  eager step.
* Release: destroying a graph is an API call that is illegal while any
  thread records ("operation not permitted when stream is capturing"
  from ``CUDAGraph::reset``), and it invalidates that capture.  A
  ``CapturedStep`` keeps no reference to its step after the capture, so
  it forms no reference cycle with the object whose method it recorded
  and is freed where that object is dropped, not by the cycle collector
  in whatever thread it next runs; :meth:`CapturedStep.release` destroys
  the graph under the capture lock, and its owners call it when they are
  done with it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from .. import _kernels

_CAPTURE_LOCK = threading.Lock()


def launch_counters() -> tuple:
    """Every kernel wrapper of the port that counts its launches."""
    from ..ops import (decode_attention, flash_attention, fused_mlp,
                       hbm_probe, int4_matmul, paged_attention)

    return (decode_attention.flash_decode_attention,
            flash_attention.flash_attention_lse,
            flash_attention.flash_attention_bwd_dq,
            flash_attention.flash_attention_bwd_dkv,
            fused_mlp.quant_mlp, hbm_probe.hbm_read, hbm_probe.hbm_copy,
            int4_matmul.int4_matmul, int4_matmul.int8_matmul,
            paged_attention.paged_decode_attention)


class CapturedStep:
    """``step`` warmed up, captured and replayable on ``device``.

    Class-wide tallies, for a caller that wants to show the graphs ran:
    ``captures`` and ``replays`` (counts), ``capture_s`` and ``warmup_s``
    (seconds spent in captures and in their warm-up steps)."""

    captures = 0
    replays = 0
    capture_s = 0.0
    warmup_s = 0.0

    def __init__(self, step: Callable[[], object], device, *,
                 generator: Optional[torch.Generator] = None,
                 rewind: Optional[Callable[[], None]] = None):
        """``rewind``, when given, runs between the warm-up and the capture
        and takes back what the step does on the host alone (a count of
        cache slots), since recording the step runs its Python again."""
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CapturedStep: CUDA graphs need a CUDA device, "
                             f"got {device}")
        self.stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        with _CAPTURE_LOCK:
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                t0 = time.perf_counter()
                step()
                self.stream.synchronize()
                self.warmup_ms = (time.perf_counter() - t0) * 1e3
            if rewind is not None:
                rewind()

            self.graph = torch.cuda.CUDAGraph()
            if generator is not None:
                self.graph.register_generator_state(generator)
            t0 = time.perf_counter()
            with torch.cuda.stream(self.stream), \
                    _kernels.capture_tally() as tally:
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    step()
                except BaseException:
                    try:
                        self.graph.capture_end()
                    except Exception:   # noqa: BLE001: the step's error wins
                        pass
                    raise
                self.graph.capture_end()
            current.wait_stream(self.stream)
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        # the capture ran no kernel: take its counts back, replays add them
        self.counts = [(fn, n) for fn, n in tally.items() if n]
        for fn, n in self.counts:
            _kernels.count_launch(fn, -n)
        CapturedStep.captures += 1
        CapturedStep.capture_s += self.capture_ms / 1e3
        CapturedStep.warmup_s += self.warmup_ms / 1e3

    def release(self) -> None:
        """Destroy the graph now, while no thread records one; replaying
        it afterwards raises."""
        with _CAPTURE_LOCK:
            self.graph = None

    def replay(self) -> None:
        """Run the recorded step once more, on the current stream."""
        if self.graph is None:
            raise RuntimeError("CapturedStep.replay: the graph was released")
        self.graph.replay()
        for fn, n in self.counts:
            _kernels.count_launch(fn, n)
        CapturedStep.replays += 1
