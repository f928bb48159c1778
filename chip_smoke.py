#!/usr/bin/env python3
"""Drive the PyTorch port (matryoshka_mm_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero, and no phase's exception is caught:

1. device: require CUDA; print the card (nvidia-smi name and power limit),
   torch.version.cuda, nvcc and Triton versions; turn TF32 off;
2. build: compile csrc/*.cu with nvcc for sm_90a (one nvcc per source, all
   at once), print ptxas usage and the build time;
3. kernels against their plain PyTorch versions at the main path's shapes
   in bf16, with max errors and the median time of kernel and plain version
   over CUDA events: prefill flash attention B=1 H=32 Dh=128 Sq=640 against
   a 672-slot cache, GQA and window cases; decode attention B in {1, 4},
   S=672, GQA, window and a ragged S, then its int8-KV branch at B in
   {1, 4}, S in {672, 673}, GQA and window; int4_matmul / int8_matmul at the
   7B projections (qkv 12288x4096, o 4096x4096, gateup 22016x4096, down
   4096x11008, lm_head 32000x4096) for M in {1, 4, 640}; quant_mlp at 7B
   widths for M in {1, 4}, int4 and int8;
4. the bf16 slice at full width: load_pretrained_model("debug://7b")
   (random weights from a seed), five one-image requests with 32 greedy
   tokens at ver=v0_numtoks in {1, 9, 36, 144, 576} and a left-padded B=4
   batch at 144; the launch counters must show 32 flash launches per
   prefill and 32 decode launches per decode step; one prefill's
   last-position logits are held against attn_impl="reference" (cosine
   >= 0.99); TTFT per scale, decode tok/s at B=1 and B=4, peak memory;
5. the quantized slice at full width: debug://7b under load_4bit (scales
   144 and 576 at B=1, 144 at a left-padded B=4), load_8bit (144, B=1) and
   load_4bit with kv_cache_dtype="int8" (144, B=4); the launch counters
   must equal the counts of 32 layers (per prefill qkv, o, gateup, down
   and lm_head through the matmul kernel, per decode step qkv, o and
   lm_head through it, one quant_mlp and one decode attention per
   step-layer); one prefill's last-position logits are held against the
   same weights under disable_fused_proj() (cosine >= 0.99, same argmax);
   TTFT, decode tok/s and peak memory per configuration;
6. paged attention against its plain version at the 7B shapes (H=Hkv=32,
   Dh=128, page 64, 25 pages a row; bf16 and int8 pools; the stacked form
   at layers 0 and 31; B=1 and B=8; ragged row lengths 0, 63, 64, 65 and a
   full row; scattered page tables; one GQA case), timed at B=8 with
   ~700-token rows; the bandwidth probes against their plain versions on a
   small array, then the calibration run: hbm_read_gb_s over 512 MiB and
   hbm_copy_gb_s over 256 MiB at 1, 4 and 16 passes a launch (median and
   least-greatest of 7 runs);
7. the serving slice at full width, debug://7b in bf16 and under load_4bit
   with kv_cache_dtype="int8": ContinuousBatcher(backend="paged",
   max_batch=8, prefill_len=1024, max_new_tokens=128, page_size=64,
   chunk=8) answers 12 requests (8 as a burst, 4 joining late) at scales
   9 / 144 / 576 with 32-64 new tokens each.  Every stream must end with
   its budget and no BatchError; the launch counts of every kernel on the
   path must be exact (paged attention: decode steps x 32); admissions must
   have been grouped; every page must be back on the free list.  Then 8
   long requests are stopped in mid-decode and one decode step on that live
   pool is taken with use_kernel=True and use_kernel=False: in float32
   (weights and pool cast up) the logits' cosine is >= 0.999 and the argmax
   the same in every row; in the model's dtype the cosine is >= 0.995 (>=
   0.999 in the rows of 200 tokens or more), the
   kernel lies at most twice as far from the float32 step as the gather path
   does, and the argmax is the same wherever the top two logits lie farther
   apart than the two paths' logits; three layers' attention over the live
   pool is held against float32 attention.  One decode round is profiled
   (device ms per step, idle share, top kernels).
   On the bf16 model one short run each with prefix_cache=True (a repeated
   prompt hits its three cached pages), speculative_k=4 (the verify steps
   add up) and a constraint_regex (the output full-matches); phase 8 holds
   the tokens of the first two equal to the plain run's in float32.
   Printed, with the card's name and power limit: tok/s over the batch,
   TTFT p50 / max, ms a decode step, mean occupancy, pool size, peak memory;
8. a small model (Dh=128, float32) on the card against the same weights on
   the CPU (plain versions): same greedy tokens from generate and from the
   batcher with the paged and with the dense backend, the paged one also
   with prefix_cache=True (hit == miss) and speculative_k=4.

Each kernel's record carries its bound: the larger of its bytes (inputs once,
outputs once) over 3.35 TB/s and its operations over 989 TFLOP/s, the H100
data sheet's rates, computed from this run's inputs; and, where one PyTorch
call computes the same function, that call's time (library_ms, timed in
the function of that name and used nowhere else).

The line before the last is the kernels' JSON record, the last line the
device JSON.  Needs no network and no package beyond torch and numpy.
"""

from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

FLASH_TOL = 2e-2      # bf16 outputs, P rounded to bf16 before PV
LSE_TOL = 1e-3
MM_TOL = 1e-2         # of max|plain|: bf16 outputs, f32 sums in another order
MLP_TOL = 2e-2        # of max|plain|: the bf16 h may round the other way
LOGIT_COS = 0.99
L2_SWEEP = 150_000_000   # bytes: three times the H100's 50 MB L2 cache
SLEEP_CYCLES = 50_000_000  # ~30 ms: the host queues the timed calls meanwhile
# the 7B weight shapes (N, K) of the quantized projections
QUANT_SHAPES = {"qkv": (12288, 4096), "o": (4096, 4096),
                "gateup": (22016, 4096), "down": (4096, 11008),
                "lm_head": (32000, 4096)}
QUANT_ROWS = (1, 4, 640)
# (label, load_pretrained_model options, requests as (batch, numtoks))
QUANT_RUNS = (
    ("int4", {"load_4bit": True}, ((1, 144), (1, 576), (4, 144))),
    ("int8", {"load_8bit": True}, ((1, 144),)),
    ("int4+kv8", {"load_4bit": True, "kv_cache_dtype": "int8"},
     ((4, 144),)),
)
SCALES = (1, 9, 36, 144, 576)
BATCH_SCALE = 144     # the scale of the left-padded B=4 batch
NEW_TOKENS = 32
PROMPT_LEN = 40
HBM_BYTES_S = 3.35e12    # H100 SXM data sheet: device memory rate
PEAK_FLOPS = 989e12      # and the dense bf16 rate of the tensor cores
# one decode step through the paged kernel against the gather path, logits
# cosine per row.  In float32 the two compute one function (readings on the
# live 7B pool: cosine 1.0 to seven digits, logits 3.5e-5 apart over a bf16
# pool cast up and 2.7e-4 over an int8 pool):
PAGED_COS_F32 = 0.999
# In bf16 one layer's attention comes out of either path half a bf16 unit of
# its output from the float32 attention (7.9e-3 at |out| = 3) and one unit
# from the other's (``live_attention_check`` prints them), and 32 layers of
# random weights amplify that: each path's logits read cosine 0.9986-0.9996
# against the float32 step's, and the same against each other's, the rows of
# under 100 tokens lowest.  So the kernel is held to the gather path's own
# distance from the float32 step, PAGED_EXCESS times it at most, and to a
# coarse floor against the gather path
PAGED_COS = 0.995
PAGED_EXCESS = 2.0
# rows of PAGED_LONG tokens or more are held to the float32 step's limit in
# bf16 too (they read 0.99944-0.99955)
PAGED_LONG = 200
# the serving slice: (numtoks, new tokens) of the 8 burst and 4 late requests
SERVE_BURST = ((9, 32), (9, 48), (144, 64), (144, 40), (144, 56), (576, 32),
               (576, 64), (576, 48))
SERVE_LATE = ((9, 64), (144, 32), (576, 40), (144, 48))
SERVE_RUNS = (("serve bf16", {}),
              ("serve int4+kv8", {"load_4bit": True,
                                  "kv_cache_dtype": "int8"}))
SERVE_KW = dict(backend="paged", max_batch=8, prefill_len=1024,
                max_new_tokens=128, page_size=64, chunk=8)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


@functools.cache
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them; printed
    beside every measurement."""
    return sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])


def time_ms(fn, operands, reps: int = 20, warmup: int = 2) -> float:
    """Device milliseconds per call of ``fn(*operands[i % len(operands)])``.

    The stream first sleeps on the card while the host queues the calls, so
    they run back to back and the host's launch cost (Python, ctypes) stays
    out of the interval between the two CUDA events.  ``operands`` holds
    copies of the inputs (``rotations``) that together exceed the L2 cache,
    so each call reads its operands from device memory, as the model's
    per-layer calls do."""
    for i in range(warmup):
        fn(*operands[i % len(operands)])
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*operands[i % len(operands)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: float, flops: float) -> dict:
    """The least time the card could take for this work: its bytes over the
    memory rate or its operations over the peak rate, whichever is
    larger."""
    t_bytes = moved_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library_ms(kind: str, operands: list, **kw) -> float:
    """Yardsticks: the time of the ONE PyTorch call that computes the same
    function as a kernel on the same operands.  Timed here and used nowhere
    in the port (its package may not call these operators at all).
    ``flash``: (q, k, v) with ``kv_valid`` and index causality folded into
    one boolean mask; ``decode``: the decode wrapper's operands, the mask
    from ``valid``; ``copy``: (src, dst)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kind == "flash":
        Sq, Sk = operands[0][0].shape[2], operands[0][1].shape[2]
        dev = operands[0][0].device
        causal = torch.arange(Sk, device=dev)[None] <= \
            torch.arange(Sq, device=dev)[:, None]
        mask = (kw["kv_valid"][:, None, None, :] & causal[None, None])
        return time_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask),
                       operands)
    if kind == "decode":
        def call(q, k, v, valid, kv_pos, q_pos):
            return sdpa(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=valid[:, None, None, :])
        return time_ms(call, operands)
    if kind == "copy":
        return time_ms(lambda src, dst: dst.copy_(src), operands)
    raise ValueError(kind)


def rotations(*tensors) -> list:
    """``tensors`` and copies of them, together at least ``L2_SWEEP``
    bytes."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, -(-L2_SWEEP // nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device() -> str:
    card = card_line()
    print(card)
    from matryoshka_mm_torch import _kernels

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")
    print(sh([_kernels._nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton not installed")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    from matryoshka_mm_torch import _kernels

    t0 = time.perf_counter()
    _kernels.build(verbose=True)
    _kernels.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand(shape, gen, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)


def phase_kernels(dev) -> dict:
    from matryoshka_mm_torch.ops import decode_attention as dec
    from matryoshka_mm_torch.ops import flash_attention as fl
    from matryoshka_mm_torch.ops.quant import _quantize_kv_slots

    gen = torch.Generator(device=dev).manual_seed(0)
    Dh, Sq, Sk, pad = 128, 640, 672, 23
    rec = {"flash_attention": {"err": 0.0}, "decode_attention": {"err": 0.0}}

    for name, H, Hkv, window in (("mha", 32, 32, None), ("gqa", 32, 8, None),
                                 ("window", 32, 32, 256)):
        q = _rand((1, H, Sq, Dh), gen, dev)
        # K/V as the strided (B, Hkv, S, Dh) view of a cache layer, as the
        # cached prefill passes them
        k = _rand((1, Sk, Hkv, Dh), gen, dev).transpose(1, 2)
        v = _rand((1, Sk, Hkv, Dh), gen, dev).transpose(1, 2)
        valid = torch.zeros((1, Sk), dtype=torch.bool, device=dev)
        valid[0, pad:Sq] = True                       # left-padded prompt
        kw = dict(kv_valid=valid, sliding_window=window)
        out, lse = fl.flash_attention_lse(q, k, v, **kw)
        ref_o, ref_l = fl.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref_o.float()).abs().max().item()
        lerr = (lse - ref_l).abs().max().item()
        ok = torch.allclose(out.float(), ref_o.float(), atol=FLASH_TOL,
                            rtol=FLASH_TOL) and lerr <= LSE_TOL
        print(f"[flash {name}] max|out-plain|={err:.3e} "
              f"max|lse-plain|={lerr:.3e}")
        if not ok:
            fail(f"flash {name} disagrees with its plain version")
        rec["flash_attention"]["err"] = max(rec["flash_attention"]["err"],
                                            err)
        if name == "mha":
            ops = rotations(q, k, v)
            rec["flash_attention"]["ms"] = time_ms(
                lambda *a: fl.flash_attention_lse(*a, **kw), ops)
            rec["flash_attention"]["plain_ms"] = time_ms(
                lambda *a: fl.flash_attention_plain(*a, **kw), ops, reps=5)
            rec["flash_attention"]["library_ms"] = library_ms(
                "flash", ops, kv_valid=valid)
            # pairs (query i, valid slot j <= i): 2 products of Dh each
            pairs = int((valid[0][None, :] & (
                torch.arange(Sk, device=dev)[None]
                <= torch.arange(Sq, device=dev)[:, None])).sum())
            rec["flash_attention"].update(bound(
                nbytes(q, k, v) + nbytes(out, lse), 4 * H * Dh * pairs))
            _show("flash mha", rec["flash_attention"])

    for name, B, H, Hkv, S, window in (
            ("b1", 1, 32, 32, 672, None), ("b4", 4, 32, 32, 672, None),
            ("gqa", 4, 32, 8, 672, None), ("window", 4, 32, 32, 672, 128),
            ("ragged", 2, 32, 32, 673, None)):
        q = _rand((B, H, Dh), gen, dev)
        k_all = _rand((2, B, S, Hkv, Dh), gen, dev)
        v_all = _rand((2, B, S, Hkv, Dh), gen, dev)
        valid = torch.zeros((B, S), dtype=torch.bool, device=dev)
        valid[:, :S - 20] = True
        valid[-1, :31] = False                        # a left-padded row
        kv_pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
        q_pos = torch.full((B,), S - 21, device=dev, dtype=torch.int32)
        args = (q, k_all[1], v_all[1], valid, kv_pos, q_pos)
        got = dec.flash_decode_attention(*args, sliding_window=window)
        want = dec.decode_attention_plain(*args, sliding_window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"[decode {name}] max|out-plain|={err:.3e}")
        if not torch.allclose(got.float(), want.float(), atol=FLASH_TOL,
                              rtol=FLASH_TOL):
            fail(f"decode {name} disagrees with its plain version")
        rec["decode_attention"]["err"] = max(rec["decode_attention"]["err"],
                                             err)
        if name in ("b1", "b4"):
            ops = rotations(*args)
            ms = time_ms(dec.flash_decode_attention, ops)
            plain = time_ms(dec.decode_attention_plain, ops, reps=5)
            rec["decode_attention"][f"ms_{name}"] = ms
            rec["decode_attention"][f"plain_ms_{name}"] = plain
            print(f"[decode {name}] kernel {ms:.4f} ms  plain {plain:.4f} ms")
            if name == "b1":
                rec["decode_attention"]["library_ms"] = library_ms(
                    "decode", ops)
                slots = int(valid.sum())      # K and V of the valid slots
                rec["decode_attention"].update(bound(
                    2 * slots * Hkv * Dh * 2 + nbytes(q, got, valid),
                    4 * H * Dh * slots))
    for name, B, H, Hkv, S, window in (
            ("int8 b1", 1, 32, 32, 672, None), ("int8 b4", 4, 32, 32, 673, None),
            ("int8 gqa", 4, 32, 8, 672, None),
            ("int8 window", 4, 32, 32, 673, 128)):
        q = _rand((B, H, Dh), gen, dev)
        kq, ks = _quantize_kv_slots(_rand((2, B, S, Hkv, Dh), gen, dev))
        vq, vs = _quantize_kv_slots(_rand((2, B, S, Hkv, Dh), gen, dev))
        valid = torch.zeros((B, S), dtype=torch.bool, device=dev)
        valid[:, :S - 20] = True
        valid[-1, :31] = False
        kv_pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
        q_pos = torch.full((B,), S - 21, device=dev, dtype=torch.int32)
        args = (q, kq[1], vq[1], valid, kv_pos, q_pos)
        kw = dict(sliding_window=window, k_scale=ks[1], v_scale=vs[1])
        got = dec.flash_decode_attention(*args, **kw)
        want = dec.decode_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"[decode {name}] max|out-plain|={err:.3e}")
        if not torch.allclose(got.float(), want.float(), atol=FLASH_TOL,
                              rtol=FLASH_TOL):
            fail(f"decode {name} disagrees with its plain version")
        rec["decode_attention"]["err"] = max(rec["decode_attention"]["err"],
                                             err)
        if name == "int8 b1":
            ops = rotations(*args, ks[1], vs[1])

            def kernel(*a):
                return dec.flash_decode_attention(
                    *a[:6], sliding_window=window, k_scale=a[6],
                    v_scale=a[7])

            def plain_fn(*a):
                return dec.decode_attention_plain(
                    *a[:6], sliding_window=window, k_scale=a[6],
                    v_scale=a[7])

            ms = time_ms(kernel, ops)
            plain = time_ms(plain_fn, ops, reps=5)
            print(f"[decode {name}] kernel {ms:.4f} ms  plain {plain:.4f} ms")
    rec["decode_attention"]["ms"] = rec["decode_attention"]["ms_b1"]
    rec["decode_attention"]["plain_ms"] = \
        rec["decode_attention"]["plain_ms_b1"]
    _show("decode b1", rec["decode_attention"])
    return rec


def _show(label: str, r: dict) -> None:
    lib = r.get("library_ms")
    print(f"[{label}] {card_line()}: kernel {r['ms']:.4f} ms  plain "
          f"{r['plain_ms']:.4f} ms  "
          f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}  library "
          + ("none" if lib is None else f"{lib:.4f} ms"))


def _rel_err(got, want) -> tuple:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-9)


def phase_quant_kernels(dev) -> dict:
    """int4_matmul / int8_matmul at the 7B projections and quant_mlp at 7B
    widths against their plain versions.  Each record's ``ms`` /
    ``plain_ms`` is the B=1 decode time of the qkv projection (matmuls) or
    of one layer's MLP (quant_mlp)."""
    from matryoshka_mm_torch.ops import fused_mlp as mlp
    from matryoshka_mm_torch.ops import int4_matmul as mm
    from matryoshka_mm_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(1)
    rec = {}
    for bits, name in ((4, "int4_matmul"), (8, "int8_matmul")):
        fn = getattr(mm, name)
        plain = getattr(mm, f"{name}_plain")
        quantize = quant.quantize_array_int4 if bits == 4 \
            else quant.quantize_array
        key = quant.Q4KEY if bits == 4 else quant.QKEY
        r = rec[name] = {"err": 0.0}
        for shape, (N, K) in QUANT_SHAPES.items():
            leaf = quantize(_rand((N, K), gen, dev).mul_(0.02))
            w, sc = leaf[key], leaf["scale"]
            del leaf
            for M in QUANT_ROWS:
                x = _rand((M, K), gen, dev)
                err, rel = _rel_err(fn(x, w, sc), plain(x, w, sc))
                torch.cuda.synchronize()
                line = (f"[{name} {shape} {N}x{K} M={M}] max|out-plain|="
                        f"{err:.3e} rel {rel:.2e}")
                if rel > MM_TOL:
                    fail(f"{name} {shape} M={M} disagrees with its plain "
                         f"version")
                r["err"] = max(r["err"], err)
                if M != 4:
                    ops = rotations(x, w, sc)
                    ms = time_ms(fn, ops)
                    pms = time_ms(plain, ops, reps=3, warmup=1)
                    r[f"ms_{shape}_{M}"], r[f"plain_ms_{shape}_{M}"] = ms, pms
                    if (shape, M) == ("qkv", 1):
                        r.update(bound(nbytes(x, w, sc) + M * N * 2,
                                       2 * M * N * K), library_ms=None)
                    line += (f"  kernel {ms:.4f} ms  plain {pms:.4f} ms  "
                             f"weights {w.numel() / ms / 1e6:.1f} GB/s")
                print(line)
        r["ms"], r["plain_ms"] = r["ms_qkv_1"], r["plain_ms_qkv_1"]
        _show(f"{name} qkv M=1", r)

    r = rec["quant_mlp"] = {"err": 0.0}
    D, I = 4096, 11008
    for bits in (4, 8):
        quantize = quant.quantize_array_int4 if bits == 4 \
            else quant.quantize_array
        key = quant.Q4KEY if bits == 4 else quant.QKEY
        gate = quantize(_rand((I, D), gen, dev).mul_(0.02))
        up = quantize(_rand((I, D), gen, dev).mul_(0.02))
        gateup = {key: torch.cat([gate[key], up[key]]),
                  "scale": torch.cat([gate["scale"], up["scale"]])}
        del gate, up
        down = quantize(_rand((D, I), gen, dev).mul_(0.02))
        for M in (1, 4):
            x = _rand((M, D), gen, dev)
            err, rel = _rel_err(mlp.quant_mlp(x, gateup, down, bits, I),
                                mlp.quant_mlp_plain(x, gateup, down, bits, I))
            torch.cuda.synchronize()
            line = (f"[quant_mlp int{bits} M={M}] max|out-plain|={err:.3e} "
                    f"rel {rel:.2e}")
            if rel > MLP_TOL:
                fail(f"quant_mlp int{bits} M={M} disagrees with its plain "
                     f"version")
            r["err"] = max(r["err"], err)
            if M == 1:
                ops = rotations(x, gateup[key], gateup["scale"], down[key],
                                down["scale"])

                def call(f):
                    return lambda x, gq, gs, dq, ds: f(
                        x, {key: gq, "scale": gs}, {key: dq, "scale": ds},
                        bits, I)

                ms = time_ms(call(mlp.quant_mlp), ops)
                pms = time_ms(call(mlp.quant_mlp_plain), ops, reps=3,
                              warmup=1)
                r[f"ms_int{bits}"], r[f"plain_ms_int{bits}"] = ms, pms
                if bits == 4:
                    r.update(bound(nbytes(*ops[0]) + M * D * 2,
                                   2 * M * 3 * I * D), library_ms=None)
                line += f"  kernel {ms:.4f} ms  plain {pms:.4f} ms"
            print(line)
    r["ms"], r["plain_ms"] = r["ms_int4"], r["plain_ms_int4"]
    _show("quant_mlp int4 M=1", r)
    return rec


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------

def make_prompt(rng, length, vocab):
    ids = rng.integers(100, vocab, (length,)).astype(np.int32)
    ids[0] = 1                                        # BOS
    ids[5] = -200                                     # the image sentinel
    return ids


def make_inputs(cfg) -> dict:
    """batch -> (ids, pixels, mask): one B=1 prompt and a left-padded B=4
    batch, from a seed."""
    rng = np.random.default_rng(0)
    vocab, size = cfg.llama.vocab_size, cfg.vision.image_size
    px1 = rng.standard_normal((1, 3, size, size)).astype(np.float32)
    ids1 = make_prompt(rng, PROMPT_LEN, vocab)[None]
    lens4 = (PROMPT_LEN, 33, 28, 37)
    ids4 = np.zeros((4, PROMPT_LEN), np.int32)
    mask4 = np.zeros((4, PROMPT_LEN), bool)
    for b, n in enumerate(lens4):
        ids4[b, PROMPT_LEN - n:] = make_prompt(rng, n, vocab)
        mask4[b, PROMPT_LEN - n:] = True
    px4 = rng.standard_normal((4, 3, size, size)).astype(np.float32)
    return {1: (ids1, px1, None), 4: (ids4, px4, mask4)}


def run(model, inputs, numtoks, new_tokens):
    ids, px, mask = inputs
    out = model.generate(ids, images=px, attention_mask=mask,
                         matryoshka_vis_token_scale=f"ver=v0_numtoks="
                                                    f"{numtoks}",
                         max_new_tokens=new_tokens, eos_token_id=-1)
    torch.cuda.synchronize()
    if out.shape != (ids.shape[0], new_tokens) or out.min() < 0 \
            or out.max() >= model.cfg.llama.vocab_size:
        fail(f"numtoks={numtoks}: output {out.shape} ids "
             f"[{out.min()}, {out.max()}]")
    return out


def prefill_logits(model, cfg, inputs, numtoks):
    """Last-position logits of row 0 after one prefill, in f32."""
    from matryoshka_mm_torch.generate import _round_up, prefill_image

    dev = model.params["llama"]["embed_tokens"].device
    ids, px, mask = inputs
    L = _round_up(ids.shape[1] - 1 + numtoks, 64)
    mask_t = None if mask is None else torch.as_tensor(mask, device=dev)
    return prefill_image(model.params, cfg,
                         torch.as_tensor(ids, dtype=torch.int64, device=dev),
                         torch.as_tensor(px, device=dev), mask_t, numtoks, L,
                         L + NEW_TOKENS)[0][0].float()


def compare_logits(a, b, what, need_same_top: bool) -> None:
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
    same_top = int(a.argmax()) == int(b.argmax())
    print(f"[{what}] prefill logits: cosine {cos:.6f} finite {finite} "
          f"same argmax {same_top}")
    if not (finite and cos >= LOGIT_COS) or (need_same_top and not same_top):
        fail(f"{what}: kernel-path logits disagree with the reference")


def time_requests(model, inputs, numtoks, label, reps=(3, 2)) -> tuple:
    """Median TTFT (1 token) and decode tok/s (NEW_TOKENS tokens) on the
    host clock, each request ending in a synchronize."""
    ttft = statistics.median(
        _wall(lambda: run(model, inputs, numtoks, 1)) for _ in range(reps[0]))
    full = statistics.median(
        _wall(lambda: run(model, inputs, numtoks, NEW_TOKENS))
        for _ in range(reps[1]))
    batch = inputs[0].shape[0]
    rate = batch * (NEW_TOKENS - 1) / (full - ttft)
    print(f"[{label}] B={batch} numtoks={numtoks:4d} TTFT {ttft * 1e3:.2f} ms"
          f"  decode {rate:.2f} tok/s  (prefill slots "
          f"{-(-(PROMPT_LEN - 1 + numtoks) // 64) * 64})")
    return ttft, rate


def phase_slice(dev) -> dict:
    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, model, _, _ = load_pretrained_model("debug://7b", device=str(dev))
    torch.cuda.synchronize()
    print(f"[slice] debug://7b made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = model.cfg
    n_layers = cfg.llama.num_hidden_layers
    inputs = make_inputs(cfg)

    # ---- the counted main-path run ----
    requests = [(1, n) for n in SCALES] + [(4, BATCH_SCALE)]
    flash_attention_lse.launches = 0
    flash_decode_attention.launches = 0
    outs = [run(model, inputs[b], n, NEW_TOKENS) for b, n in requests]
    launches = {"flash_attention": flash_attention_lse.launches,
                "decode_attention": flash_decode_attention.launches}
    want = {"flash_attention": len(requests) * n_layers,
            "decode_attention": len(requests) * (NEW_TOKENS - 1) * n_layers}
    print(f"[slice] launches {launches} expected {want}")
    if launches != want:
        fail("the main path did not go through the kernels as expected")
    print(f"[slice] B=1 tokens at {BATCH_SCALE}: "
          f"{outs[SCALES.index(BATCH_SCALE)][0, :12].tolist()}")

    # ---- kernel path against attn_impl="reference" on one prefill ----
    compare_logits(
        prefill_logits(model, cfg, inputs[1], BATCH_SCALE),
        prefill_logits(model, cfg.with_attn_impl("reference"), inputs[1],
                       BATCH_SCALE), "slice", need_same_top=False)

    # ---- timings (after the counted run, which warmed everything up) ----
    for n in SCALES:
        time_requests(model, inputs[1], n, "slice", reps=(2, 1))
    time_requests(model, inputs[4], BATCH_SCALE, "slice", reps=(2, 1))
    print(f"[slice] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"launches": launches}


def phase_quant_slice(dev) -> dict:
    """The quantized configurations at full width; returns the launch counts
    summed over their counted runs."""
    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.ops import fused_mlp, int4_matmul
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse
    from matryoshka_mm_torch.ops.quant import disable_fused_proj

    counters = {"int4_matmul": int4_matmul.int4_matmul,
                "int8_matmul": int4_matmul.int8_matmul,
                "quant_mlp": fused_mlp.quant_mlp,
                "decode_attention": flash_decode_attention,
                "flash_attention": flash_attention_lse}
    total = dict.fromkeys(counters, 0)
    for label, options, requests in QUANT_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, model, _, _ = load_pretrained_model("debug://7b", device=str(dev),
                                               **options)
        torch.cuda.synchronize()
        print(f"[{label}] debug://7b {options} made and quantized on the "
              f"card in {time.perf_counter() - t0:.1f} s: decoder weights "
              f"{_nbytes(model.params['llama']) / 2**30:.2f} GiB, peak while "
              f"quantizing {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB")
        torch.cuda.reset_peak_memory_stats()
        cfg = model.cfg
        L = cfg.llama.num_hidden_layers
        inputs = make_inputs(cfg)

        # ---- the counted main-path run ----
        for fn in counters.values():
            fn.launches = 0
        for b, n in requests:
            run(model, inputs[b], n, NEW_TOKENS)
        launches = {k: fn.launches for k, fn in counters.items()}
        prefills = len(requests)
        steps = prefills * (NEW_TOKENS - 1)
        matmul = "int4_matmul" if options.get("load_4bit") else "int8_matmul"
        want = dict.fromkeys(counters, 0)
        want.update({matmul: prefills * (4 * L + 1) + steps * (2 * L + 1),
                     "quant_mlp": steps * L, "decode_attention": steps * L,
                     "flash_attention": prefills * L})
        print(f"[{label}] launches {launches} expected {want}")
        if launches != want:
            fail(f"{label}: the main path did not go through the kernels as "
                 f"expected")
        for k in total:
            total[k] += launches[k]

        # ---- the kernels against dequantize-and-multiply, one prefill ----
        b, n = requests[0]
        got = prefill_logits(model, cfg, inputs[b], n)
        with disable_fused_proj():
            want_logits = prefill_logits(model, cfg, inputs[b], n)
        compare_logits(got, want_logits, label, need_same_top=True)

        for b, n in requests:
            time_requests(model, inputs[b], n, label)
        print(f"[{label}] max_memory_allocated while serving "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model
    return total


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0



# ---------------------------------------------------------------------------
# phase 6: paged attention and the bandwidth probes
# ---------------------------------------------------------------------------

def _paged_pools(gen, dev, L, n_pages, page, Hkv, Dh, int8):
    """Stacked pools ``(L, n_pages, page, Hkv, Dh)``; the int8 ones hold
    random codes with random positive scales."""
    shape = (L, n_pages, page, Hkv, Dh)
    if not int8:
        return _rand(shape, gen, dev), _rand(shape, gen, dev), None, None

    def codes():
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales():
        return torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.005

    return codes(), codes(), scales(), scales()


def _paged_work(lens, H, Hkv, Dh, kv_bytes, int8, q) -> dict:
    """Bound of one paged-attention call: K and V of the ``row_len + 1``
    slots each row attends (and their scales), q, out, the page ids used."""
    slots = int((lens + 1).sum())
    moved = 2 * slots * Hkv * Dh * kv_bytes + 2 * nbytes(q) \
        + (2 * slots * Hkv * 4 if int8 else 0) \
        + 4 * (int(((lens + 64) // 64).sum()) + lens.numel())
    return bound(moved, 4 * H * Dh * slots)


def phase_paged_kernels(dev) -> dict:
    from matryoshka_mm_torch.ops import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(2)
    L, page, P, Dh, H = 32, 64, 25, 128, 32
    rec = {"err": 0.0, "library_ms": None}
    full = P * page - 1
    cases = (("b1", 1, 32, [700]),
             ("b8 ragged", 8, 32, [0, 63, 64, 65, full, 700, 5, 128]),
             ("b8 gqa", 8, 8, [0, 63, 64, 65, full, 700, 5, 128]),
             ("b8 700", 8, 32, [700, 663, 712, 689, 731, 702, 695, 708]))
    for int8 in (False, True):
        for name, B, Hkv, row_len in cases:
            n_pages = 8 * P + 1
            k, v, ks, vs = _paged_pools(gen, dev, L, n_pages, page, Hkv, Dh,
                                        int8)
            q = _rand((B, H, Dh), gen, dev)
            # scattered, non-monotone page ids; page 0 stays the trash page
            perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
            tables = perm[:B * P].reshape(B, P).to(torch.int32)
            lens = torch.tensor(row_len, device=dev, dtype=torch.int32)
            label = f"paged {'int8' if int8 else 'bf16'} {name}"
            for layer in (0, L - 1):
                got = pa.paged_decode_attention_stacked(
                    q, k, v, layer, tables, lens, ks, vs)
                want = pa.paged_attention_plain(
                    q, k[layer], v[layer], tables, lens,
                    None if ks is None else ks[layer],
                    None if vs is None else vs[layer])
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                print(f"[{label} layer {layer}] max|out-plain|={err:.3e}")
                if not torch.allclose(got.float(), want.float(),
                                      atol=FLASH_TOL, rtol=FLASH_TOL):
                    fail(f"{label} disagrees with its plain version")
                rec["err"] = max(rec["err"], err)
            if name == "b8 700":
                # each call reads another layer's pool: 92 MB of K and V
                # a call, so none finds its pages in the 50 MB L2
                def args(i):
                    l = i % L
                    return (q, k[l], v[l], tables, lens,
                            None if ks is None else ks[l],
                            None if vs is None else vs[l])

                ops = [args(i) for i in range(L)]
                ms = time_ms(pa.paged_decode_attention, ops)
                pms = time_ms(pa.paged_attention_plain, ops, reps=5)
                work = _paged_work(lens, H, Hkv, Dh, k.element_size(), int8,
                                   q)
                if not int8:        # the record's times: the bf16 pools
                    rec.update(work, ms=ms, plain_ms=pms)
                _show(label, dict(work, ms=ms, plain_ms=pms))
            del k, v, ks, vs
    return {"paged_attention": rec}


def phase_hbm(dev) -> tuple:
    """The probes against their plain versions, then the calibration run
    through ``hbm_read_gb_s`` / ``hbm_copy_gb_s`` with the launch counts
    read around it.  Returns ``(records, launches, measured read GB/s)``."""
    from matryoshka_mm_torch.ops import hbm_probe as hbm

    gen = torch.Generator(device=dev).manual_seed(3)
    for n, reps in ((16 * 1000, 1), (16 * 300_001, 3)):
        x = torch.randint(-127, 128, (n,), generator=gen, device=dev,
                          dtype=torch.int8)
        got, want = hbm.hbm_read(x, reps), hbm.hbm_read_plain(x, reps)
        y = hbm.hbm_copy(x, reps)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"[hbm n={n} reps={reps}] read max|out-plain|={err:.1f} "
              f"copy equal {torch.equal(y, hbm.hbm_copy_plain(x))}")
        if err != 0 or not torch.equal(y, hbm.hbm_copy_plain(x)):
            fail("an hbm probe disagrees with its plain version")

    # ---- one pass at the calibration sizes: kernel, plain, library ----
    rec = {}
    x = hbm._probe_array(512, dev)
    ms = time_ms(lambda a: hbm.hbm_read(a, 1), [(x,)], reps=10)
    pms = time_ms(lambda a: hbm.hbm_read_plain(a, 1), [(x,)], reps=2,
                  warmup=1)
    rec["hbm_read"] = dict(bound(x.numel() + 4 * hbm.BLOCKS * 8, 0),
                           err=0.0, ms=ms, plain_ms=pms, library_ms=None)
    _show("hbm_read 512 MiB, 1 pass", rec["hbm_read"])
    x = x[:x.numel() // 2].contiguous()
    dst = torch.empty_like(x)
    ms = time_ms(lambda a: hbm.hbm_copy(a, 1), [(x,)], reps=10)
    pms = time_ms(hbm.hbm_copy_plain, [(x,)], reps=10)
    rec["hbm_copy"] = dict(bound(2 * x.numel(), 0), err=0.0, ms=ms,
                           plain_ms=pms)
    rec["hbm_copy"]["library_ms"] = library_ms("copy", [(x, dst)])
    _show("hbm_copy 256 MiB, 1 pass", rec["hbm_copy"])
    del x, dst

    # ---- the calibration run (a main path of its own) ----
    hbm.hbm_read.launches = hbm.hbm_copy.launches = 0
    rates = {}
    for passes in (1, 4, 16):
        r = hbm.hbm_read_gb_s(512, reps=passes, runs=7)
        c = hbm.hbm_copy_gb_s(256, reps=passes, runs=7)
        rates[passes] = r, c
        print(f"[hbm] {card_line()}: {passes:2d} passes a launch: "
              f"hbm_read_gb_s median {r.median:.1f} ({r.lo:.1f}-{r.hi:.1f})  "
              f"hbm_copy_gb_s median {c.median:.1f} ({c.lo:.1f}-{c.hi:.1f})")
    launches = {"hbm_read": hbm.hbm_read.launches,
                "hbm_copy": hbm.hbm_copy.launches}
    want = {"hbm_read": 3 * 8, "hbm_copy": 3 * 8}   # 1 first touch + 7 runs
    print(f"[hbm] launches {launches} expected {want}")
    if launches != want:
        fail("the calibration run did not go through the probe kernels")
    read, copy = rates[16]
    for bw in (read, copy):
        if not 0 < bw.lo <= bw.median <= bw.hi < 2 * HBM_BYTES_S / 1e9:
            fail(f"an hbm probe's rate is out of range: {bw}")
    return rec, launches, read.median


# ---------------------------------------------------------------------------
# phase 7: the serving slice at full width
# ---------------------------------------------------------------------------

def serve_prompt(rng, cfg, length=PROMPT_LEN):
    size = cfg.vision.image_size
    return (make_prompt(rng, length, cfg.llama.vocab_size)[None],
            rng.standard_normal((1, 3, size, size)).astype(np.float32))


class Reader(threading.Thread):
    """Drains one request's stream; keeps the tokens, the time of the first
    chunk and the error, if the stream raised one."""

    def __init__(self, batcher, req, t_submit):
        super().__init__(daemon=True)
        self.batcher, self.req, self.t_submit = batcher, req, t_submit
        self.tokens, self.t_first, self.error = [], None, None
        self.start()

    def run(self):
        try:
            for chunk in self.batcher.stream(self.req):
                if self.t_first is None:
                    self.t_first = time.perf_counter()
                self.tokens.extend(chunk.tolist())
        except Exception as e:      # noqa: BLE001: kept for the main thread
            self.error = e

    def result(self, timeout=600.0):
        self.join(timeout)
        if self.is_alive():
            fail("a request's stream did not end")
        if self.error is not None:
            raise self.error
        return self.tokens


def _serve(batcher, prompt, numtoks, new_tokens, **kw) -> Reader:
    t = time.perf_counter()
    req = batcher.submit(*prompt, numtoks=numtoks, max_new_tokens=new_tokens,
                         **kw)
    return Reader(batcher, req, t)


def serve_traffic(batcher, cfg, burst, late, label) -> dict:
    """The counted main-path run of the serving slice: ``burst`` requests
    at once, ``late`` ones joining while those decode; then the checks.
    Returns the launches of every kernel on the serving path."""
    from matryoshka_mm_torch.ops import fused_mlp, int4_matmul
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse
    from matryoshka_mm_torch.ops.paged_attention import paged_decode_attention

    counters = {"paged_attention": paged_decode_attention,
                "flash_attention": flash_attention_lse,
                "decode_attention": flash_decode_attention,
                "int4_matmul": int4_matmul.int4_matmul,
                "quant_mlp": fused_mlp.quant_mlp}

    rng = np.random.default_rng(7)
    n_layers = cfg.llama.num_hidden_layers
    # the warm-up's last round was dispatched before its stream ended: wait
    # until every dispatched round has been processed
    while batcher.decode_steps != batcher.occupancy["rounds"] * batcher.chunk:
        time.sleep(0.005)
    for fn in counters.values():
        fn.launches = 0
    batcher.decode_steps = 0
    batcher.occupancy = {"rounds": 0, "active_rows": 0}
    batcher.admit_stats = {"solo": 0, "grouped": 0}
    batcher.events = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batcher._hold_admission = True          # the burst lands as one batch
    readers = [_serve(batcher, serve_prompt(rng, cfg), n, new)
               for n, new in burst]
    batcher._hold_admission = False
    while batcher.occupancy["rounds"] < 2 and batcher.error is None:
        time.sleep(0.002)                   # the burst is decoding now
    for n, new in late:
        readers.append(_serve(batcher, serve_prompt(rng, cfg), n, new))
        time.sleep(0.05)
    outs = [r.result() for r in readers]
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = batcher.decode_steps
    for (n, new), out in zip(burst + late, outs):
        if len(out) != new or min(out) < 0 \
                or max(out) >= cfg.llama.vocab_size:
            fail(f"{label}: a request at scale {n} gave {len(out)} of {new} "
                 f"tokens in [{min(out)}, {max(out)}]")
    solo = sum(kind == "admit_solo" for _, kind, _ in batcher.events)
    groups = sum(kind == "admit_group" for _, kind, _ in batcher.events)
    quantized = launches["int4_matmul"] > 0
    # every decode step: one paged attention a layer and, with int4 weights,
    # one quant_mlp a layer and qkv, o and lm_head through the GEMV; every
    # prefill: one flash attention a layer and, with int4 weights, qkv, o,
    # gateup, down and lm_head through the matmul kernel.  A group prefill
    # has more than 1024 rows and dequantizes its weights instead, all but
    # the lm_head over its last positions
    want = {"paged_attention": steps * n_layers,
            "flash_attention": (solo + groups) * n_layers,
            "decode_attention": 0,
            "quant_mlp": steps * n_layers if quantized else 0,
            "int4_matmul": (steps * (2 * n_layers + 1)
                            + solo * (4 * n_layers + 1) + groups)
            if quantized else 0}
    print(f"[{label}] launches {launches} over {steps} decode steps, {solo} "
          f"solo and {groups} group prefills; expected {want}")
    if steps <= 0 or launches != want:
        fail(f"{label}: the serving path did not go through the kernels as "
             f"expected")
    print(f"[{label}] admissions {batcher.admit_stats}")
    if batcher.admit_stats["grouped"] < len(burst):
        fail(f"{label}: the burst was not admitted in groups")
    free, total = len(batcher.alloc.free), batcher.alloc.n_allocatable
    print(f"[{label}] pages free {free} of {total}")
    if free != total:
        fail(f"{label}: pages were not returned to the free list")
    ttft = sorted(r.t_first - r.t_submit for r in readers)
    # a round's own ``ms`` spans two rounds under the pipelined loop, so the
    # step time is taken between the ends of consecutive rounds
    ends = [t for t, kind, _ in batcher.events if kind == "decode_round"]
    step_ms = statistics.median(
        b - a for a, b in zip(ends, ends[1:])) * 1e3 / batcher.chunk
    occ = batcher.occupancy
    pool = nbytes(*(t for t in (batcher.paged.k, batcher.paged.v,
                                batcher.paged.k_scale, batcher.paged.v_scale)
                    if t is not None))
    total_toks = sum(len(o) for o in outs)
    print(f"[{label}] {card_line()}: {len(outs)} requests, {total_toks} "
          f"tokens in {wall:.3f} s: {total_toks / wall:.2f} tok/s over the "
          f"batch (prefills included); median {step_ms:.2f} ms a decode step "
          f"between the ends of consecutive rounds; TTFT p50 "
          f"{statistics.median(ttft) * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} "
          f"ms; mean occupancy "
          f"{occ['active_rows'] / (occ['rounds'] * batcher.max_batch):.3f} "
          f"over {occ['rounds']} rounds; pool {pool / 2**30:.2f} GiB; "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _to_f32(tree):
    """The float tensors of a parameter tree in float32; quantized leaves
    (packed integers with their f32 scales) as they are."""
    from matryoshka_mm_torch.ops.quant import is_quantized

    if is_quantized(tree):
        return tree
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def live_attention_check(batcher, lcfg, label) -> None:
    """One layer's attention over the live pool, with seeded queries: the
    paged kernel and the gather path's attention (pages gathered, an int8
    pool dequantized to the model's dtype, ``attention_reference``) against
    the same attention in float32 throughout.  Shows what one layer's two
    paths differ by before 32 layers of random weights amplify it."""
    from matryoshka_mm_torch.ops.attention import attention_reference
    from matryoshka_mm_torch.ops.paged_attention import (
        paged_attention_plain, paged_decode_attention)

    paged, tables = batcher.paged, batcher.tables.long()
    active = batcher.active
    lens = torch.where(active, batcher.lengths,
                       torch.zeros_like(batcher.lengths)).to(torch.int32)
    B, P = tables.shape
    H, Hkv, Dh = (lcfg.num_attention_heads, lcfg.num_key_value_heads,
                  lcfg.head_dim)
    S = P * paged.page_size
    dtype = batcher.params["llama"]["norm"].dtype
    int8 = paged.k_scale is not None
    g = torch.Generator(device=tables.device).manual_seed(11)
    kv_pos = torch.arange(S, device=tables.device)[None]
    for layer in (0, lcfg.num_hidden_layers // 2, lcfg.num_hidden_layers - 1):
        q = torch.randn((B, H, Dh), generator=g, device=tables.device,
                        dtype=torch.float32).to(dtype)
        ks = paged.k_scale[layer] if int8 else None
        vs = paged.v_scale[layer] if int8 else None
        before = paged_decode_attention.launches
        kernel = paged_decode_attention(q, paged.k[layer], paged.v[layer],
                                        batcher.tables, lens, ks, vs)
        if paged_decode_attention.launches != before + 1:
            fail(f"{label}: the live attention check launched no kernel")

        def rows(pool, scale):
            r = pool[tables].reshape(B, S, Hkv, Dh)
            if int8:
                r = (r.float() * scale[tables].reshape(B, S, Hkv, 1)).to(dtype)
            return r.transpose(1, 2)

        gather = attention_reference(
            q[:, :, None], rows(paged.k[layer], ks), rows(paged.v[layer], vs),
            causal=True, q_positions=lens.long()[:, None],
            kv_positions=kv_pos, kv_valid=kv_pos <= lens.long()[:, None]
        )[:, :, 0]
        if int8:
            truth = paged_attention_plain(q.float(), paged.k[layer],
                                          paged.v[layer], tables, lens, ks, vs)
        else:
            truth = paged_attention_plain(q.float(), paged.k[layer].float(),
                                          paged.v[layer].float(), tables, lens)
        torch.cuda.synchronize()
        e_k = (kernel.float() - truth)[active].abs().max().item()
        e_g = (gather.float() - truth)[active].abs().max().item()
        e_kg = (kernel.float() - gather.float())[active].abs().max().item()
        print(f"[{label}] live pool, layer {layer}: attention max|kernel-f32| "
              f"{e_k:.3e} max|gather-f32| {e_g:.3e} max|kernel-gather| "
              f"{e_kg:.3e} of max|f32| {truth[active].abs().max():.3f} "
              f"(tolerance {FLASH_TOL})")
        if not max(e_k, e_kg) <= FLASH_TOL:
            fail(f"{label}: layer {layer}: the paged kernel's attention "
                 f"leaves the float32 attention or the gather path's")


def serve_live_checks(batcher, cfg, label) -> None:
    """Stop the scheduler with 8 rows in mid-decode and, on that live pool:
    one decode step through the paged kernel against the gather path, then
    one decode round under the profiler."""
    from matryoshka_mm_torch.ops.paged_attention import paged_decode_attention
    from matryoshka_mm_torch.serve.paged_cache import (PagedKVCache,
                                                       paged_decode_step,
                                                       paged_pool_decode)

    rng = np.random.default_rng(8)
    readers = [_serve(batcher, serve_prompt(rng, cfg), n, 128)
               for n, _ in SERVE_BURST]
    while min(len(r.tokens) for r in readers) < 24 and batcher.error is None:
        time.sleep(0.005)
    batcher._stop = True
    batcher._thread.join(60)
    if batcher._thread.is_alive() or batcher.error is not None:
        fail(f"{label}: the scheduler did not stop cleanly")
    torch.cuda.synchronize()
    llama, lcfg = batcher.params["llama"], cfg.llama
    active = batcher.active
    rows = int(active.sum())
    lens = batcher.lengths[active].tolist()
    if rows < 6:
        fail(f"{label}: only {rows} rows were live when the scheduler "
             f"stopped")
    args = (batcher.tables, batcher.lengths, batcher.tokens, active,
            batcher.page_size)
    with torch.inference_mode():
        # both branches write the same K/V of the same token into the same
        # slot, so the second starts from the pool the first left
        _, gather = paged_decode_step(llama, lcfg, batcher.paged, *args,
                                      use_kernel=False)
        _, kernel = paged_decode_step(llama, lcfg, batcher.paged, *args,
                                      use_kernel=True)
        # the same step in float32 (weights and float pool cast up, an int8
        # pool as it is): here the two branches compute one function to f32
        # rounding, and are held to the cosine and the argmax
        llama32 = _to_f32(llama)
        gather32 = kernel32 = None
        for use_kernel in (False, True):
            pool32 = PagedKVCache(*(
                None if t is None else
                t.float() if t.is_floating_point() else t.clone()
                for t in (batcher.paged.k, batcher.paged.v,
                          batcher.paged.k_scale, batcher.paged.v_scale)))
            before = paged_decode_attention.launches
            _, out = paged_decode_step(llama32, lcfg, pool32, *args,
                                       use_kernel=use_kernel)
            if (paged_decode_attention.launches - before
                    != use_kernel * lcfg.num_hidden_layers):
                fail(f"{label}: the float32 step's launches are wrong")
            if use_kernel:
                kernel32 = out[active]
            else:
                gather32 = out[active]
            del pool32, out
        del llama32
    torch.cuda.empty_cache()
    gather, kernel = gather[active].float(), kernel[active].float()

    def cosines(a, b):
        return torch.nn.functional.cosine_similarity(a, b, dim=1)

    def fmt(t, nd=6):
        return [round(x, nd) for x in t.tolist()]

    cos32 = cosines(kernel32, gather32)
    same32 = int((kernel32.argmax(-1) == gather32.argmax(-1)).sum())
    print(f"[{label}] live pool, {rows} rows of {lens} tokens, float32 step: "
          f"kernel vs gather logits cosine {fmt(cos32, 8)} "
          f"max|kernel-gather| {(kernel32 - gather32).abs().max():.6f} of "
          f"max|logit| {gather32.abs().max():.4f}, same argmax in {same32} "
          f"rows of {rows}")
    if not (bool(torch.isfinite(kernel32).all())
            and cos32.min() >= PAGED_COS_F32 and same32 == rows):
        fail(f"{label}: in float32 the paged kernel's logits leave the "
             f"gather path's")
    # the model's own dtype: each branch against the float32 step, and
    # against the other
    cos = cosines(kernel, gather)
    cos_kt, cos_gt = cosines(kernel, gather32), cosines(gather, gather32)
    gap = (kernel - gather).abs().amax(dim=1)
    top2 = gather.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = kernel.argmax(-1) == gather.argmax(-1)
    finite = bool(torch.isfinite(kernel).all())
    print(f"[{label}] the model's dtype: kernel vs gather logits cosine "
          f"{fmt(cos)}; against the float32 step: kernel {fmt(cos_kt)} "
          f"gather {fmt(cos_gt)}; max|kernel-gather| a row {fmt(gap, 4)} of "
          f"max|logit| {gather.abs().max():.4f}; the gather path's top two "
          f"logits lie {fmt(margin, 4)} apart; finite {finite}; same argmax "
          f"in {int(agree.sum())} rows of {rows}")
    long_rows = torch.tensor(lens, device=cos.device) >= PAGED_LONG
    if not (finite and cos.min() >= PAGED_COS
            and bool((cos[long_rows] >= PAGED_COS_F32).all())):
        fail(f"{label}: the paged kernel's logits leave the gather path's")
    # as near to the float32 result as the gather path is
    if bool(((1 - cos_kt) > PAGED_EXCESS * (1 - cos_gt) + 1e-4).any()):
        fail(f"{label}: the paged kernel's logits lie farther from the "
             f"float32 step than the gather path's")
    if not bool(agree[margin > gap].all()):
        fail(f"{label}: the argmax differs in a row whose top two logits "
             f"lie farther apart than the two paths' logits")
    live_attention_check(batcher, lcfg, label)

    # ---- one decode round under the profiler ----
    from torch.profiler import ProfilerActivity, profile

    def one_round():
        with torch.inference_mode():
            paged_pool_decode(llama, lcfg, batcher.gen_cfg, batcher.chunk,
                              batcher.paged, batcher.tables, batcher._state(),
                              use_kernel=True, generator=batcher._generator)
        torch.cuda.synchronize()

    one_round()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_round()
    # (the wall time inside the profiler is longer than outside it)
    wall = _wall(one_round) * 1e3
    def dev_us(e):              # the attribute's name depends on the version
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    # kernel events only: the operators that launched them would count the
    # same device time twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(dev_us(e) for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    chunk = batcher.chunk
    print(f"[{label}] {card_line()}: profile of one round ({chunk} steps, "
          f"{rows} live rows of 8): device {dev_ms / chunk:.3f} ms/step, wall "
          f"{wall / chunk:.3f} ms/step, device idle "
          f"{max(0.0, 1 - dev_ms / wall):.3f}, {n_launch // chunk} kernels "
          f"a step")
    if dev_ms <= 0:
        print(f"[{label}] the profiler showed no device time")
    for e in sorted(kernels, key=lambda e: -dev_us(e))[:6]:
        print(f"[{label}]   {dev_us(e) / 1e3 / chunk:8.4f} "
              f"ms/step  x{e.count // chunk:4d}  {e.key[:90]}")
    batcher.shutdown()


def _short_run(model, label, requests, gen=None, **kw):
    """Serve ``requests`` one after another on a small pool; returns their
    tokens and the batcher (shut down)."""
    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    gen = dict(dict(max_new_tokens=16, decode_chunk=8, eos_token_id=-1),
               **(gen or {}))
    b = ContinuousBatcher(model.params, model.cfg,
                          gen_cfg=GenerationConfig(**gen),
                          **dict(SERVE_KW, max_batch=2, **kw))
    try:
        outs = [_serve(b, prompt, n, new, **opts).result()
                for prompt, n, new, opts in requests]
    finally:
        b.shutdown()
    print(f"[{label}] {outs}")
    return outs, b


def serve_options(model, cfg) -> None:
    """One short run each at full width: prefix cache, speculative
    decoding, a regex constraint.  Their greedy tokens are not held against
    a run without the option here: the random 7B weights leave the top two
    logits of a row closer to each other than two such runs' logits are
    (``serve_live_checks`` prints both distances), so roundings of bf16
    size (a suffix prefill against a full one, a 5-token verify block
    against single steps) may pick the other token and every later one
    with it.  ``phase_small`` holds those tokens equal in float32."""
    rng = np.random.default_rng(9)
    # the repeated prompt: 59 + 144 = 203 tokens, so that three full pages
    # are cached: a hit must cover the image span, which ends at token 149
    prompt = serve_prompt(rng, cfg, 60)
    outs, b = _short_run(model, "serve prefix_cache",
                         [(prompt, 144, 16, {})] * 2, prefix_cache=True)
    print(f"[serve prefix_cache] {b.stats}")
    same = sum(a == b for a, b in zip(*outs))
    print(f"[serve prefix_cache] the hit gave {same} of 16 tokens of the miss")
    if b.stats["prefix_hits"] != 1 or b.stats["prefix_pages_reused"] != 3:
        fail("prefix cache: the repeated prompt did not hit its three pages")
    spec, b = _short_run(model, "serve speculative_k=4",
                         [(prompt, 144, 24, {})], speculative_k=4)
    print(f"[serve speculative_k=4] {b.spec_stats}")
    if not 0 < b.spec_stats["verify_steps"] <= 23 \
            or b.spec_stats["tokens_emitted"] != 23:
        fail("speculative decoding: the verify steps do not add up")
    V = cfg.llama.vocab_size
    for out, n in ((outs[0], 16), (outs[1], 16), (spec[0], 24)):
        if len(out) != n or min(out) < 0 or max(out) >= V:
            fail("a short serving run gave a wrong number of tokens, or "
                 "tokens outside the vocabulary")
    pieces = ["A", "B", "C", "D", "yes", "no", " really", "0", "1", "2", "3",
              ".", " ", "x"]
    vocab = ["<pad>", "<s>", "</s>"] + [
        pieces[i % len(pieces)] for i in range(cfg.llama.vocab_size - 3)]
    pattern = r"(yes|no)( really)?"
    outs, _ = _short_run(
        model, "serve constraint_regex",
        [(prompt, 144, 16, {"constraint_regex": pattern})],
        gen=dict(eos_token_id=2, pad_token_id=0), fsm_vocab=vocab)
    text = "".join(vocab[t] for t in outs[0][:-1])
    print(f"[serve constraint_regex] {pattern!r} -> {text!r}")
    if outs[0][-1] != 2 or not re.fullmatch(pattern, text):
        fail("constrained decoding: the output does not match the regex")


def phase_serving(dev) -> dict:
    """Returns the launches of the counted runs, by kernel."""
    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    launches = {}
    for label, options in SERVE_RUNS:
        torch.cuda.empty_cache()
        _, model, _, _ = load_pretrained_model("debug://7b", device=str(dev),
                                               **options)
        cfg = model.cfg
        gen_cfg = GenerationConfig(max_new_tokens=128, decode_chunk=8,
                                   eos_token_id=-1)
        batcher = ContinuousBatcher(model.params, cfg, gen_cfg=gen_cfg,
                                    **SERVE_KW)
        print(f"[{label}] {card_line()}: ContinuousBatcher {SERVE_KW} "
              f"warm-up {batcher.warmup(numtoks=144):.2f} s")
        if not batcher.use_kernel:
            fail(f"{label}: the batcher did not pick the paged kernel")
        counted = serve_traffic(batcher, cfg, SERVE_BURST, SERVE_LATE, label)
        if bool(options) != (counted["int4_matmul"] > 0):
            fail(f"{label}: int4 weights and the int4 kernels' launches do "
                 f"not go together")
        for k, n in counted.items():
            launches[k] = launches.get(k, 0) + n
        serve_live_checks(batcher, cfg, label)
        if not options:
            serve_options(model, cfg)
        del model, batcher
    return launches

# ---------------------------------------------------------------------------
# phase 8: small model, card against CPU
# ---------------------------------------------------------------------------

def phase_small(dev) -> None:
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.generate import GenerationConfig, generate
    from matryoshka_mm_torch.models.convert import init_params

    base = LlavaConfig.tiny_debug()
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, hidden_size=256, num_attention_heads=2,
        num_key_value_heads=2, intermediate_size=512))   # Dh = 128
    params_cpu = init_params(cfg, "cpu", seed=3)
    params_dev = _to(params_cpu, dev)
    rng = np.random.default_rng(1)
    ids = rng.integers(100, 500, (2, 12)).astype(np.int32)
    ids[:, 4] = -200
    ids[1, :3] = 0
    mask = ids != 0
    px = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    gen_cfg = GenerationConfig(max_new_tokens=10, decode_chunk=4,
                               eos_token_id=-1)
    got = generate(params_dev, cfg, ids, px, attention_mask=mask,
                   matryoshka_vis_token_scale="ver=v0_numtoks=4",
                   gen_cfg=gen_cfg)
    want = generate(params_cpu, cfg, ids, px, attention_mask=mask,
                    matryoshka_vis_token_scale="ver=v0_numtoks=4",
                    gen_cfg=gen_cfg)
    print(f"[small] card {got.tolist()}\n[small] cpu  {want.tolist()}")
    if not np.array_equal(got, want):
        fail("small model: card tokens differ from CPU tokens")

    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.paged_attention import paged_decode_attention

    served = {}
    for backend, counter in (("paged", paged_decode_attention),
                             ("dense", flash_decode_attention)):
        for name, params in (("card", params_dev), ("cpu", params_cpu)):
            kw = dict(page_size=16) if backend == "paged" else {}
            b = ContinuousBatcher(params, cfg, max_batch=2, prefill_len=64,
                                  max_new_tokens=16, gen_cfg=gen_cfg, chunk=4,
                                  backend=backend, **kw)
            before = counter.launches
            try:
                b._hold_admission = True
                reqs = [b.submit(ids[i:i + 1, 3 * i:], px[i:i + 1], numtoks=4,
                                 max_new_tokens=10) for i in range(2)]
                b._hold_admission = False
                served[backend, name] = [
                    np.concatenate(list(b.stream(r))).tolist() for r in reqs]
                if backend == "paged" and b.use_kernel != (name == "card"):
                    fail(f"small model: batcher on the {name} has use_kernel="
                         f"{b.use_kernel}")
            finally:
                b.shutdown()
            print(f"[small] {backend} batcher {name:4s} "
                  f"{served[backend, name]}")
            if (counter.launches > before) != (name == "card"):
                fail(f"small model: the {backend} batcher on the {name} "
                     f"launched its decode kernel "
                     f"{counter.launches - before} times")
    if any(out != got.tolist() for out in served.values()):
        fail("small model: a batcher's tokens on the card differ from the "
             "CPU's or from generate's")

    # float32 leaves no ties: a prefix-cache hit gives the tokens of its miss
    # and speculative decoding the plain greedy tokens, on both devices
    long_ids = rng.integers(100, 500, (1, 60)).astype(np.int32)
    long_ids[0, 4] = -200
    runs = {}
    for name, params in (("card", params_dev), ("cpu", params_cpu)):
        for option in ({}, {"prefix_cache": True}, {"speculative_k": 4}):
            b = ContinuousBatcher(params, cfg, max_batch=2, prefill_len=128,
                                  max_new_tokens=16, gen_cfg=gen_cfg, chunk=4,
                                  backend="paged", page_size=16, **option)
            try:
                outs = [np.concatenate(list(b.stream(b.submit(
                    long_ids, px[:1], numtoks=4, max_new_tokens=12)))).tolist()
                    for _ in range(2)]
                if option.get("prefix_cache") and b.stats["prefix_hits"] != 1:
                    fail("small model: the repeated prompt did not hit")
                if option.get("speculative_k") \
                        and b.spec_stats["verify_steps"] <= 0:
                    fail("small model: no speculative verify step ran")
            finally:
                b.shutdown()
            runs[name, tuple(option)] = outs
            print(f"[small] batcher {name:4s} {option} {outs[0]}")
    first = runs["card", ()][0]
    if any(o != first for outs in runs.values() for o in outs):
        fail("small model: prefix cache or speculative decoding changed the "
             "greedy tokens")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def main() -> int:
    if not (REPO / "matryoshka_mm_torch" / "csrc").is_dir():
        print("chip_smoke: the matryoshka_mm_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda", 0)
    card = phase_device()
    phase_build()
    rec = phase_kernels(dev)
    rec.update(phase_quant_kernels(dev))
    launches = phase_slice(dev)["launches"]
    quant_launches = phase_quant_slice(dev)
    for k, n in quant_launches.items():
        launches[k] = launches.get(k, 0) + n
    rec.update(phase_paged_kernels(dev))
    hbm_rec, hbm_launches, read_gb_s = phase_hbm(dev)
    rec.update(hbm_rec)
    launches.update(hbm_launches)
    for k, n in phase_serving(dev).items():
        launches[k] = launches.get(k, 0) + n
    phase_small(dev)
    if [m for m in sys.modules
            if m.split(".")[0] in ("jax", "matryoshka_mm_tpu")]:
        fail("jax or the JAX package was imported")
    sources = {
        "flash_attention": ("flash_attention.cu",
                            "matryoshka_mm_tpu/ops/flash_attention.py:59"),
        "decode_attention": ("decode_attention.cu",
                             "matryoshka_mm_tpu/ops/decode_attention.py:53"),
        "int4_matmul": ("quant_matmul.cu",
                        "matryoshka_mm_tpu/ops/int4_matmul.py:198"),
        "int8_matmul": ("quant_matmul.cu",
                        "matryoshka_mm_tpu/ops/int4_matmul.py:316"),
        "quant_mlp": ("fused_mlp.cu", "matryoshka_mm_tpu/ops/fused_mlp.py:96"),
        "paged_attention": ("paged_attention.cu",
                            "matryoshka_mm_tpu/ops/paged_attention.py:71"),
        "hbm_read": ("hbm_probe.cu", "matryoshka_mm_tpu/ops/hbm_probe.py:36"),
        "hbm_copy": ("hbm_probe.cu", "matryoshka_mm_tpu/ops/hbm_probe.py:56"),
    }
    kernels = [{"name": name, "route": "cuda",
                "source": f"matryoshka_mm_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": rec[name]["err"], "ms": rec[name]["ms"],
                "plain_ms": rec[name]["plain_ms"],
                "bound_ms": rec[name]["bound_ms"],
                "bound_by": rec[name]["bound_by"],
                "library_ms": rec[name]["library_ms"]}
               for name, (src, replaces) in sources.items()]
    ratio = HBM_BYTES_S / 1e9 / read_gb_s
    print(f"[bounds] {card}: bytes over the measured hbm_read rate "
          f"({read_gb_s:.1f} GB/s) instead of {HBM_BYTES_S / 1e9:.0f} GB/s: "
          + ", ".join(f"{k['name']} {k['bound_ms'] * ratio:.4f} ms"
                      for k in kernels if k["bound_by"] == "bytes"))
    if any(k["launches"] <= 0 for k in kernels):
        fail("a kernel of the main path was never launched")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
