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
6. a small model (Dh=128, float32) on the card against the same weights on
   the CPU (plain versions): same greedy tokens.

The line before the last is the kernels' JSON record, the last line the
device JSON.  Needs no network and no package beyond torch and numpy.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


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
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
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
            print(f"[flash mha] kernel {rec['flash_attention']['ms']:.4f} ms"
                  f"  plain {rec['flash_attention']['plain_ms']:.4f} ms")

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
    return rec


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
                    line += (f"  kernel {ms:.4f} ms  plain {pms:.4f} ms  "
                             f"weights {w.numel() / ms / 1e6:.1f} GB/s")
                print(line)
        r["ms"], r["plain_ms"] = r["ms_qkv_1"], r["plain_ms_qkv_1"]

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
                line += f"  kernel {ms:.4f} ms  plain {pms:.4f} ms"
            print(line)
    r["ms"], r["plain_ms"] = r["ms_int4"], r["plain_ms_int4"]
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
# phase 5: small model, card against CPU
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
    phase_small(dev)
    if "jax" in sys.modules:
        fail("jax was imported")
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
    }
    kernels = [{"name": name, "route": "cuda",
                "source": f"matryoshka_mm_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": rec[name]["err"], "ms": rec[name]["ms"],
                "plain_ms": rec[name]["plain_ms"]}
               for name, (src, replaces) in sources.items()]
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
