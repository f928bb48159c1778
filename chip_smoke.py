#!/usr/bin/env python3
"""Drive the PyTorch port (matryoshka_mm_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero, and no phase's exception is caught:

1. device: require CUDA; print the card (nvidia-smi name and power limit),
   torch.version.cuda, nvcc and Triton versions; turn TF32 off;
2. build: compile csrc/*.cu with nvcc for sm_90a, print ptxas usage and the
   build time;
3. kernels against their plain PyTorch versions at the main path's shapes
   in bf16 (prefill flash attention B=1 H=32 Dh=128 Sq=640 against a
   672-slot cache, GQA and window cases; decode attention B in {1, 4},
   S=672, GQA, window and a ragged S): max errors, and the median time of
   kernel and plain version over CUDA events;
4. the slice at full width: load_pretrained_model("debug://7b") in bf16
   (random weights from a seed), five one-image requests with 32 greedy
   tokens at ver=v0_numtoks in {1, 9, 36, 144, 576} and a left-padded B=4
   batch at 144; the launch counters must show 32 flash launches per
   prefill and 32 decode launches per decode step; one prefill's
   last-position logits are held against attn_impl="reference" (cosine
   >= 0.99); TTFT per scale, decode tok/s at B=1 and B=4, peak memory;
5. a small model (Dh=128, float32) on the card against the same weights on
   the CPU (plain versions): same greedy tokens, close logits.

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
SCALES = (1, 9, 36, 144, 576)
BATCH_SCALE = 144     # the scale of the left-padded B=4 batch
NEW_TOKENS = 32
PROMPT_LEN = 40


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the device (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
            rec["flash_attention"]["ms"] = time_ms(
                lambda: fl.flash_attention_lse(q, k, v, **kw))
            rec["flash_attention"]["plain_ms"] = time_ms(
                lambda: fl.flash_attention_plain(q, k, v, **kw))
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
            ms = time_ms(lambda: dec.flash_decode_attention(*args))
            plain = time_ms(lambda: dec.decode_attention_plain(*args))
            rec["decode_attention"][f"ms_{name}"] = ms
            rec["decode_attention"][f"plain_ms_{name}"] = plain
            print(f"[decode {name}] kernel {ms:.4f} ms  plain {plain:.4f} ms")
    rec["decode_attention"]["ms"] = rec["decode_attention"]["ms_b1"]
    rec["decode_attention"]["plain_ms"] = \
        rec["decode_attention"]["plain_ms_b1"]
    return rec


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------

def make_prompt(rng, length, vocab):
    ids = rng.integers(100, vocab, (length,)).astype(np.int32)
    ids[0] = 1                                        # BOS
    ids[5] = -200                                     # the image sentinel
    return ids


def phase_slice(dev) -> dict:
    from matryoshka_mm_torch.generate import _round_up, prefill_image
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
    n_layers, vocab = cfg.llama.num_hidden_layers, cfg.llama.vocab_size
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    px1 = rng.standard_normal((1, 3, size, size)).astype(np.float32)
    ids1 = make_prompt(rng, PROMPT_LEN, vocab)[None]
    lens4 = (PROMPT_LEN, 33, 28, 37)
    ids4 = np.zeros((4, PROMPT_LEN), np.int32)
    mask4 = np.zeros((4, PROMPT_LEN), bool)
    for b, n in enumerate(lens4):
        ids4[b, PROMPT_LEN - n:] = make_prompt(rng, n, vocab)
        mask4[b, PROMPT_LEN - n:] = True
    px4 = rng.standard_normal((4, 3, size, size)).astype(np.float32)

    def run(ids, px, numtoks, new_tokens, mask=None):
        out = model.generate(ids, images=px, attention_mask=mask,
                             matryoshka_vis_token_scale=f"ver=v0_numtoks="
                                                        f"{numtoks}",
                             max_new_tokens=new_tokens, eos_token_id=-1)
        torch.cuda.synchronize()
        return out

    # ---- the counted main-path run ----
    requests = [(ids1, px1, n, None) for n in SCALES] + \
        [(ids4, px4, BATCH_SCALE, mask4)]
    flash_attention_lse.launches = 0
    flash_decode_attention.launches = 0
    outs = [run(ids, px, n, NEW_TOKENS, m) for ids, px, n, m in requests]
    launches = {"flash_attention": flash_attention_lse.launches,
                "decode_attention": flash_decode_attention.launches}
    for (ids, _, n, _), out in zip(requests, outs):
        if out.shape != (ids.shape[0], NEW_TOKENS) or out.min() < 0 \
                or out.max() >= vocab:
            fail(f"numtoks={n}: output {out.shape} ids "
                 f"[{out.min()}, {out.max()}]")
    want = {"flash_attention": len(requests) * n_layers,
            "decode_attention": len(requests) * (NEW_TOKENS - 1) * n_layers}
    print(f"[slice] launches {launches} expected {want}")
    if launches != want:
        fail("the main path did not go through the kernels as expected")
    print(f"[slice] B=1 tokens at {BATCH_SCALE}: "
          f"{outs[SCALES.index(BATCH_SCALE)][0, :12].tolist()}")

    # ---- kernel path against attn_impl="reference" on one prefill ----
    numtoks = BATCH_SCALE
    L = _round_up(PROMPT_LEN - 1 + numtoks, 64)
    ids_t = torch.as_tensor(ids1, dtype=torch.int64, device=dev)
    px_t = torch.as_tensor(px1, device=dev)
    logits = {}
    for impl in ("auto", "reference"):
        logits[impl] = prefill_image(model.params, cfg.with_attn_impl(impl),
                                     ids_t, px_t, None, numtoks, L,
                                     L + NEW_TOKENS)[0][0].float()
    cos = torch.nn.functional.cosine_similarity(
        logits["auto"], logits["reference"], dim=0).item()
    finite = bool(torch.isfinite(logits["auto"]).all()
                  and torch.isfinite(logits["reference"]).all())
    same_top = int(logits["auto"].argmax()) == int(logits["reference"]
                                                   .argmax())
    print(f"[slice] prefill logits kernel vs reference: cosine {cos:.6f} "
          f"finite {finite} same argmax {same_top}")
    if not (finite and cos >= 0.99):
        fail("kernel-path logits disagree with the reference path")

    # ---- timings (after the counted run, which warmed everything up) ----
    ttft, decode = {}, {}
    for n in SCALES:
        ttft[n] = statistics.median(
            _wall(lambda: run(ids1, px1, n, 1)) for _ in range(3))
        full = statistics.median(
            _wall(lambda: run(ids1, px1, n, NEW_TOKENS)) for _ in range(2))
        decode[n] = (NEW_TOKENS - 1) / (full - ttft[n])
        print(f"[slice] numtoks={n:4d} TTFT {ttft[n] * 1e3:.2f} ms  "
              f"decode B=1 {decode[n]:.2f} tok/s  (prefill slots "
              f"{_round_up(PROMPT_LEN - 1 + n, 64)})")
    t1 = statistics.median(_wall(lambda: run(ids4, px4, BATCH_SCALE, 1, mask4))
                           for _ in range(3))
    t32 = statistics.median(
        _wall(lambda: run(ids4, px4, BATCH_SCALE, NEW_TOKENS, mask4))
        for _ in range(2))
    b4 = 4 * (NEW_TOKENS - 1) / (t32 - t1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[slice] B=4 numtoks={BATCH_SCALE} TTFT {t1 * 1e3:.2f} ms  decode "
          f"{b4:.2f} tok/s")
    print(f"[slice] max_memory_allocated {peak:.2f} GiB")
    return {"launches": launches}


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
    launches = phase_slice(dev)["launches"]
    phase_small(dev)
    if "jax" in sys.modules:
        fail("jax was imported")
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "matryoshka_mm_torch/csrc/flash_attention.cu",
         "replaces": "matryoshka_mm_tpu/ops/flash_attention.py:59",
         "launches": launches["flash_attention"],
         "max_abs_err": rec["flash_attention"]["err"],
         "ms": rec["flash_attention"]["ms"],
         "plain_ms": rec["flash_attention"]["plain_ms"]},
        {"name": "decode_attention", "route": "cuda",
         "source": "matryoshka_mm_torch/csrc/decode_attention.cu",
         "replaces": "matryoshka_mm_tpu/ops/decode_attention.py:53",
         "launches": launches["decode_attention"],
         "max_abs_err": rec["decode_attention"]["err"],
         "ms": rec["decode_attention"]["ms"],
         "plain_ms": rec["decode_attention"]["plain_ms"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
