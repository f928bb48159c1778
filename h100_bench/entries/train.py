"""The training entry: the step of ``make_train_step(cfg, tx,
frozen_vision=True)`` over a LoRA-wrapped model, called back to back.

Set-up makes the base weights (bfloat16, frozen), the projector's float32
master copy and one LoRA pair a targeted projection from the seed, builds
the train state once and drives it through ``setup_steps`` steps of the
window's own call on batches of their own; those steps are what the
reference follows.  The same state then runs the window: steps on fresh
batches until ``--seconds`` have passed, each ending in a synchronize.

``correct`` holds the program to the float32 reference (``reference/
train.py``) over the first ``ref_steps`` steps: each step's loss, each
leaf's first gradient as the optimizer got it (its first moment after one
step over ``1 - b1``), and each leaf's change after ``ref_steps`` steps,
every leaf by its norm against the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from .. import traffic
from ..reference import train as rtrain
from ..trace import Spans, Tracer
from ..weights import make_weights

TARGETS = rtrain.LORA_TARGETS
# steps a traced run profiles, after the window
TRACE_STEPS = 1


def make_lora(spec, seed: int, device, r: int) -> List[Dict[str, tuple]]:
    """One ``(A (r, in), B (out, r))`` float32 pair a targeted projection
    of every layer: A uniform in +-sqrt(6 / in) (peft's and the program's
    he-uniform), B normal(0, 1e-3) as an adapter part-way through its
    training (so every leaf has a gradient at the first step).  Two fill
    calls on the device."""
    d = spec.decoder
    D, I, H, Hkv, Dh = d.hidden, d.intermediate, d.heads, d.kv_heads, \
        d.head_dim
    shapes = {"q_proj": (H * Dh, D), "k_proj": (Hkv * Dh, D),
              "v_proj": (Hkv * Dh, D), "o_proj": (D, H * Dh),
              "gate_proj": (I, D), "up_proj": (I, D), "down_proj": (D, I)}
    na = sum(r * shapes[n][1] for n in TARGETS) * d.layers
    nb = sum(shapes[n][0] * r for n in TARGETS) * d.layers
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    a_buf = torch.empty((na,), device=device).uniform_(-1.0, 1.0,
                                                       generator=gen)
    b_buf = torch.empty((nb,), device=device).normal_(0.0, 1e-3,
                                                      generator=gen)
    out, ia, ib = [], 0, 0
    for _ in range(d.layers):
        layer = {}
        for n in TARGETS:
            o, i = shapes[n]
            a = a_buf[ia:ia + r * i].view(r, i).mul_((6.0 / i) ** 0.5)
            b = b_buf[ib:ib + o * r].view(o, r)
            ia, ib = ia + r * i, ib + o * r
            layer[n] = (a, b)
        out.append(layer)
    return out


def wrapped_tree(weights: dict, lora, scale: float, device) -> dict:
    """The program's tree: every targeted leaf a LoRA wrapper over the
    base, sharing the benchmark's tensors."""
    s = torch.full((1, 1), scale, dtype=torch.float32, device=device)
    llama = dict(weights["llama"])
    layers = []
    for lp, ad in zip(weights["llama"]["layers"], lora):
        lp = {**lp, "self_attn": dict(lp["self_attn"]), "mlp": dict(lp["mlp"])}
        for n in TARGETS:
            g = rtrain._group(n)
            a, b = ad[n]
            lp[g][n] = {"w": lp[g][n], "lora_a": a, "lora_b": b,
                        "lora_scale": s}
        layers.append(lp)
    llama["layers"] = layers
    return {**weights, "llama": llama}


def lora_paths(layers: int) -> Dict[str, tuple]:
    """The program's leaf path of every LoRA tensor -> ``(layer, target,
    0 for A / 1 for B)``."""
    out = {}
    for l in range(layers):
        for n in TARGETS:
            g = rtrain._group(n)
            out[f"llama/layers/{l}/{g}/{n}/lora_a"] = (l, n, 0)
            out[f"llama/layers/{l}/{g}/{n}/lora_b"] = (l, n, 1)
    return out


def make_batch(mix: dict, spec, seed: int, step: int, device) -> tuple:
    """Step ``step``'s rows: BOS, the sentinel, then random text; labels on
    the answer share at the end of each row; one image a row."""
    B, T = int(mix["batch"]), int(mix["text_tokens"])
    r = traffic.rng(seed, 6, step)
    ids = r.integers(3, spec.decoder.vocab, size=(B, T))
    ids[:, 0], ids[:, 1] = 1, traffic.IMAGE_TOKEN
    labels = np.full((B, T), rtrain.IGNORE, np.int64)
    start = T - int(T * float(mix["answer_share"]))
    labels[:, start:] = ids[:, start:]
    px = np.clip(r.standard_normal((B, 3, spec.vision.image,
                                    spec.vision.image), dtype=np.float32),
                 -3, 3)
    return (torch.as_tensor(ids, device=device),
            torch.as_tensor(px, device=device),
            torch.as_tensor(labels, device=device))


def tokens_per_step(mix: dict, spec) -> int:
    B, T = int(mix["batch"]), int(mix["text_tokens"])
    return B * sum(T - 1 + s for s in spec.scales)


@dataclasses.dataclass
class ProgramReadings:
    losses: List[float]
    grad_norms: Dict[str, float]      # first step, as the optimizer got it
    delta_norms: Dict[str, float]     # after ref_steps


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TrainCell:
    """One training cell: :meth:`setup` (the program's first steps), then
    :meth:`window`, :meth:`free_program` and :meth:`reference`; the
    control runs the set-up and the reference more than once."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.w, self.mix, self.spec = ctx.workload, ctx.traffic, ctx.spec
        self.dev = ctx.device
        self.r = int(self.w["lora"]["r"])
        self.scale = float(self.w["lora"]["alpha"]) / self.r
        self.n_ref = int(self.w["ref_steps"])

    def batch(self, i: int, rows: slice = slice(None)):
        from matryoshka_mm_torch.train.train_step import M3Batch

        ids, px, labels = make_batch(self.mix, self.spec, self.seed, i,
                                     self.dev)
        ids, px, labels = ids[rows], px[rows], labels[rows]
        return M3Batch(ids, px, labels, torch.ones_like(ids, dtype=torch.bool))

    def setup(self, seed: int, rows: slice = slice(None)) -> ProgramReadings:
        """Weights, adapters and the train state from ``seed``, driven
        through the set-up steps on ``rows`` of each batch (all of them
        but in the control's fault)."""
        from matryoshka_mm_torch.train.optimizer import OptimizerConfig, \
            named_leaves
        from matryoshka_mm_torch.train.trainer import create_train_state, \
            make_train_step

        from ..port_config import llava_config

        self.seed, spec, dev = seed, self.spec, self.dev
        weights = make_weights(spec, seed, dev)
        # the trainable projector's float32 master copy
        weights["mm_projector"] = {"layers": [
            {k: v.float() for k, v in layer.items()}
            for layer in weights["mm_projector"]["layers"]]}
        # the step updates the projector in place: the reference starts
        # from this copy (the LoRA pairs are drawn again from the seed)
        self.proj0 = {"layers": [
            {k: v.clone() for k, v in layer.items()}
            for layer in weights["mm_projector"]["layers"]]}
        self.weights = weights
        params = wrapped_tree(weights, make_lora(spec, seed, dev, self.r),
                              self.scale, dev)
        cfg = llava_config(spec, self.ctx.config)
        cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
            cfg.llama, remat=bool(self.w["remat"])))
        ocfg = OptimizerConfig(lora_enable=True, **self.w["optimizer"])
        self.state, tx = create_train_state(params, ocfg)
        self.step = make_train_step(cfg, tx, frozen_vision=True)
        leaves = dict(named_leaves(params))
        self.trainable = list(tx.trainable)
        start = {p: leaves[p].detach().clone() for p in self.trainable}
        n_setup = int(self.w["setup_steps"])
        losses, grads, delta = [], {}, {}
        for i in range(n_setup):
            self.state, metrics = self.step(self.state, self.batch(i, rows))
            losses.append(float(metrics["loss"]))
            if i == 0:
                mu = self.state.opt_state["mu"]
                grads = {p: float(torch.linalg.vector_norm(mu[p].float()))
                         / (1 - ocfg.adam_b1) for p in self.trainable}
            if i + 1 == self.n_ref:
                delta = {p: float(torch.linalg.vector_norm(
                    leaves[p].detach().float() - start[p].float()))
                    for p in self.trainable}
        self.next_batch = n_setup
        _sync(dev)
        return ProgramReadings(losses[:self.n_ref], grads, delta)

    def window(self, seconds: float, trace: bool) -> dict:
        """Steps on fresh batches until ``seconds`` have passed; a traced
        run then profiles ``TRACE_STEPS`` more (after the timed ones, so the
        profiler's cost reaches none of them)."""
        dev = self.dev
        step_s, traced, spans = [], [], Spans()

        def one(on: bool) -> None:
            t, t_ns = time.perf_counter(), time.time_ns()
            self.state, _ = self.step(self.state, self.batch(self.next_batch))
            _sync(dev)
            step_s.append(time.perf_counter() - t)
            spans.spans.append(("train step: host", 0, t_ns, time.time_ns()))
            traced.append(on)
            self.next_batch += 1

        t0 = time.perf_counter()
        while not step_s or time.perf_counter() - t0 < seconds:
            one(False)
        elapsed, done = time.perf_counter() - t0, len(step_s)
        tracer = None
        if trace:
            tracer = Tracer(dev)
            tracer.start()
            for _ in range(TRACE_STEPS):
                one(True)
            tracer.stop()
        return {"t0": t0, "steps": done, "elapsed": elapsed,
                "step_s": step_s, "traced": traced, "n_traced": sum(traced),
                "work": step_work(self.spec, self.mix, self.r),
                "tracer": tracer, "spans": spans}

    def free_program(self) -> None:
        """Drop the train state; the weights stay, the projector as it
        started."""
        del self.state, self.step
        self.weights["mm_projector"] = self.proj0
        _sync(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, lin=None) -> dict:
        return reference_readings(
            self.ctx, self.weights, make_lora(self.spec, self.seed, self.dev,
                                              self.r),
            self.scale, self.seed, self.n_ref, lin)


def run(ctx, seed: int, seconds: float, trace: bool, t_process: float) -> dict:
    """One run of a training cell: the harness's entry point."""
    cell = TrainCell(ctx)
    prog = cell.setup(seed)
    setup_s = time.perf_counter() - t_process
    win = cell.window(seconds, trace)
    peak = ctx.memory_peak()
    cell.free_program()
    t_ref = time.perf_counter()
    want = cell.reference()
    readings = compare(prog, want)
    # the cell's file names the numbers compared (a number with no upper
    # reading is printed, not compared)
    limits = ctx.workload["check"]
    checks = {k: readings[k] for k in limits}
    e2e = {"train_tok_s": win["steps"] * tokens_per_step(ctx.traffic,
                                                          ctx.spec)
           / win["elapsed"], "setup_s": setup_s}
    return {
        "attempted": win["steps"], "failed": 0, "e2e": e2e,
        "memory_peak_bytes": peak, "tracer": win["tracer"],
        "spans": win["spans"], "window": win,
        "extra": {"step_s": win["elapsed"] / win["steps"],
                  "reference_s": time.perf_counter() - t_ref,
                  "losses": prog.losses, "reference_losses": want["losses"],
                  "readings": readings},
        "checks": {k: [checks[k], limits[k]] for k in checks},
    }


def reference_readings(ctx, weights, lora0, scale: float, seed: int,
                       n_ref: int, lin=None) -> dict:
    """The reference's losses, first clipped gradients and changes over
    ``n_ref`` steps from the set-up's starting point (``weights`` with the
    projector as it started, ``lora0`` as drawn)."""
    from ..reference import model as ref

    w, mix, spec, dev = ctx.workload, ctx.traffic, ctx.spec, ctx.device
    o = w["optimizer"]
    lora = [{n: tuple(t.requires_grad_(True) for t in ad[n])
             for n in TARGETS} for ad in lora0]
    proj = {"layers": [{k: v.detach().clone().requires_grad_(True)
                        for k, v in layer.items()}
                       for layer in weights["mm_projector"]["layers"]]}
    names: Dict[str, torch.Tensor] = {}
    for path, (l, n, j) in lora_paths(spec.decoder.layers).items():
        names[path] = lora[l][n][j]
    for i, layer in enumerate(proj["layers"]):
        for k, v in layer.items():
            names[f"mm_projector/layers/{i}/{k}"] = v
    start = {p: t.detach().clone() for p, t in names.items()}
    lora_names = [p for p in names if p.startswith("llama/")]
    groups = {"backbone": lora_names,
              "mm_projector": [p for p in names if p.startswith("mm_")]}
    lrs = {"backbone": o["learning_rate"],
           "mm_projector": o.get("mm_projector_lr") or o["learning_rate"]}
    opt = rtrain.AdamW(groups, lrs, o["total_steps"],
                       max_grad_norm=o.get("max_grad_norm", 1.0),
                       weight_decay=o.get("weight_decay", 0.0))
    losses, grads = [], {}
    with ref.exact_float32():
        for i in range(n_ref):
            ids, px, labels = make_batch(mix, spec, seed, i, dev)
            loss = rtrain.m3_loss(weights, spec, lora, scale, proj, ids, px,
                                  labels, lin or ref.linear)
            g = torch.autograd.grad(loss, [names[p] for p in names])
            g = dict(zip(names, g))
            losses.append(float(loss.detach()))
            if i == 0:
                grads = rtrain.norms(opt.clipped(g))
            opt.update({p: t.data for p, t in names.items()}, g)
            del g, loss
    delta = {p: float(torch.linalg.vector_norm(names[p].detach() - start[p]))
             for p in names}
    return {"losses": losses, "grads": grads, "delta": delta}


def compare(prog: ProgramReadings, want: dict) -> dict:
    """Each number compared: the worst step's loss gap relative to the
    reference's, and the worst leaf's gap of the first gradient's and of
    the change's norm.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out of both."""
    med = float(np.median(list(want["grads"].values())))
    skip = [p for p, v in want["grads"].items() if v < 1e-3 * med]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog.losses,
                                                   want["losses"]))
    g, _ = rtrain.worst_leaf_gap(prog.grad_norms, want["grads"], skip)
    dl, _ = rtrain.worst_leaf_gap(prog.delta_norms, want["delta"], skip)
    return {"loss_rel_gap": loss, "grad_leaf_gap": g, "delta_leaf_gap": dl}


def step_work(spec, mix: dict, r: int) -> dict:
    """The step's sequences as the readers count them."""
    B, T = int(mix["batch"]), int(mix["text_tokens"])
    rows = [T - 1 + s for s in spec.scales for _ in range(B)]
    labelled = len(spec.scales) * B * int(T * float(mix["answer_share"]))
    d = spec.decoder
    per_layer = r * sum(i + o for o, i in (
        (d.heads * d.head_dim, d.hidden), (d.kv_heads * d.head_dim, d.hidden),
        (d.kv_heads * d.head_dim, d.hidden), (d.hidden, d.heads * d.head_dim),
        (d.intermediate, d.hidden), (d.intermediate, d.hidden),
        (d.hidden, d.intermediate)))
    return {"rows": rows, "labelled": labelled, "images": B,
            "lora_per_layer": per_layer}
