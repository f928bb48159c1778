"""The readings a cell's limits are set from: the program's over many
seeds, the control's and the faults'.

    python3 -m h100_bench.control --workload <cell> --seeds 1,2,3 \
        [--seconds 20] [--control 1] [--fault 1]

For each seed, in one process, one JSON line: each reading, and whether
it passes the cell's limits by the check a run makes (``run.verdict``):
``program_correct``, ``control_correct`` and ``fault_correct``.  The
control is the reference with every product in float8 e4m3 (one scale a
row; the configuration states bfloat16) put in the program's place.  The
benchmark's own runs never run it.

* A serving cell (an eval sweep alike): its set-up, a window of
  ``--seconds`` at the cell's own rate, and the comparison a run makes
  (the program's served tokens against the float32 reference on the
  seed's sample).  The control reads,
  at each position of the same prompts and tokens, the float32 gap of the
  token it puts first.
* A training cell: the set-up's steps and the comparison a run makes (no
  window: the readings come from the set-up).  The control follows the
  same steps; ``--fault 1`` also runs the program with half of each batch
  left out (the mean taken over the rest) against the full batch's
  reference (``fault``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List

import torch


def control_picks(cell, sample) -> List[List[int]]:
    """At each position of the sample's prompts and served tokens, the
    token the float8 reference puts first."""
    from .reference import model as ref

    ctrl = cell.reference_logits(sample, lin=ref.fp8_linear)
    return [c.argmax(dim=-1).tolist() for c in ctrl]


def as_control(cell, sample) -> list:
    """The sample with the control in the program's place: each item's
    served tokens are the control's picks."""
    return [dataclasses.replace(r, tokens=p)
            for r, p in zip(sample, control_picks(cell, sample))]


def control_gap(cell, sample, ref_logits) -> float:
    from .reference import model as ref

    gaps = [ref.gap_of(r, p)
            for r, p in zip(ref_logits, control_picks(cell, sample))]
    return float(torch.cat(gaps).max())


def readings(ctx, seed: int, seconds: float, with_control: bool) -> dict:
    """One seed's program reading of a serving or eval cell and,
    optionally, the control's."""
    from .reference import model as ref
    from .run import verdict

    if ctx.workload["entry"] == "eval":
        from .entries.eval import EvalCell

        cell = EvalCell(ctx)
        cell.setup(seed)
        win = cell.window(seconds, False)
        cell.free_program()
        sample = cell.sample(win["answered"],
                             int(ctx.workload["check"]["sample_calls"]))
        failed = sum(1 for a in win["answered"] for r in a
                     if len(r.tokens) != int(ctx.workload["max_new_tokens"]))
        out = {"seed": seed, "calls": len(win["calls"]), "failed": failed}
    else:
        from .entries.serve import ServeCell, timings

        cell = ServeCell(ctx)
        cell.setup(seed)
        win = cell.window(float(ctx.workload["rate_per_s"]), seconds)
        t = timings(win)
        cell.free_program()
        sample = cell.sample(win["counted"],
                             int(ctx.workload["check"]["sample"]))
        out = {"seed": seed, "failed": t["failed"],
               "attempted": t["attempted"]}
    logits = cell.reference_logits(sample)
    out["program_gap"] = float(torch.cat(
        [ref.gap_of(lg, r.tokens) for lg, r in zip(logits, sample)]).max())
    out["tokens"] = sum(len(r.tokens) for r in sample)
    limit = float(ctx.workload["check"]["max_logit_gap"])
    out["program_correct"] = verdict({
        "max_logit_gap": [out["program_gap"], limit],
        "failed": [out["failed"], 0]})
    if with_control:
        out["control_gap"] = control_gap(cell, sample, logits)
        out["control_correct"] = verdict(
            {"max_logit_gap": [out["control_gap"], limit]})
    del cell, logits
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def train_readings(ctx, seed: int, with_control: bool,
                   with_fault: bool) -> dict:
    """One seed's readings of a training cell."""
    from .entries.train import TrainCell, compare
    from .run import verdict

    cell = TrainCell(ctx)
    prog = cell.setup(seed)
    cell.free_program()
    fault = None
    if with_fault:
        half = TrainCell(ctx)
        fault = half.setup(seed, rows=slice(0, int(ctx.traffic["batch"]) // 2))
        half.free_program()
        del half
        torch.cuda.empty_cache()
    want = cell.reference()
    limits = ctx.workload["check"]

    def judged(key: str, readings: dict) -> None:
        out[key] = readings
        out[f"{key}_correct"] = verdict({k: [readings[k], limits[k]]
                                        for k in limits})

    out = {"seed": seed, "losses": prog.losses,
           "reference_losses": want["losses"]}
    judged("program", compare(prog, want))
    if fault is not None:
        judged("fault", compare(fault, want))
    if with_control:
        judged("control", compare(control_readings(cell), want))
    return out


def control_readings(cell):
    """A training cell's readings with the control in the program's place:
    the float8 reference through the same steps."""
    from .entries.train import ProgramReadings
    from .reference import model as ref

    c = cell.reference(lin=ref.fp8_linear)
    return ProgramReadings(c["losses"], c["grads"], c["delta"])


def main(argv=None) -> int:
    from .run import HERE, load_context, power_limit, set_cache_dirs

    p = argparse.ArgumentParser(prog="h100_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = HERE.parent
    set_cache_dirs(root)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    print(f"control: {a.workload} on {power_limit()}", flush=True)
    ctx = load_context(root, a.workload, torch.device("cuda", 0))
    train = ctx.workload["entry"] == "train"
    for seed in (int(s) for s in a.seeds.split(",")):
        line = train_readings(ctx, seed, bool(a.control), bool(a.fault)) \
            if train else readings(ctx, seed, a.seconds, bool(a.control))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
