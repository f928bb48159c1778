#!/usr/bin/env python3
"""Run phases of ``chip_smoke.py`` from two checkouts of the port on one
NVIDIA GPU, in turns (A, B, B, A), each in a process of its own:

    python3 scripts/ab_torch_phases.py [--same-script] OLD_ROOT NEW_ROOT
        [slice] [train] [kernels] [quant] [qslice] [paged] [serve]

Each root is a directory holding ``chip_smoke.py`` and its
``matryoshka_mm_torch/`` (for instance a ``git archive`` of another commit,
unpacked into a git-ignored directory).  Each process builds that root's
kernels and runs the named phases (default: ``slice train``: phase 4,
TTFT per scale and decode tok/s on debug://7b in bf16; phase 10, the 7B
LoRA train step with its profile; also ``kernels``, phase 3's attention
kernels against their plain versions with their times, ``quant``, phase
3's quantized products with their times, shares of the byte or operations
bound and bf16 yardsticks, ``qslice``, phase 5, the quantized loads
through ``generate`` with their prefill and decode profiles, ``paged``,
phase 6's paged attention kernel
times, and ``serve``, phase 7, the serving slice with the profile of one
decode round).  With ``--same-script`` both runs take their phases from
NEW_ROOT's ``chip_smoke.py`` and only the package (kernels included) from
their own root, so that a measurement added in NEW_ROOT also reads OLD's
kernels; the phases then may use only the public API both packages have.
The lines the phases print that carry a measurement are printed again,
prefixed with the run's label and root, so that the two versions' numbers
stand side by side.  Exits non-zero if a run fails.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

PHASES = {"slice": "phase_slice", "train": "phase_train",
          "kernels": "phase_kernels", "quant": "phase_quant_kernels",
          "qslice": "phase_quant_slice", "paged": "phase_paged_kernels",
          "serve": "phase_serving"}
# the lines worth comparing (the phases print more)
KEEP = ("TTFT", "tok/s", "[train] step", "profile of one step",
        "device time by kind", "launches", "max_memory", "kernel ",
        "profile of one round", "paged_kernel", "quantized products",
        "prefill profile")

RUN = """
import importlib.util, sys, torch
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("chip_smoke", {script!r})
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
dev = torch.device("cuda", 0)
cs.phase_device()
cs.phase_build()
for name in {phases!r}:
    getattr(cs, name)(dev)
"""


def main(argv) -> int:
    same = "--same-script" in argv
    argv = [a for a in argv if a != "--same-script"]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = [str(Path(r).resolve()) for r in argv[:2]]
    phases = [PHASES[p] for p in (argv[2:] or ["slice", "train"])]
    for root in roots:
        if not (Path(root) / "chip_smoke.py").is_file():
            print(f"{root}: no chip_smoke.py", file=sys.stderr)
            return 2
    rc = 0
    for label, root in (("A", roots[0]), ("B", roots[1]), ("B", roots[1]),
                        ("A", roots[0])):
        script = str(Path(roots[1] if same else root) / "chip_smoke.py")
        proc = subprocess.run(
            [sys.executable, "-c",
             RUN.format(root=root, script=script, phases=phases)],
            capture_output=True, text=True, cwd=root)
        for line in proc.stdout.splitlines():
            if line.startswith("[") and not line.startswith("[ptxas]") \
                    and any(k in line for k in KEEP):
                print(f"{label} {root}: {line}")
        if proc.returncode != 0:
            print(f"{label} {root}: exit {proc.returncode}\n"
                  f"{proc.stderr[-3000:]}")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
