"""Run one cell of the benchmark once and print its result line.

    python3 -m h100_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Everything a cell is made of is found
by name from ``BENCHMARK.json``: the cell's file ``workloads/<cell>.json``
(its entry kind, the program's settings, its rate and its limits), the
configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json``, the entry's driver ``entries/<entry>.py`` and
one reader ``metrics/<metric>.py`` per per-layer metric.  A new cell,
configuration, mix or metric is new files and new entries in
``BENCHMARK.json``; no file here changes.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled part of the
window.  The numbers that decide ``correct`` are printed last on standard
error and last in the line (``checks``).  The run exits non-zero, printing
no result, when the card is missing, and when JAX or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "matryoshka_mm_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclasses.dataclass
class Context:
    """What an entry driver and a metric reader are given."""

    root: Path
    bench: dict
    cell: dict
    config: dict
    workload: dict
    traffic: dict
    spec: Any
    device: Any

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def _named(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"h100_bench: no {what} named {name!r} in "
                     f"BENCHMARK.json")


def _load_json(root: Path, sub: str, name: str) -> dict:
    if not NAME.match(name):
        raise SystemExit(f"h100_bench: bad name {name!r}")
    with open(root / "h100_bench" / sub / f"{name}.json") as f:
        return json.load(f)


def load_context(root: Path, cell_name: str, device) -> Context:
    from .reference.spec import model_spec

    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = _named(bench["workloads"], cell_name, "workload")
    config = _load_json(root, "configs", cell["config"])
    return Context(root, bench, cell, config,
                   _load_json(root, "workloads", cell_name),
                   _load_json(root, "traffic", cell["traffic"]),
                   model_spec(config), device)


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end ones (those listing it,
    and those listing no cell), or (traced) the per-layer ones listing
    it."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def e2e_value(e2e: dict, name: str) -> float:
    """An end-to-end metric's value from what the entry measured.  A name
    ``<quantity>.<group>`` is the entry's ``<quantity>`` under a bound of
    its own for a group of cells (``tpot_p95_ms.mpt``)."""
    return e2e[name] if name in e2e else e2e[name.split(".")[0]]


def verdict(checks: Dict[str, list]) -> bool:
    """``correct``: every number compared within its limit (NaN fails)."""
    return all(float(v) <= float(lim) for v, lim in checks.values())


def load_reader(root: Path, metric: str):
    """``metrics/<metric>.py``'s ``read(run)``."""
    if not NAME.match(metric):
        raise SystemExit(f"h100_bench: bad metric name {metric!r}")
    path = root / "h100_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _number(x: float) -> float:
    return float(x) if math.isfinite(float(x)) else float("nan")


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_process: float) -> dict:
    """Run the cell once on ``device`` and return its result line (a
    dict); the card checks are the caller's."""
    ctx = load_context(root, cell_name, device)
    entry = ctx.workload["entry"]
    if not re.match(r"^[a-z_]+$", entry):
        raise SystemExit(f"h100_bench: bad entry {entry!r}")
    driver = importlib.import_module(f"h100_bench.entries.{entry}")
    out = driver.run(ctx, seed, seconds, trace, t_process)
    out["ctx"] = ctx
    metrics: Dict[str, dict] = {}
    result: Dict[str, Any] = {"correct": verdict(out["checks"]),
                              "attempted": int(out["attempted"]),
                              "failed": int(out["failed"])}
    wanted = cell_metrics(ctx.bench, cell_name, trace)
    tracer = out.get("tracer")
    if not trace:
        for m in wanted:
            metrics[m["name"]] = {
                "value": _number(e2e_value(out["e2e"], m["name"])),
                "unit": m["unit"]}
    else:
        for m in wanted:
            value = load_reader(root, m["name"])(out)
            if value is not None:
                metrics[m["name"]] = {"value": _number(value),
                                      "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_record(device, ctx.cell.get("chips", 1),
                                     out["memory_peak_bytes"])
    if trace and tracer is not None and tracer.t1_ns is not None:
        result["device"]["busy_s"] = tracer.busy_s()
        result["device"]["window_s"] = tracer.window_s
        result["breakdown"] = tracer.breakdown(out.get("spans"))
    result.update(out.get("extra", {}))
    result["checks"] = {k: {"value": _number(v), "limit": _number(lim)}
                        for k, (v, lim) in out["checks"].items()}
    return result


def device_record(device, count: int, peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": int(count), "memory_peak_bytes": peak}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules() -> List[str]:
    """The forbidden top-level names loaded in this process (an entry set
    to None blocks an import and loads nothing)."""
    return sorted({m.split(".")[0] for m, mod in list(sys.modules.items())
                   if mod is not None} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's kernel library builds into ``build/kernels``)."""
    base = root / "build" / "h100_bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="h100_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = HERE.parent
    set_cache_dirs(root)
    with open(root / "BENCHMARK.json") as f:
        cell = _named(json.load(f)["workloads"], a.workload, "workload")
    import torch

    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100_bench: needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    print(f"h100_bench: {a.workload} seed {a.seed} on {power_limit()}",
          file=sys.stderr)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(root, a.workload, a.seed, a.seconds, bool(a.trace),
                      device, T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"h100_bench: {time.perf_counter() - T_PROCESS:.1f} s in all",
          file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
