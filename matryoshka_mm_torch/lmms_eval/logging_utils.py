"""Eval-result logging: wandb tables + local artifacts.

Compact re-provision of the reference's ``WandbLogger``
(reference: lmms-eval/lmms_eval/logging_utils.py:72-366): after an eval
run it logs (1) a per-task results table (metric, filter, value, stderr),
(2) flat ``task/metric`` summary scalars, and (3) per-sample tables when
``--log_samples`` is set.  Backed by ``utils.wandb_shim`` — delegates to
real wandb when importable, otherwise writes JSONL + TSV artifacts under
the output directory so runs are inspectable offline.

The PyTorch port's copy of ``matryoshka_mm_tpu/lmms_eval/logging_utils.py``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from ..utils import wandb_shim


def _split_metric(key: str):
    metric, _, ens = key.partition(",")
    return metric, (ens or "none")


class EvalLogger:
    def __init__(self, project: str = "lmms-eval", name: Optional[str] = None,
                 config: Optional[Dict] = None, output_dir: str = "./logs"):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.run = wandb_shim.init(project=project, name=name,
                                   config=config or {}, dir=output_dir)
        self.results: Dict[str, Any] = {}

    def post_init(self, results: Dict[str, Any]):
        self.results = results

    def log_eval_result(self):
        """Summary scalars + the results table (reference:
        logging_utils.py:150-223 ``log_eval_result``/``_get_results_table``)."""
        rows = []
        summary = {}
        for task, agg in self.results.get("results", {}).items():
            for key, value in agg.items():
                if "_stderr" in key or key in ("samples", "time_s"):
                    continue
                metric, ens = _split_metric(key)
                skey = (f"{metric}_stderr,{ens}" if ens != "none"
                        else f"{metric}_stderr")
                rows.append({"task": task, "metric": metric, "filter": ens,
                             "value": value, "stderr": agg.get(skey, 0.0),
                             "n": agg.get("samples", 0)})
                if isinstance(value, (int, float)):
                    summary[f"{task}/{key}"] = value
        wandb_shim.log(summary)
        self._write_table("results", rows)
        return rows

    def log_eval_samples(self, samples: Dict[str, list]):
        """Per-sample tables, one artifact per task (reference:
        logging_utils.py:255-366 ``log_eval_samples``)."""
        for task, rows in samples.items():
            self._write_table(f"samples_{task}", rows)

    def _write_table(self, name: str, rows):
        path = os.path.join(self.output_dir, f"{name}.jsonl")
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps(r, default=str) + "\n")
        if rows and isinstance(rows[0], dict) and "value" in rows[0]:
            cols = list(rows[0])
            tsv = os.path.join(self.output_dir, f"{name}.tsv")
            with open(tsv, "w") as f:
                f.write("\t".join(cols) + "\n")
                for r in rows:
                    f.write("\t".join(str(r.get(c, "")) for c in cols) + "\n")

    def finish(self):
        wandb_shim.finish()
