"""wandb-compatible metrics logging (the port's own copy of
``matryoshka_mm_tpu/utils/wandb_shim.py``).

The reference logs per-scale losses and gating statistics to wandb
(reference: llava/train/llava_trainer.py:457-499,766-794; lmms-eval
logging_utils.py).  wandb need not be installed: this shim
exposes the same ``init/log/finish`` surface and writes JSONL locally; when
a real wandb is importable it transparently delegates.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

_run = None


class _JsonlRun:
    def __init__(self, project: str, name: Optional[str], config: Dict,
                 dir: str):
        os.makedirs(dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.name = name or f"run_{stamp}"
        self.path = os.path.join(dir, f"{project}_{self.name}.jsonl")
        self._f = open(self.path, "a")
        self._step = 0
        if config:
            self._f.write(json.dumps({"_type": "config", **config},
                                     default=str) + "\n")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        self._step = step if step is not None else self._step + 1
        rec = {"_step": self._step, "_t": round(time.time(), 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def finish(self):
        self._f.close()


def init(project: str = "matryoshka-mm-tpu", name: Optional[str] = None,
         config: Optional[Dict] = None, dir: str = "./wandb_local", **kw):
    global _run
    try:
        import wandb as real_wandb  # pragma: no cover - optional package

        _run = real_wandb.init(project=project, name=name, config=config, **kw)
        return _run
    except ImportError:
        _run = _JsonlRun(project, name, config or {}, dir)
        return _run


def log(metrics: Dict[str, Any], step: Optional[int] = None):
    if _run is None:
        init()
    _run.log(metrics, step=step)


def finish():
    global _run
    if _run is not None:
        _run.finish()
        _run = None
