"""Task registry loader: every ``*.yaml`` in this directory is a task
(reference: lmms-eval/lmms_eval/tasks/ — one dir per task with YAML +
utils.py; flattened here to one YAML per task).

The PyTorch port's copy of ``matryoshka_mm_tpu/lmms_eval/tasks/__init__.py``.
"""

from __future__ import annotations

import glob
import os

_loaded = False


def load_all_tasks():
    global _loaded
    if _loaded:
        return
    import yaml

    from ..api.registry import register_task

    here = os.path.dirname(__file__)
    for path in sorted(glob.glob(os.path.join(here, "*.yaml"))):
        with open(path) as f:
            cfg = yaml.safe_load(f)
        if cfg and "task" in cfg:
            register_task(cfg["task"], cfg)
    _loaded = True
