"""Task and model registries (reference: lmms-eval/lmms_eval/api/registry.py).

The PyTorch port's copy of ``matryoshka_mm_tpu/lmms_eval/api/registry.py``.
"""

from __future__ import annotations

from typing import Callable, Dict

MODEL_REGISTRY: Dict[str, type] = {}
TASK_REGISTRY: Dict[str, dict] = {}


def register_model(name: str) -> Callable:
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return deco


def get_model(name: str) -> type:
    from .. import models  # noqa: F401  (populate registry)

    if name not in MODEL_REGISTRY:
        raise KeyError(f"model {name!r} not registered; "
                       f"have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def register_task(name: str, config: dict) -> None:
    TASK_REGISTRY[name] = config


def get_task(name: str) -> dict:
    from ..tasks import load_all_tasks

    load_all_tasks()
    if name not in TASK_REGISTRY:
        raise KeyError(f"task {name!r} not registered; "
                       f"have {sorted(TASK_REGISTRY)}")
    return TASK_REGISTRY[name]


def list_tasks():
    from ..tasks import load_all_tasks

    load_all_tasks()
    return sorted(TASK_REGISTRY)
