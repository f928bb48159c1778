"""Running the port over several ranks: ``mesh.py`` (torch.distributed
from torchrun's environment or a file store, a (data, model) grid of
ranks, this rank's rows of a batch), ``sharding.py`` (every parameter's
placements as DTensors, and what each leaf computes with),
``collectives.py`` (tensor-parallel groups by name, the collectives
autograd carries, and the ring shift), ``inference.py`` (a ``(1, tp)``
placement for ``generate``), ``tp_decode.py`` (tensor-parallel inference
with the kernels kept, ``TPEngine``), ``pipeline.py`` (the decoder as a
GPipe pipeline over a ``(data, stage)`` mesh) and ``ring_attention.py``
(sequence-parallel attention over a ``seq`` dim).

``sharding.py`` and ``inference.py`` import ``torch.distributed.tensor``,
which is slow to import, so their names load on first use: a one-card run that
imports ``collectives.py`` never pays for it."""

import importlib

from .mesh import initialize_distributed, make_mesh, put_batch  # noqa: F401

_LAZY = {"make_tp_mesh": "inference", "shard_model_for_inference": "inference",
         "batch_sharding": "sharding", "param_shardings": "sharding",
         "placements_for": "sharding", "replicated": "sharding",
         "shard_params": "sharding"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
