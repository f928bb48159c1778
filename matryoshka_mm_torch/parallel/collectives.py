"""Tensor-parallel process groups by name, and the three collectives the
decoder runs under one: the counterpart of the JAX ``shard_map`` axis and
its ``psum`` / ``all_gather``.

A :class:`TPGroup` is a ``torch.distributed`` backend object (gloo or
NCCL) made straight from a store, outside the default process group, so a
process may hold several (an engine per model) and the caller's own
``init_process_group`` is never touched.  It is registered under a name;
``LlamaConfig.tp_axis`` holds that name, so a config stays picklable and
hashable, and ``models/llama.py`` looks the group up at each collective.

Gloo takes CUDA tensors for all three collectives here (torch 2.11,
float32, bfloat16 and int32: it stages them through the host itself), so
nothing is staged by hand on either backend.  NCCL needs one card a rank;
several ranks on one card (and the CPU) take gloo, which the caller names.
"""

from __future__ import annotations

import datetime
import threading
from typing import Dict

import torch
import torch.distributed as dist
from torch.profiler import record_function

BACKENDS = ("gloo", "nccl")

_GROUPS: Dict[str, "TPGroup"] = {}
_LOCK = threading.Lock()


class TPGroup:
    """``size`` ranks joined through the file store at ``store_path``;
    this process is ``rank``.  Every collective waits for its result, and
    shows in ``torch.profiler`` as ``tp.all_reduce`` / ``tp.all_gather`` /
    ``tp.broadcast``."""

    def __init__(self, store_path: str, rank: int, size: int, backend: str,
                 timeout_s: float):
        if backend not in BACKENDS:
            raise ValueError(f"backend={backend!r}; expected one of "
                             f"{BACKENDS}")
        self.rank, self.size, self.backend = rank, size, backend
        store = dist.FileStore(store_path, size)
        timeout = datetime.timedelta(seconds=timeout_s)
        if backend == "gloo":
            self.pg = dist.ProcessGroupGloo(store, rank, size, timeout)
        else:
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            self.pg = dist.ProcessGroupNCCL(store, rank, size, opts)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``x``, in ``x``'s dtype."""
        x = x.contiguous()
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        with record_function("tp.all_reduce"):
            self.pg.allreduce([x], opts).wait()
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last dim, in rank
        order (the JAX ``all_gather(..., tiled=True)``)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        with record_function("tp.all_gather"):
            self.pg.allgather([parts], [x]).wait()
        return torch.cat(parts, dim=-1)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` of rank ``src`` into ``x`` on every rank (contiguous)."""
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        opts.rootTensor = 0
        with record_function("tp.broadcast"):
            self.pg.broadcast([x], opts).wait()
        return x


def register(name: str, group: TPGroup) -> None:
    with _LOCK:
        if name in _GROUPS:
            raise ValueError(f"a TP group named {name!r} exists")
        _GROUPS[name] = group


def unregister(name: str) -> None:
    with _LOCK:
        _GROUPS.pop(name, None)


def tp_group(name: str) -> TPGroup:
    """The group registered under ``name`` (``LlamaConfig.tp_axis``)."""
    try:
        return _GROUPS[name]
    except KeyError:
        raise ValueError(f"no TP group named {name!r} in this process: a "
                         f"config with tp_axis runs on the ranks of its "
                         f"TPEngine") from None
