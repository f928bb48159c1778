"""Ranks of a multi-process run: port of ``matryoshka_mm_tpu/parallel/
mesh.py``.

The JAX package lays its devices out as a 2-axis logical mesh:

* ``data``: batch rows (DP) and fully sharded parameters;
* ``model``: tensor parallelism over attention heads and MLP columns.

Here a rank is a process.  ``torchrun`` (or any launcher that sets the
same environment) starts them, :func:`initialize_distributed` joins them
into the default process group, :func:`make_mesh` lays them out as a
``(data, model)`` ``DeviceMesh`` and :func:`put_batch` gives a rank its rows
of a global batch.  Tensor-parallel inference (``tp_decode.py``) starts its
own ranks and needs none of this.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def initialize_distributed(backend: Optional[str] = None,
                           init_file: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None) -> bool:
    """Join the default process group: from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``), or through the file store at ``init_file`` with
    ``rank`` and ``world_size`` (default: ``RANK`` and ``WORLD_SIZE``), which
    needs no free port.  NCCL where CUDA is available, else gloo, unless
    ``backend`` names one.  Where CUDA is available the rank takes card
    ``LOCAL_RANK % device_count`` on either backend, so ranks that share
    one card under gloo all land on it.  A no-op in one process (a world of
    one).  Returns True when the run is multi-process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    if init_file is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        if rank is None:
            rank = int(os.environ["RANK"])
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world_size)
    return dist.get_world_size() > 1


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Sequence[str] = ("data", "model"),
              device_type: Optional[str] = None):
    """A ``(data, model)`` ``DeviceMesh`` over the ranks of the default
    process group (:func:`initialize_distributed` first).  Default: every
    rank on the data axis.  ``device_type`` defaults to ``cuda`` where
    CUDA is available."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "initialize_distributed() under torchrun first")
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} ranks")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def put_batch(mesh, tree, axis: str = "data", device=None):
    """This rank's rows of a global batch: every tensor (or numpy array) of
    ``tree`` (dicts, lists, tuples; None stays None) split along dim 0 into
    as many equal parts as ``mesh`` has coordinates on ``axis``, part
    ``i`` to the ranks at coordinate ``i``, moved to ``device`` (the
    mesh's device of this rank by default).  Rows that do not divide
    raise."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    i = mesh.get_local_rank(axis)
    if device is None:
        device = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")

    def rows(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rows(v) for v in x)
        t = torch.as_tensor(x)
        if t.shape[0] % n:
            raise ValueError(f"put_batch: {t.shape[0]} rows over {n} "
                             f"parts of {axis!r}")
        m = t.shape[0] // n
        return t[i * m:(i + 1) * m].to(device)

    return rows(tree)
