"""Tensor-parallel process groups by name, and the three collectives the
decoder runs under one: the counterpart of the JAX ``shard_map`` axis and
its ``psum`` / ``all_gather``.  Below them, the collectives autograd
carries over a ``DeviceMesh`` dim's group, for training across ranks
(``sharding.py``), and the ring shift (the JAX ``ppermute``) of the
pipeline's stages and of ring attention.

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

import contextlib
import datetime
import threading
import time
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

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself: the inference ranks carry no gradient."""
        return x

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


# ---------------------------------------------------------------------------
# collectives autograd carries, over a DeviceMesh dim's process group
# ---------------------------------------------------------------------------
#
# Training across ranks (``parallel/sharding.py``) runs the Megatron pair
# on the ``model`` group around every tensor-parallel block, and gathers a
# leaf stored split over ``data`` (or over ``model`` where its role wants
# the whole of it) at use.  A group of one rank makes each an identity.
# DTensor's own ``redistribute`` would do the gathers, but it runs through
# functional collectives, which kill the process (SIGSEGV) on CUDA tensors
# over gloo in torch 2.11 (``chip_smoke.py`` phase 21's probe), so these
# call gloo's plain all-gather and reduce-scatter, which take them.
# Each shows in ``torch.profiler`` as an ``sp.*`` range, and adds its host
# seconds to :func:`collective_seconds`.

_SPENT = [0.0]


def collective_seconds() -> float:
    """Host seconds spent so far in this process inside the collectives
    below (each waits for its result on gloo; under NCCL it counts the
    enqueue only)."""
    return _SPENT[0]


@contextlib.contextmanager
def _span(name: str):
    t0 = time.perf_counter()
    with record_function(name):
        yield
    _SPENT[0] += time.perf_counter() - t0


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group, name: str) -> torch.Tensor:
    x = x.contiguous()
    with _span(name):
        dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    n = _size(group)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((n * front.shape[0],) + tuple(front.shape[1:]))
    with _span("sp.all_gather"):
        dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum over the group."""
    n = _size(group)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // n,) + tuple(front.shape[1:]))
    with _span("sp.reduce_scatter"):
        dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _own_part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _CopyToGroup(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, "sp.all_reduce_grad"), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group, "sp.all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters (``sum``: each
    rank's gradient is a part of the whole) or keeps this rank's part
    (``slice``: every rank holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, grad):
        ctx.dim, ctx.group, ctx.grad = dim, group, grad
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        return _own_part(g, ctx.dim, ctx.group), None, None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``group``."""
    return x if _size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passes unchanged."""
    return x if _size(group) == 1 else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, dim: int, group,
                      grad: str = "sum") -> torch.Tensor:
    """The group's parts of ``x`` concatenated along ``dim``.  ``grad`` is
    ``"sum"`` (backward reduce-scatters: FSDP's gather over ``data``) or
    ``"slice"`` (backward keeps this rank's part)."""
    return x if _size(group) == 1 else _GatherFromGroup.apply(x, dim, group,
                                                              grad)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` with no gradient (checkpoint writes)."""
    return x if _size(group) == 1 else _all_gather(x, dim, group)


# ---------------------------------------------------------------------------
# the ring shift: the counterpart of the JAX ``ppermute`` over a ring
# ---------------------------------------------------------------------------
#
# Pipeline stages (``pipeline.py``) pass activations to the next stage and
# ring attention (``ring_attention.py``) rotates K/V blocks this way.  Gloo's
# send and receive take CPU tensors only, so on gloo a CUDA tensor is staged
# through a host copy on either side (``chip_smoke.py`` phase 22 probes
# both routes); NCCL takes the device tensors.  The sends and receives of
# one shift are all posted before any is waited on, so that no rank of the
# ring waits on another's receive before posting its own.  They are posted
# one by one: through ``batch_isend_irecv`` (torch 2.13, gloo) a process
# aborted at its exit ("terminate called without an active exception") in
# about one run of four ranks in four.  A failed shift raises.

def _ring_peer(group, offset: int) -> int:
    """The global rank ``offset`` places on from this rank in ``group``'s
    ring."""
    n = dist.get_world_size(group)
    return dist.get_global_rank(group, (dist.get_rank(group) + offset) % n)


def _shift_now(xs, group, offset: int, name: str) -> list:
    """Each tensor of ``xs`` to the rank ``offset`` places on in the ring,
    and the same tensors from the rank ``offset`` places back: new
    tensors (a ring of one rank copies)."""
    if _size(group) == 1:
        return [x.detach().clone() for x in xs]
    dev = xs[0].device
    staged = dev.type != "cpu" and "nccl" not in str(dist.get_backend(group))
    sends = []
    for x in xs:
        x = x.detach()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        sends.append((x.cpu() if staged else x).contiguous())
    recvs = [torch.empty_like(s) for s in sends]
    dst, src = _ring_peer(group, offset), _ring_peer(group, -offset)
    with _span(name):
        works = [dist.isend(s, dst, group=group) for s in sends] + \
            [dist.irecv(r, src, group=group) for r in recvs]
        for work in works:
            work.wait()
    out = []
    for x, r in zip(xs, recvs):
        r = r.to(dev) if staged else r
        out.append(r.bool() if x.dtype == torch.bool else r)
    return out


class _RingShift(torch.autograd.Function):
    """The shift forward; its backward shifts the gradients of the
    floating-point tensors the other way round the ring (a missing one as
    zeros, so that every rank takes part)."""

    @staticmethod
    def forward(ctx, group, offset, name, *xs):
        ctx.group, ctx.offset, ctx.name = group, offset, name
        ctx.floats = [x.is_floating_point() for x in xs]
        out = _shift_now(xs, group, offset, name)
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.floats)
                                      if not f])
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        back = iter(_shift_now([g for g, f in zip(gs, ctx.floats) if f],
                               ctx.group, -ctx.offset, ctx.name + "_grad"))
        return (None, None, None) + tuple(next(back) if f else None
                                          for f in ctx.floats)


def ring_shift(xs, group, offset: int = 1, name: str = "ring.shift") -> list:
    """``xs`` (tensors of one device) shifted ``offset`` places round the
    ring of ``group``'s ranks: this rank gets the tensors of the rank
    ``offset`` places back.  Differentiable: the gradient goes back the
    other way.  Every rank of ``group`` calls it, in the same order, and so
    does the backward.  Shows in ``torch.profiler`` as ``name`` (the
    backward as ``name + "_grad"``) and adds to
    :func:`collective_seconds`."""
    return list(_RingShift.apply(group, offset, name, *xs))
