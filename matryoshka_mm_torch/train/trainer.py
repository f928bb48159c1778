"""Trainer: train state + update step (port of
``matryoshka_mm_tpu/train/trainer.py``).

* ``TrainState`` = params + optimizer state + step + argmaxcost EMA buffer;
* ``make_train_step`` returns one function computing the full M3 objective,
  its gradients, and the optimizer update;
* metrics come back as a dict of device scalars per step.

Where the JAX step is a pure function that returns new arrays, this one
**updates the parameters and the optimizer state in place** and returns a
``TrainState`` holding the same objects: a 7B model is never copied.  Only
the trainable leaves (``trainable_labels``) require grad; frozen leaves and
int8 / int4 bases never do, so they come out of a step bit-identical.

Parameters placed over a ``(data, model)`` mesh of ranks
(``parallel/sharding.py`` ``shard_params``, DTensor leaves) train the same
way: each step runs on every rank on its rows of the batch (``put_batch``)
inside ``losses.global_batch`` over the ``data`` ranks, the leaves are
gathered to what they compute with at use (``sharding.compute_view``,
``models/llama.py``), and the backward of those gathers sums each leaf's
gradient over the ``data`` ranks (a reduce-scatter, FSDP's) before the norm
and the update.  The update acts on each rank's local parts, so every leaf
keeps its placements.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..config import LlavaConfig
from ..ops.quant import disable_fused_proj
from ..parallel import sharding
from . import losses as L
from .optimizer import OptimizerConfig, build_optimizer, named_leaves
from .train_step import M3Batch, m3_loss


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any
    # argmaxcost EMA buffer; a negative value means "uninitialized" (the
    # first update adopts the batch statistic)
    argmaxcost_ema: torch.Tensor


def create_train_state(params, opt_cfg: OptimizerConfig
                       ) -> Tuple[TrainState, Any]:
    """Returns ``(state, tx)``.  Sets ``requires_grad`` on the leaves of
    ``params``: True on the trainable ones, False on all others.  The EMA
    buffer lies on the device of the first leaf (this rank's, for placed
    params)."""
    tx = build_optimizer(params, opt_cfg)
    leaves = named_leaves(params)
    for path, leaf in leaves:
        leaf.requires_grad_(tx.labels[path] != "frozen")
    device = named_leaves(sharding.local_tree(params))[0][1].device
    state = TrainState(
        step=0, params=params, opt_state=tx.init(params),
        argmaxcost_ema=torch.full((), -1.0, dtype=torch.float32,
                                  device=device))
    return state, tx


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in float32."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def make_train_step(cfg: LlavaConfig, tx, uniform_buffer: bool = False,
                    frozen_vision: bool = False):
    """Build the ``(state, batch) -> (state, metrics)`` update.

    ``uniform_buffer`` pads every scale to one shared buffer length instead
    of the capacity buckets (see ``m3_loss``).  ``frozen_vision`` runs the
    vision tower without a graph: set it when the CLIP tower sits in the
    optimizer's frozen group (every recipe except
    ``unfreeze_mm_vision_tower``).

    ``metrics["grad_norm"]`` is the global norm of the trainable leaves'
    gradients before clipping.  (The JAX step differentiates frozen float
    leaves too and counts them; nothing here computes those gradients.)"""

    def step_fn(state: TrainState, batch: M3Batch):
        leaves = dict(named_leaves(state.params))
        trainable = [leaves[p] for p in tx.trainable]
        mesh = sharding.mesh_of(state.params)
        group = None if mesh is None else sharding.data_group(mesh)
        # the quantized matmul kernels are forward-only: a differentiated
        # step over a quantized base takes dequantize + matmul
        with disable_fused_proj(), L.global_batch(group):
            view, cfg_run = sharding.compute_view(state.params, cfg)
            loss, metrics = m3_loss(view, cfg_run, batch,
                                    argmaxcost_ema=state.argmaxcost_ema,
                                    uniform_buffer=uniform_buffer,
                                    frozen_vision=frozen_vision)
            grads = torch.autograd.grad(loss, trainable, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient (and still
        # takes its weight decay, as in optax); a placed leaf's gradient is
        # its local part
        grads = {p: torch.zeros_like(sharding.local(leaf)) if g is None
                 else sharding.local(g)
                 for p, leaf, g in zip(tx.trainable, trainable, grads)}
        metrics["grad_norm"] = global_norm(grads.values()) if mesh is None \
            else sharding.global_norm(trainable, list(grads.values()))
        opt_state = tx.update(grads, state.opt_state, state.params)
        new_ema = metrics.pop("_state/argmaxcost_ema", state.argmaxcost_ema)
        return TrainState(state.step + 1, state.params, opt_state,
                          new_ema.float()), metrics

    return step_fn


def host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}
