"""Optimizer construction: AdamW with per-module learning rates,
weight-decay masking and freeze groups (port of
``matryoshka_mm_tpu/train/optimizer.py``).

The JAX package builds an ``optax.multi_transform`` over a label tree; here
the same partition is a dict ``path -> label`` over the parameter tree, and
:class:`Optimizer` applies, to each group on its own (``backbone``,
``mm_projector``, ``vision_tower``, ``router``), what optax's chain applies:
``clip_by_global_norm(max_grad_norm)`` over THAT GROUP's gradients, then
AdamW (bias-corrected moments kept in the parameter's dtype, decoupled
weight decay masked off biases and norms, the learning rate read from the
schedule at the count BEFORE the update, so that with warm-up the first
step's rate is 0).  The ``frozen`` group takes no part.

Paths name a leaf by its keys joined with ``/``; a list index (the decoder
layer) is one of them.

Parameters placed over a mesh of ranks (``parallel/sharding.py``, DTensor
leaves): AdamW, its moments and the weight decay act on each rank's local
part, and each group's norm sums the squares over the whole mesh once
(``sharding.global_norm``: the ``model`` parts add up, a copy held by
several ranks counts once).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..parallel.sharding import global_norm, local_tree

GROUPS = ("backbone", "mm_projector", "vision_tower", "router")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    lr_schedule: str = "cosine"          # 'cosine' | 'linear' | 'constant'
    max_grad_norm: float = 1.0
    mm_projector_lr: Optional[float] = None
    mm_vision_tower_lr: Optional[float] = None
    router_lr: Optional[float] = None
    # freeze switches
    freeze_backbone: bool = False
    tune_mm_mlp_adapter: bool = False
    freeze_mm_mlp_adapter: bool = False
    unfreeze_mm_vision_tower: bool = False
    tune_router: bool = False
    # LoRA: adapters train at the backbone lr; base weights freeze;
    # projector / router keep their usual groups
    lora_enable: bool = False


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of a parameter tree with its path, in tree order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _module_of(path: str) -> str:
    if path.startswith("vision_tower"):
        return "vision_tower"
    if path.startswith("mm_projector"):
        return "mm_projector"
    if path.startswith("router"):
        return "router"
    return "backbone"


def _is_no_decay(path: str) -> bool:
    """No weight decay on biases and norm weights."""
    tail = path.rsplit("/", 1)[-1]
    return (
        "bias" in tail
        or "layernorm" in path.lower()
        or tail in ("norm", "input_layernorm", "post_attention_layernorm",
                    "class_embedding", "image_newline")
        or "norm" in tail
    )


def _label(path: str, cfg: OptimizerConfig) -> str:
    mod = _module_of(path)
    if cfg.lora_enable:
        tail = path.rsplit("/", 1)[-1]
        if tail in ("lora_a", "lora_b"):
            return "backbone"
        if mod == "mm_projector" and not cfg.freeze_mm_mlp_adapter:
            return "mm_projector"
        if mod == "router":
            return "router"
        return "frozen"
    if cfg.tune_router:
        return "router" if mod == "router" else "frozen"
    if cfg.tune_mm_mlp_adapter:
        return "mm_projector" if mod == "mm_projector" else "frozen"
    if mod == "vision_tower" and not cfg.unfreeze_mm_vision_tower:
        return "frozen"
    if mod == "mm_projector" and cfg.freeze_mm_mlp_adapter:
        return "frozen"
    if mod == "backbone" and cfg.freeze_backbone:
        return "frozen"
    return mod


def trainable_labels(params, cfg: OptimizerConfig) -> Dict[str, str]:
    """``path -> 'frozen'`` or the module group's name, for every leaf.  A
    leaf that is not floating point (an int8 / int4 base) is frozen
    whatever the switches say: it can carry no gradient."""
    return {path: _label(path, cfg) if leaf.is_floating_point() else "frozen"
            for path, leaf in named_leaves(params)}


def _schedule(cfg: OptimizerConfig, lr: float) -> Callable[[int], float]:
    """Learning rate at an update count (optax's ``join_schedules`` of a
    linear warm-up from 0 and the named decay)."""
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 0)

    def warm(count):
        return lr * min(max(count, 0), warmup) / warmup

    if cfg.lr_schedule == "constant":
        def after(count):
            return lr
    elif cfg.lr_schedule == "linear":
        steps = max(cfg.total_steps - warmup, 1)

        def after(count):
            return lr * (1 - min(max(count, 0), steps) / steps)
    else:
        steps = max(cfg.total_steps, warmup + 1) - warmup

        def after(count):
            return lr * 0.5 * (1 + math.cos(math.pi * min(count, steps)
                                            / steps))

    return lambda count: warm(count) if count < warmup \
        else after(count - warmup)


class Optimizer:
    """The per-group clip + AdamW update over a fixed set of trainable
    leaves.  ``init`` makes the state, ``update`` applies one update IN
    PLACE to the parameters and the state it is given."""

    def __init__(self, cfg: OptimizerConfig, labels: Dict[str, str]):
        self.cfg = cfg
        self.labels = labels
        self.trainable = [p for p, lab in labels.items() if lab != "frozen"]
        lrs = {"backbone": cfg.learning_rate,
               "mm_projector": cfg.mm_projector_lr or cfg.learning_rate,
               "vision_tower": cfg.mm_vision_tower_lr or cfg.learning_rate,
               "router": cfg.router_lr or cfg.learning_rate}
        self.schedules = {g: _schedule(cfg, lr) for g, lr in lrs.items()}

    def init(self, params) -> dict:
        leaves = dict(named_leaves(local_tree(params)))
        return {"count": 0,
                "mu": {p: torch.zeros_like(leaves[p])
                       for p in self.trainable},
                "nu": {p: torch.zeros_like(leaves[p])
                       for p in self.trainable}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params) -> dict:
        cfg = self.cfg
        placed = dict(named_leaves(params))
        leaves = dict(named_leaves(local_tree(params)))
        count = state["count"]
        bc1 = 1 - cfg.adam_b1 ** (count + 1)
        bc2 = 1 - cfg.adam_b2 ** (count + 1)
        for group in GROUPS:
            paths = [p for p in self.trainable if self.labels[p] == group]
            if not paths:
                continue
            ps = [leaves[p] for p in paths]
            gs = [grads[p] for p in paths]
            mus = [state["mu"][p] for p in paths]
            nus = [state["nu"][p] for p in paths]
            # clip_by_global_norm over this group alone
            norm = global_norm([placed[p] for p in paths], gs)
            factor = torch.where(norm < cfg.max_grad_norm,
                                 torch.ones_like(norm),
                                 cfg.max_grad_norm / norm)
            gs = [g * factor.to(g.dtype) for g in gs]
            torch._foreach_mul_(mus, cfg.adam_b1)
            torch._foreach_add_(mus, gs, alpha=1 - cfg.adam_b1)
            torch._foreach_mul_(nus, cfg.adam_b2)
            torch._foreach_addcmul_(nus, gs, gs, value=1 - cfg.adam_b2)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, cfg.adam_eps)
            upd = torch._foreach_div(mus, bc1)
            torch._foreach_div_(upd, denom)
            if cfg.weight_decay:
                decayed = [i for i, p in enumerate(paths)
                           if not _is_no_decay(p)]
                if decayed:
                    torch._foreach_add_([upd[i] for i in decayed],
                                        [ps[i] for i in decayed],
                                        alpha=cfg.weight_decay)
            torch._foreach_add_(ps, upd, alpha=-self.schedules[group](count))
        state["count"] = count + 1
        return state


class MultiSteps:
    """Gradient accumulation (optax's ``MultiSteps``): the running mean of
    ``every_k`` micro-batch gradients, one inner update every ``every_k``
    calls."""

    def __init__(self, inner: Optimizer, every_k: int):
        self.inner = inner
        self.every_k = every_k
        self.trainable = inner.trainable
        self.labels = inner.labels

    def init(self, params) -> dict:
        inner = self.inner.init(params)
        return {"mini_step": 0, "inner": inner,
                "acc": {p: torch.zeros_like(m)
                        for p, m in inner["mu"].items()}}

    @torch.no_grad()
    def update(self, grads, state: dict, params) -> dict:
        k = state["mini_step"]
        for p, acc in state["acc"].items():
            acc.add_((grads[p] - acc) / (k + 1))
        if k + 1 < self.every_k:
            state["mini_step"] = k + 1
            return state
        state["inner"] = self.inner.update(state["acc"], state["inner"],
                                           params)
        for acc in state["acc"].values():
            acc.zero_()
        state["mini_step"] = 0
        return state


def build_optimizer(params, cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(cfg, trainable_labels(params, cfg))
