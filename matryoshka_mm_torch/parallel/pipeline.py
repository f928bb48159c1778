"""Pipeline parallelism for the decoder stack: port of
``matryoshka_mm_tpu/parallel/pipeline.py``.

A GPipe schedule over the ``stage`` dim of a ``(data, stage)`` mesh of
ranks, for decoders too big for one card even sharded:

* each stage keeps ``n_layers / S`` consecutive decoder layers
  (:func:`stage_params` cuts a full stack down to one stage's slice) and runs
  them through ``models/llama.py`` ``_layer_forward``, so that on the card
  its attention is the flash kernel and, in the backward, the flash
  backward kernels; ``cfg.remat`` recomputes each layer in the backward
  (``torch.utils.checkpoint``);
* microbatch ``m`` enters stage 0 at step ``m``; stage ``s`` runs
  microbatch ``t - s`` at step ``t`` for ``M + S - 1`` steps (the bubble is
  ``(S - 1) / (M + S - 1)``: pick ``n_microbatches >= 4 * S``); a step in
  which ``t - s`` lies outside ``[0, M)`` runs nothing, where the JAX
  package computes a value it then drops;
* after each step the activations move one stage on by the ring shift of
  ``collectives.py`` (the JAX ``ppermute``; ``pp.shift`` in a profile), and
  at the end the last stage's outputs reach every rank (the JAX ``psum``),
  which then applies the final RMSNorm;
* embeddings and the LM head stay outside, as in the JAX package; every
  ``data`` coordinate runs its own pipeline on the rows it is given.

Differentiable.  The shift's backward sends the gradient to the previous
stage; the outputs' backward keeps the last stage's gradient (each rank
holds the same loss of the same outputs, so a sum over ranks would count
it ``S`` times); the embeddings' backward broadcasts stage 0's gradient, so
that every rank holds the one-device gradient of ``embeds``, as
``jax.grad`` through the JAX ``shard_map`` gives it.  Every rank takes part
in every collective of the backward in one order: under grad mode each
step's input depends on both the fresh embeddings and the shifted buffer
(the gradient of the one not taken is zero), so the same nodes are in every
rank's graph.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..config import LlamaConfig
from ..models.llama import _layer_forward, rms_norm, rope_cos_sin
from .collectives import _span, ring_shift
from .mesh import make_mesh


def stage_range(n_layers: int, n_stages: int, stage: int) -> range:
    """The decoder layers stage ``stage`` of ``n_stages`` runs."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not divide into {n_stages} "
                         f"stages")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def stage_params(params: dict, n_stages: int, stage: int) -> dict:
    """``params`` (a decoder tree with all its ``layers``) cut down to what
    stage ``stage`` keeps: its slice of the layers and the final ``norm``
    (the same tensors).  The rest of the tree is dropped."""
    layers = params["layers"]
    return {"layers": [layers[i] for i in stage_range(len(layers), n_stages,
                                                      stage)],
            "norm": params["norm"]}


def _run_local_layers(layers_local, hidden, *, cfg: LlamaConfig, cos, sin,
                      positions, valid):
    """This stage's layers in turn (no cache: training / prefill), each
    recomputed in the backward under ``cfg.remat``."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i, lp in enumerate(layers_local):
        def body(h, lp=lp, i=i):
            return _layer_forward(lp, h, cfg=cfg, cos=cos, sin=sin,
                                  q_positions=positions, kv_valid=valid,
                                  cache=None, layer_idx=i)

        # no random op in a layer, so the recompute needs no RNG state
        hidden = checkpoint(body, hidden, use_reentrant=False,
                            preserve_rng_state=False) if remat \
            else body(hidden)
    return hidden


def _first(group) -> int:
    return dist.get_global_rank(group, 0)


def _last(group) -> int:
    return dist.get_global_rank(group, dist.get_world_size(group) - 1)


class _FromFirst(torch.autograd.Function):
    """Identity forward; the backward broadcasts stage 0's gradient to
    every stage (stage 0 alone reads the embeddings)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        with _span("pp.broadcast_grad"):
            dist.broadcast(g, _first(ctx.group), group=ctx.group)
        return g, None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every stage (a broadcast); the backward
    keeps the last stage's gradient and gives the others zeros."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.last = dist.get_rank(group) == dist.get_world_size(group) - 1
        out = x.detach().contiguous().clone()
        with _span("pp.broadcast"):
            dist.broadcast(out, _last(group), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


class _Pick(torch.autograd.Function):
    """``a`` where ``first``, else ``b`` (same shape); the one not taken
    gets a zero gradient, so that both stay in the graph."""

    @staticmethod
    def forward(ctx, first, a, b):
        ctx.first = first
        return (a if first else b).view_as(a)

    @staticmethod
    def backward(ctx, g):
        z = torch.zeros_like(g)
        return None, (g if ctx.first else z), (z if ctx.first else g)


def pipelined_decoder(params: dict, cfg: LlamaConfig, embeds: torch.Tensor,
                      position_ids: torch.Tensor, attn_valid: torch.Tensor,
                      mesh, n_microbatches: int,
                      stage_axis: str = "stage") -> torch.Tensor:
    """Run the decoder layers as an S-stage pipeline on this rank's stage.

    ``params``: this stage's layers and ``norm`` (:func:`stage_params`
    cuts them from a full stack; the JAX function takes the whole stack on
    every device).  ``embeds`` (B, L, D),
    ``position_ids`` and ``attn_valid`` (B, L): the same on every stage of
    a pipeline; ``n_microbatches`` must divide B and S the layers.  Returns
    the final hidden states after the last layer and the final norm, the
    same on every stage.  Every rank of the mesh calls it (and the
    backward of what it returns)."""
    dim = mesh.mesh_dim_names.index(stage_axis)
    S, s = mesh.size(dim), mesh.get_local_rank(stage_axis)
    group = mesh.get_group(dim)
    layers = params["layers"]
    mine = stage_range(cfg.num_hidden_layers, S, s)
    if len(layers) != len(mine):
        raise ValueError(f"stage {s} of {S}: {len(layers)} layers given, "
                         f"expected this stage's {len(mine)} "
                         f"(stage_params)")
    B, L, D = embeds.shape
    M = n_microbatches
    if B % M:
        raise ValueError(f"{B} rows do not divide into {M} microbatches")
    if torch.is_grad_enabled():
        # every rank's graph holds every shift (module docstring): the
        # embeddings carry a gradient even where the caller's do not
        if not embeds.requires_grad:
            embeds = embeds.detach().requires_grad_()
        embeds = _FromFirst.apply(embeds, group)
    emb_mb = embeds.reshape(M, B // M, L, D)
    pos_mb = position_ids.reshape(M, B // M, L)
    val_mb = attn_valid.reshape(M, B // M, L)

    buf = torch.zeros_like(emb_mb[0])
    outs = []
    for t in range(M + S - 1):
        i = min(max(t - s, 0), M - 1)
        x = _Pick.apply(s == 0, emb_mb[i], buf)
        if 0 <= t - s < M:
            cos, sin = rope_cos_sin(pos_mb[i], cfg.head_dim, cfg.rope_theta)
            y = _run_local_layers(layers, x, cfg=cfg, cos=cos, sin=sin,
                                  positions=pos_mb[i], valid=val_mb[i])
        else:
            y = x
        if t >= S - 1:
            outs.append(y)        # the last stage's are microbatch t - S + 1
        if t < M + S - 2:
            buf = ring_shift([y], group, 1, "pp.shift")[0]
    hidden = _FromLast.apply(torch.cat(outs), group)
    return rms_norm(hidden, params["norm"], cfg.rms_norm_eps)


def make_pp_mesh(n_stages: int, device_type: Optional[str] = None):
    """A ``(data, stage)`` ``DeviceMesh`` over the ranks of the default
    process group: ``world // n_stages`` pipelines of ``n_stages`` ranks
    (``mesh.make_mesh`` with those dim names)."""
    n = dist.get_world_size()
    if n % n_stages:
        raise ValueError(f"{n} ranks do not divide into {n_stages} stages")
    return make_mesh((n // n_stages, n_stages), axis_names=("data", "stage"),
                     device_type=device_type)
