"""Tensor-parallel inference placement: port of ``matryoshka_mm_tpu/
parallel/inference.py`` (the reference's ``device_map=auto``).

The JAX package places every weight with a megatron-style TP
``NamedSharding`` over a ``(1, tp)`` mesh and runs the same jitted
prefill and decode.  Here every rank of a ``(1, tp)`` mesh holds its
placed leaves (``sharding.shard_params``) and calls the same ``generate``
on the same inputs: ``generate`` takes the rank's view of the weights
(``sharding.compute_view``: embedding, head, tower and projector whole;
each decoder layer's heads, KV heads and MLP columns its own), its KV cache
holds the rank's KV heads, the o and down outputs are summed over the
ranks before their residual adds, and every rank gets the whole
vocabulary's logits and so the same tokens.

This is the route for the modes ``tp_decode.TPEngine`` refuses: the
``ver=v2`` combine, anyres tiles and multi-image prompts go through
``generate``'s own prefills unchanged.  The tests drive ``v0`` and ``v2``
prompts; anyres and multi-image prompts take the same decoder path
untested.  MPT, whose layer leaves match no ``model`` rule, runs its whole
decoder on every rank, as under the JAX placement.  The placed tree drops
into every entry point of ``generate.py`` (``generate``,
``stream_generate``, ``beam_generate``, ``speculative_generate``,
``chunked_prefill``, ``gating_probs``), ``LlavaModel`` and so the eval
drivers, and the worker's solo path; each takes the rank's view first.

Contract, as in JAX:

* float weights, or a quantized base in the unfused layout
  (``fuse=False``);
* ``cfg.llama.attn_impl`` is pinned to ``"reference"``;
* the mesh is ``(1, tp)``: a data axis above 1 raises ``ValueError``;
* ``tp`` must divide the heads, KV heads and MLP width.

Every rank of the default process group must be on the mesh
(``mesh.initialize_distributed`` first).  The decode steps run eagerly
(their collectives cannot be captured in a CUDA graph).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .mesh import make_mesh
from .sharding import shard_params


def make_tp_mesh(tp_size: Optional[int] = None,
                 device_type: Optional[str] = None):
    """A ``(data=1, model=tp)`` mesh over the ranks of the default process
    group (``tp_size`` defaults to all of them, mirroring
    ``device_map='auto'``)."""
    import torch.distributed as dist

    tp = tp_size or dist.get_world_size()
    return make_mesh((1, tp), device_type=device_type)


def shard_model_for_inference(params, cfg, tp_size: Optional[int] = None,
                              mesh=None) -> Tuple[dict, object, object]:
    """Place ``params`` TP-sharded for inference; returns
    ``(params, cfg, mesh)`` with ``cfg.llama.attn_impl`` pinned to
    ``"reference"``.  The placed tree drops into every entry point of
    ``generate.py`` unchanged."""
    mesh = mesh or make_tp_mesh(tp_size)
    if mesh.size(0) != 1:
        raise ValueError(
            f"inference mesh must be (1, tp), got {tuple(mesh.mesh.shape)}; "
            "batch data-parallel eval shards by process instead "
            "(eval/model_vqa_loader.py chunking)")
    params = shard_params(mesh, params)
    if getattr(cfg, "llama", None) is not None \
            and cfg.llama.attn_impl != "reference":
        cfg = dataclasses.replace(
            cfg, llama=dataclasses.replace(cfg.llama,
                                           attn_impl="reference"))
    return params, cfg, mesh
