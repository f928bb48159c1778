"""Parameter and batch placements over a ``(data, model)`` mesh of ranks:
port of ``matryoshka_mm_tpu/parallel/sharding.py``.

The JAX package gives every leaf a ``NamedSharding`` from its path and XLA
inserts the gathers and reductions.  Here every leaf becomes a
``torch.distributed.tensor.DTensor`` with the same split, one ``Shard(d)``
or ``Replicate()`` per mesh dim (:func:`param_shardings`,
:func:`shard_params`), and the model code takes plain local tensors:
:func:`compute_leaf` turns a stored leaf into the tensor its role computes
with, through the collectives of ``collectives.py`` that autograd carries.

The rules (megatron-style TP on ``model``, residual dims on ``data`` for
ZeRO-3-like memory):

* attention q/k/v, MLP gate/up (``(out, in)``): out on ``model``, in on
  ``data``; o and down: out on ``data``, in on ``model``;
* embed / lm_head: vocab on ``model``, hidden on ``data``;
* CLIP and projector dense kernels as the JAX ``(in, out)`` kernels (the
  port stores them transposed, as ``weight``);
* a leaf of 2 or more dims with no rule: dim -2 on ``data``; a dim that
  does not divide its axis is replicated.

The port stores decoder and CLIP layers one dict a layer (``models/
convert.py`` ``_unstack``), so the JAX spec of a stacked leaf loses its
leading entry; a LoRA leaf (``w`` / ``lora_a`` / ``lora_b`` /
``lora_scale``) takes the rule of the path it sits under, as in JAX.
:func:`placements_for` is the pure function from ``(path, shape, axis
sizes)`` to placements.

What each leaf computes with (:func:`compute_leaf`): the decoder's
column-parallel products (q/k/v, gate/up, and the ``lora_b`` of each) keep
their ``model`` split on ``out``, the row-parallel ones (o, down, and their
``lora_a``) keep it on ``in``; every other leaf is gathered whole over
``model``.  A quantized base weight computes with the quantized kernels at
its part's shape: a column-parallel one keeps its rows of values and
scales; a row-parallel int8 one its inputs' values; a row-parallel int4
one is gathered whole and its inputs' part packed again in the split-half
layout of its own width (``ops/quant.py`` ``int4_k_shard``, exact), since
a byte holds two inputs half the width apart.  MPT's layer leaves match no
``model`` rule, so a model rank runs the whole MPT decoder
(:func:`mesh_llama_cfg`).  Every leaf is gathered whole over ``data``.
Gradients go back the same way: the ``data`` gather reduce-scatters (a
data rank's gradient is its rows' part); over ``model`` a leaf whose
product is summed after it (the ``lora_a`` of a column-parallel product,
the ``lora_b`` of a row-parallel one) reduce-scatters too, and every other
gathered leaf keeps its part of a gradient that every model rank holds
whole.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..ops.quant import Q4KEY, int4_k_shard
from . import collectives as C

AXES = ("data", "model")

# (substring, spec of the trailing dims), the JAX table: a JAX path, with
# dense kernels stored (in, out) as ``.../kernel``
_RULES = [
    ("self_attn/q_proj/kernel", ("data", "model")),
    ("self_attn/k_proj/kernel", ("data", "model")),
    ("self_attn/v_proj/kernel", ("data", "model")),
    ("self_attn/out_proj/kernel", ("data", "model")),
    ("mlp/fc1/kernel", ("data", "model")),
    ("mlp/fc2/kernel", ("model", "data")),
    ("self_attn/q_proj", ("model", "data")),
    ("self_attn/k_proj", ("model", "data")),
    ("self_attn/v_proj", ("model", "data")),
    ("self_attn/o_proj", ("data", "model")),
    ("mlp/gate_proj", ("model", "data")),
    ("mlp/up_proj", ("model", "data")),
    ("mlp/down_proj", ("data", "model")),
    ("embed_tokens", ("model", "data")),
    ("lm_head", ("model", "data")),
    ("patch_embedding", (None, "model")),
    ("position_embedding", (None, None)),
]

_COLUMN = ("self_attn/q_proj", "self_attn/k_proj", "self_attn/v_proj",
           "mlp/gate_proj", "mlp/up_proj")
_ROW = ("self_attn/o_proj", "mlp/down_proj")
_STACKED = re.compile(r"^(llama|vision_tower)/layers/(\d+)(/|$)")


def spec_for_path(path: str, ndim: int) -> tuple:
    """The JAX ``spec_for_path`` on a JAX path: mesh axis names (or None)
    for the trailing dims of an ``ndim``-dim leaf."""
    for needle, spec in _RULES:
        if needle in path:
            n = len(spec)
            if ndim == n:
                return spec
            if ndim == n + 1:
                return (None,) + spec
            if ndim < n:
                return spec[n - ndim:] if ndim else ()
    if ndim >= 2:
        return (None,) * (ndim - 2) + ("data", None)
    return ()


def _fix(spec: tuple, shape: Sequence[int], axis_sizes: Dict[str, int]
         ) -> tuple:
    """A dim that does not divide its axis (or is empty) is replicated."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(a if a is not None and d > 0 and d % axis_sizes.get(a, 1) == 0
                 else None for d, a in zip(shape, spec))


def jax_spec(path: str, shape: Sequence[int], axis_sizes: Dict[str, int]
             ) -> tuple:
    """The port leaf's split in JAX's terms: one axis name (or None) per
    dim of the port's ``shape``.  A per-layer leaf is looked up as the JAX
    stacked one (its path without the layer index, a leading dim more) and
    loses that dim's entry; a 2-dim ``weight`` is the JAX ``kernel``
    transposed."""
    shape = tuple(shape)
    m = _STACKED.match(path)
    jpath = path if m is None else (
        f"{m.group(1)}/layers{m.group(3)}" + path[m.end():])
    dense = jpath.endswith("/weight") and len(shape) == 2
    if dense:
        jpath = jpath[:-len("weight")] + "kernel"
        shape = shape[::-1]
    if m is not None:
        shape = (1,) + shape
    spec = _fix(spec_for_path(jpath, len(shape)), shape, axis_sizes)
    if m is not None:
        spec = spec[1:]
    return spec[::-1] if dense else spec


def placements_for(path: str, shape: Sequence[int],
                   axis_sizes: Dict[str, int],
                   axes: Sequence[str] = AXES) -> tuple:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim (``axes`` order)
    for the leaf at ``path`` (the port's path, keys joined by ``/``)."""
    spec = jax_spec(path, shape, axis_sizes)
    return tuple(Shard(spec.index(a)) if a in spec else Replicate()
                 for a in axes)


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _map_leaves(tree, fn, prefix: str = ""):
    """Rebuild dicts and lists with ``fn(path, tensor)`` on every tensor
    (None stays None)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(prefix, tree)


def param_shardings(mesh, params) -> Any:
    """Tree of placements tuples matching ``params``."""
    sizes = _axis_sizes(mesh)
    return _map_leaves(params, lambda p, t: placements_for(
        p, t.shape, sizes, mesh.mesh_dim_names))


def shard_params(mesh, params):
    """Every leaf of ``params`` (the same tensor on every rank) placed on
    ``mesh`` by the rules: a tree of DTensors holding a copy of only this
    rank's part (``params`` is left as it was).  No collective runs: each
    rank cuts its own part."""
    sizes = _axis_sizes(mesh)

    def place(path, t):
        if isinstance(t, DTensor):
            return t
        pl = placements_for(path, t.shape, sizes, mesh.mesh_dim_names)
        d = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
        local = d.to_local()
        if local.untyped_storage().data_ptr() == \
                t.untyped_storage().data_ptr():
            # a view of the given tensor: a copy of this rank's part, so
            # that the given tree stays as it was and only the part lives
            d = DTensor.from_local(local.clone(), mesh, pl, run_check=False,
                                   shape=t.shape, stride=t.stride())
        return d

    return _map_leaves(params, place)


def batch_sharding(mesh) -> tuple:
    """Batch tensors: leading dim over ``data``, replicated over the
    rest."""
    return tuple(Shard(0) if a == "data" else Replicate()
                 for a in mesh.mesh_dim_names)


def replicated(mesh) -> tuple:
    return (Replicate(),) * mesh.ndim


# ---------------------------------------------------------------------------
# what a leaf computes with
# ---------------------------------------------------------------------------

def _tensors(tree):
    """The tensors of ``tree`` (dicts, lists; None skipped), in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    elif tree is not None:
        yield tree


def is_sharded(tree) -> bool:
    """Whether the first tensor of ``tree`` is a DTensor (:func:`shard_params`
    places every leaf)."""
    return isinstance(next(_tensors(tree), None), DTensor)


def mesh_of(tree):
    """The mesh of a placed ``tree`` (its first tensor's), or None."""
    t = next(_tensors(tree), None)
    return t.device_mesh if isinstance(t, DTensor) else None


def _model_role(path: str) -> Tuple[Optional[int], str]:
    """``(dim kept split over model, or None, backward of a gather over
    model)`` of the leaf at ``path``.  Of a quantized weight (``ops/
    quant.py``), the int8 values and the per-output-channel ``scale`` of a
    column-parallel product keep their rows, the int8 values of a
    row-parallel one keep their inputs and its ``scale`` is whole; its
    int4 bytes are gathered whole (``"int4"``) and cut again by
    :func:`compute_leaf`."""
    if path.startswith("llama/layers/"):
        tail = path.rsplit("/", 1)[-1]
        if any(n in path for n in _COLUMN):
            if tail == "lora_a":
                return None, "sum"
            return (None, "slice") if tail == "lora_scale" else (0, "")
        if any(n in path for n in _ROW):
            if tail == "lora_b":
                return None, "sum"
            if tail == Q4KEY:
                return None, "int4"
            return (None, "slice") if tail in ("lora_scale", "scale") \
                else (1, "")
    return None, "slice"


def compute_leaf(path: str, leaf):
    """The local tensor a stored leaf computes with (its role: module
    docstring), gathered over the mesh where its role needs it.  Autograd
    carries the gathers; a plain tensor passes unchanged."""
    if not isinstance(leaf, DTensor):
        return leaf
    mesh = leaf.device_mesh
    keep, model_grad = _model_role(path)
    x = leaf.to_local()
    m = mesh.mesh_dim_names.index("model")
    if model_grad == "int4" and mesh.size(m) > 1:
        # a row-parallel int4 weight: its split-half bytes gathered whole,
        # then this rank's inputs (the model group's rank-th part) packed
        # in the layout of their own width, exact (no gradient: a frozen
        # base)
        for i, p in enumerate(leaf.placements):
            if isinstance(p, Shard) and mesh.size(i) > 1:
                x = C.all_gather_dim(x, p.dim, mesh.get_group(i))
        return int4_k_shard(x, mesh.size(m), mesh.get_local_rank(m))
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, leaf.placements)):
        if mesh.size(i) == 1:
            continue
        group = mesh.get_group(i)
        grad = "sum" if name != "model" else model_grad
        if isinstance(p, Shard):
            if name == "model" and keep is not None:
                if p.dim != keep:
                    raise ValueError(f"{path}: split on dim {p.dim} over "
                                     f"model; its product needs dim {keep}")
                continue
            x = C.gather_from_group(x, p.dim, group, grad=grad)
        elif name == "model" and keep is not None:
            raise ValueError(f"{path}: replicated over model; its product "
                             f"needs it split on dim {keep}")
        elif grad == "sum" and x.requires_grad:
            x = C.copy_to_group(x, group)
    return x


def compute_tree(tree, prefix: str = "", skip: Sequence[str] = ()):
    """:func:`compute_leaf` on every leaf of ``tree`` (paths under
    ``prefix``) except the subtrees at ``skip`` (full paths), which are
    kept as they are."""
    if isinstance(tree, (dict, list)) and prefix in skip:
        return tree
    if isinstance(tree, dict):
        return {k: compute_tree(v, f"{prefix}/{k}" if prefix else str(k),
                                skip) for k, v in tree.items()}
    if isinstance(tree, list):
        return [compute_tree(v, f"{prefix}/{i}" if prefix else str(i), skip)
                for i, v in enumerate(tree)]
    return compute_leaf(prefix, tree)


def full_tree(tree):
    """Every DTensor of ``tree`` gathered whole on every rank into new
    tensors, no gradient (a collective: every rank of the mesh calls
    it)."""
    def whole(path, t):
        if not isinstance(t, DTensor):
            return t
        x = t.to_local().detach().clone()
        mesh = t.device_mesh
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard):
                x = C.all_gather_dim(x, p.dim, mesh.get_group(i))
        return x

    with torch.no_grad():
        return _map_leaves(tree, whole)


def local(t):
    """A DTensor's local part (the same storage); a tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def local_tree(tree):
    """Every DTensor of ``tree`` as its local part (the same storage)."""
    return _map_leaves(tree, lambda p, t: local(t))


def owns(leaf) -> bool:
    """Whether this rank counts ``leaf``'s local part in a sum over the
    mesh: its coordinate is 0 on every mesh dim the leaf is replicated
    over, so that each element counts once."""
    if not isinstance(leaf, DTensor):
        return True
    coord = leaf.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, leaf.placements)
               if not isinstance(p, Shard))


def global_norm(leaves, grads) -> torch.Tensor:
    """sqrt of the sum of squares, in float32, of ``grads`` (local tensors)
    over the whole of each of ``leaves`` (their parameters, placed or
    not).  Over placed leaves the squares of each rank's parts are summed
    over the mesh, each element once (:func:`owns`); the mesh spans the
    world of the default group."""
    if not any(isinstance(t, DTensor) for t in leaves):
        return torch.linalg.vector_norm(
            torch.stack([n.float() for n in torch._foreach_norm(grads)]))
    parts = [g.float().square().sum() for t, g in zip(leaves, grads)
             if owns(t)]
    total = torch.stack(parts).sum() if parts else \
        torch.zeros((), device=grads[0].device)
    with C._span("sp.all_reduce_norm"):
        dist.all_reduce(total)
    return total.sqrt()


def data_group(mesh):
    """The ``data`` dim's group, or None for a mesh of one data rank."""
    i = mesh.mesh_dim_names.index("data")
    return mesh.get_group(i) if mesh.size(i) > 1 else None


class MeshTP:
    """The ``model`` dim of a mesh as a tensor-parallel group for
    ``models/llama.py`` (``LlamaConfig.tp_axis``): ``enter`` before a
    column-parallel block (identity, its gradient summed over the ranks)
    and ``all_reduce`` after a row-parallel one (summed, its gradient
    unchanged), both carried by autograd."""

    def __init__(self, group):
        self.group = group

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return C.copy_to_group(x, self.group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return C.reduce_from_group(x, self.group)


# the registered MeshTP of each mesh layout (its ranks and dim names)
_MESH_AXES: Dict[tuple, str] = {}


def mesh_llama_cfg(cfg, mesh):
    """The decoder config a rank of ``mesh`` runs: its heads, KV heads and
    MLP width (``model`` ways) and a ``tp_axis`` naming the mesh's model
    group; ``cfg`` itself on a mesh of one model rank, and for MPT, whose
    layer leaves (``attn/Wqkv``, ``attn/out_proj``, ``ffn/*``) match no
    ``model`` rule of the table: each is gathered whole and every model
    rank runs the whole decoder, as under the JAX placement."""
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    if tp == 1 or cfg.arch == "mpt":
        return cfg
    H, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if H % tp or Hkv % tp or cfg.intermediate_size % tp:
        raise ValueError(f"model={tp} must divide heads ({H}), kv heads "
                         f"({Hkv}) and ffn ({cfg.intermediate_size})")
    layout = (tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh.shape),
              tuple(mesh.mesh_dim_names))
    name = _MESH_AXES.get(layout)
    if name is None:
        name = f"mesh-model-{len(_MESH_AXES)}"
        C.register(name, MeshTP(mesh.get_group(
            mesh.mesh_dim_names.index("model"))))
        _MESH_AXES[layout] = name
    return dataclasses.replace(
        cfg, num_attention_heads=H // tp, num_key_value_heads=Hkv // tp,
        intermediate_size=cfg.intermediate_size // tp,
        head_dim_override=cfg.head_dim, tp_axis=name)


def compute_view(params: dict, cfg):
    """``(params, cfg)`` as a rank of the params' mesh runs them: every leaf
    outside the decoder layers gathered to what it computes with (once,
    here), the layers kept placed (``models/llama.py`` gathers each at use,
    inside its remat), and the decoder config of :func:`mesh_llama_cfg`.
    Plain params pass unchanged."""
    mesh = mesh_of(params)
    if mesh is None:
        return params, cfg
    view = compute_tree(params, skip=("llama/layers",))
    return view, dataclasses.replace(cfg, llama=mesh_llama_cfg(cfg.llama,
                                                               mesh))
