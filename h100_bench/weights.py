"""Random weights of a configuration, made on the device from ``--seed``.

Every weight matrix, embedding and bias is a view into one flat buffer
filled with normal(0, 0.02) by a seeded ``torch.Generator`` on the device,
2^30 elements a call; every norm weight is a view into a second buffer,
normal(1, 0.02).  Leaves start at 256-byte
boundaries.  The tree has the layout the program takes (``vision_tower``,
``mm_projector``, ``llama``) and the reference reads the same tensors.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .reference.spec import ModelSpec

ALIGN = 128          # elements of a bf16 leaf's start: 256 bytes
CHUNK = 1 << 30      # elements a fill call draws


def _llama_leaves(d) -> dict:
    D, I, V = d.hidden, d.intermediate, d.vocab
    H, Hkv, Dh = d.heads, d.kv_heads, d.head_dim
    if d.family == "mpt":
        layers = [{"norm_1": ("norm", (D,)), "norm_2": ("norm", (D,)),
                   "attn": {"Wqkv": ("w", (3 * D, D)),
                            "out_proj": ("w", (D, D))},
                   "ffn": {"up_proj": ("w", (I, D)),
                           "down_proj": ("w", (D, I))}}
                  for _ in range(d.layers)]
    else:
        layers = [{"input_layernorm": ("norm", (D,)),
                   "post_attention_layernorm": ("norm", (D,)),
                   "self_attn": {"q_proj": ("w", (H * Dh, D)),
                                 "k_proj": ("w", (Hkv * Dh, D)),
                                 "v_proj": ("w", (Hkv * Dh, D)),
                                 "o_proj": ("w", (D, H * Dh))},
                   "mlp": {"gate_proj": ("w", (I, D)),
                           "up_proj": ("w", (I, D)),
                           "down_proj": ("w", (D, I))}}
                  for _ in range(d.layers)]
    tree = {"embed_tokens": ("w", (V, D)), "layers": layers,
            "norm": ("norm", (D,))}
    if not d.tied:
        tree["lm_head"] = ("w", (V, D))
    return tree


def _vision_leaves(v) -> dict:
    D, I, P = v.hidden, v.intermediate, v.patch
    n_pos = (v.image // P) ** 2 + 1

    def dense(o, i):
        return {"weight": ("w", (o, i)), "bias": ("w", (o,))}

    def ln():
        return {"weight": ("norm", (D,)), "bias": ("w", (D,))}

    return {"class_embedding": ("w", (D,)),
            "patch_embedding": ("w", (3 * P * P, D)),
            "position_embedding": ("w", (n_pos, D)),
            "pre_layrnorm": ln(),
            "layers": [{"layer_norm1": ln(),
                        "self_attn": {n: dense(D, D) for n in
                                      ("q_proj", "k_proj", "v_proj",
                                       "out_proj")},
                        "layer_norm2": ln(),
                        "mlp": {"fc1": dense(I, D), "fc2": dense(D, I)}}
                       for _ in range(v.layers)],
            "post_layernorm": ln()}


def _projector_leaves(spec: ModelSpec) -> dict:
    depth = spec.vision_shape().projector_layers
    D = spec.decoder.hidden
    return {"layers": [{"weight": ("w", (D, spec.vision.hidden if i == 0
                                         else D)),
                        "bias": ("w", (D,))} for i in range(depth)]}


def leaf_plan(spec: ModelSpec) -> dict:
    """The tree of ``(kind, shape)`` leaves the program is handed."""
    return {"llama": _llama_leaves(spec.decoder),
            "vision_tower": _vision_leaves(spec.vision),
            "mm_projector": _projector_leaves(spec)}


def _walk(tree, out: List[Tuple[str, tuple]], path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk(v, out, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _walk(v, out, path + (i,))
    else:
        out.append((path, tree))


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def make_weights(spec: ModelSpec, seed: int, device) -> dict:
    """The configuration's weights in its stated dtype, drawn on
    ``device``."""
    dtype = getattr(torch, spec.dtype)
    plan = leaf_plan(spec)
    leaves: List[Tuple[tuple, tuple]] = []
    _walk(plan, leaves)
    offsets = {"w": 0, "norm": 0}
    placed = []
    for path, (kind, shape) in leaves:
        n = 1
        for s in shape:
            n *= s
        placed.append((path, kind, shape, offsets[kind], n))
        offsets[kind] += -(-n // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(int(seed))
    bufs = {}
    for kind, mean in (("w", 0.0), ("norm", 1.0)):
        buf = torch.empty((offsets[kind],), device=device, dtype=dtype)
        for part in buf.split(CHUNK):
            part.normal_(mean, 0.02, generator=gen)
        bufs[kind] = buf
    tree = _skeleton(plan)
    for path, kind, shape, off, n in placed:
        _set(tree, path, bufs[kind][off:off + n].view(shape))
    return tree
