"""Parameters of the PyTorch port: the bridge from the JAX package's
parameter pytree, and the port's own random initialisation.

Port layout (plain dicts of tensors):

* ``llama``: HF key names, dense weights ``(out, in)``; ``layers`` is a
  list of per-layer dicts (the JAX leaves are stacked ``(L, ...)`` and
  already ``(out, in)``, so they are only unstacked);
* ``vision_tower`` / ``mm_projector``: JAX dense leaves are
  ``{"kernel": (in, out), "bias"}`` and become ``{"weight": (out, in),
  "bias"}`` for ``F.linear``; ``patch_embedding`` stays the ``(3*P*P, D)``
  matrix (one matmul, not a conv);
* quantized leaves (from the JAX ``maybe_quantize``, any ``fuse``) become
  per-layer ``{"qint4" | "qint8", "scale"}`` dicts with their dtypes kept;
  the TPU tile padding recorded in ``orig_shape`` is cut off (for int4 the
  pad bytes sit after each half's ``K/2`` columns, so ``[:n, :k // 2]``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import LlavaConfig, torch_dtype
from ..ops.quant import Q4KEY, QKEY, is_quantized
from .projector import projector_depth


def _tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16 from JAX
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))   # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def _unstack(tree: dict, n: int) -> list:
    """Stacked ``{name: (n, ...)}`` tree -> list of n per-layer trees."""
    def pick(node, i):
        if is_quantized(node):
            return {k: v if k == "orig_shape" else v[i]
                    for k, v in node.items()}
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]
    return [pick(tree, i) for i in range(n)]


def strip_padding(leaf: dict) -> dict:
    """A JAX quantized leaf (numpy) -> ``{key, "scale"}`` without the tile
    padding.  ``orig_shape`` is read by attribute (``.n``, ``.k``)."""
    key = Q4KEY if Q4KEY in leaf else QKEY
    q, scale = np.asarray(leaf[key]), np.asarray(leaf["scale"])
    shape = leaf.get("orig_shape")
    if shape is not None:
        k = shape.k // 2 if key == Q4KEY else shape.k
        q, scale = q[..., :shape.n, :k], scale[..., :shape.n, :]
    return {key: q, "scale": scale}


def _map(tree, fn):
    if is_quantized(tree):
        return {k: fn(v, keep_dtype=True)
                for k, v in strip_padding(tree).items()}
    if isinstance(tree, dict):
        if set(tree) == {"kernel", "bias"}:
            return {"weight": fn(np.asarray(tree["kernel"]).T),
                    "bias": fn(tree["bias"])}
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(np_tree: dict, cfg: LlavaConfig, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """JAX LLaVA parameters (every leaf as a numpy array) -> port params.
    ``dtype`` casts every float leaf; None keeps each leaf's dtype.
    Quantized leaves keep theirs."""
    def fn(a, keep_dtype=False):
        return _tensor(a, device, None if keep_dtype else dtype)

    llama = dict(np_tree["llama"])
    vis = dict(np_tree["vision_tower"])
    llama["layers"] = _unstack(llama["layers"], cfg.llama.num_hidden_layers)
    vis["layers"] = _unstack(vis["layers"], cfg.vision.num_hidden_layers)
    return {"llama": _map(llama, fn), "vision_tower": _map(vis, fn),
            "mm_projector": _map(np_tree["mm_projector"], fn)}


def init_params(cfg: LlavaConfig, device="cpu", seed: int = 0) -> dict:
    """Random parameters made on ``device`` with a seeded
    ``torch.Generator`` (normal(0, 0.02) dense weights, unit norms, zero
    biases), so a 7B model never crosses from the host."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(0.02)

    def ones(n, dtype):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n, dtype):
        return torch.zeros(n, dtype=dtype, device=device)

    lc, vc = cfg.llama, cfg.vision
    ldt, vdt = torch_dtype(lc.dtype), torch_dtype(vc.dtype)
    D, I = lc.hidden_size, lc.intermediate_size
    H, Hkv, Dh = lc.num_attention_heads, lc.num_key_value_heads, lc.head_dim
    llama = {
        "embed_tokens": normal((lc.vocab_size, D), ldt),
        "layers": [{
            "input_layernorm": ones(D, ldt),
            "post_attention_layernorm": ones(D, ldt),
            "self_attn": {"q_proj": normal((H * Dh, D), ldt),
                          "k_proj": normal((Hkv * Dh, D), ldt),
                          "v_proj": normal((Hkv * Dh, D), ldt),
                          "o_proj": normal((D, H * Dh), ldt)},
            "mlp": {"gate_proj": normal((I, D), ldt),
                    "up_proj": normal((I, D), ldt),
                    "down_proj": normal((D, I), ldt)},
        } for _ in range(lc.num_hidden_layers)],
        "norm": ones(D, ldt),
    }
    if not lc.tie_word_embeddings:
        llama["lm_head"] = normal((lc.vocab_size, D), ldt)

    VD, VI, P = vc.hidden_size, vc.intermediate_size, vc.patch_size

    def dense(out_dim, in_dim, dtype):
        return {"weight": normal((out_dim, in_dim), dtype),
                "bias": zeros(out_dim, dtype)}

    def ln():
        return {"weight": ones(VD, vdt), "bias": zeros(VD, vdt)}

    vision = {
        "class_embedding": normal((VD,), vdt),
        "patch_embedding": normal((3 * P * P, VD), vdt),
        "position_embedding": normal((vc.num_positions, VD), vdt),
        "pre_layrnorm": ln(),
        "layers": [{
            "layer_norm1": ln(),
            "self_attn": {n: dense(VD, VD, vdt)
                          for n in ("q_proj", "k_proj", "v_proj",
                                    "out_proj")},
            "layer_norm2": ln(),
            "mlp": {"fc1": dense(VI, VD, vdt), "fc2": dense(VD, VI, vdt)},
        } for _ in range(vc.num_hidden_layers)],
        "post_layernorm": ln(),
    }
    depth = projector_depth(cfg.mm_projector_type)
    proj = {"layers": [dense(D, cfg.mm_hidden_size if i == 0 else D, ldt)
                       for i in range(depth)]} if depth else {}
    return {"llama": llama, "vision_tower": vision, "mm_projector": proj}
