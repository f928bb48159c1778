"""LoRA adapters as weight-leaf wrappers (port of
``matryoshka_mm_tpu/ops/lora.py``).

A LoRA-ized weight leaf is a dict ``{"w": base (out, in), "lora_a": (r, in),
"lora_b": (out, r), "lora_scale": (1, 1) = alpha / r}`` (peft's A/B
orientations); the base may be a plain tensor or an int8 / int4 quantized
leaf (QLoRA: quantize first, then :func:`add_lora`).  Two places resolve it:

* ``ops.quant.dequantize_array`` gives the merged weight
  ``base.detach() + (B @ A) * scale``, as the JAX package builds it per
  layer (:func:`merge_lora_weights` and every caller that wants one
  matrix);
* ``models.llama.proj`` multiplies in the other order,
  ``x W^T + ((x A^T) B^T) * scale``: the same function, but autograd then
  keeps no ``(out, in)`` gradient per projection, only the rank-r products.

Gradients reach A and B only; the base never requires grad.

peft's ``lora_dropout`` (on the layer input) is not implemented, as in the
JAX package.
"""

from __future__ import annotations

import re

import torch

from .quant import Q4KEY, QKEY, is_quantized

DEFAULT_TARGET = r"(self_attn|mlp)/[a-z_]*proj$"
DEFAULT_EXCLUDE = r"vision_tower|mm_projector|router|embed|norm|lm_head"
_ADAPTER_KEYS = ("lora_a", "lora_b", "lora_scale")


def is_lora(leaf) -> bool:
    return isinstance(leaf, dict) and "lora_a" in leaf


def _weight_shape(leaf) -> tuple:
    """Full ``(out, in)`` shape of a plain / int8 / int4-packed leaf."""
    if is_quantized(leaf):
        if Q4KEY in leaf:
            s = tuple(leaf[Q4KEY].shape)   # int4 packs pairs along `in`
            return s[:-1] + (s[-1] * 2,)
        return tuple(leaf[QKEY].shape)
    return tuple(leaf.shape)


def _leaf_device(leaf) -> torch.device:
    if is_quantized(leaf):
        return leaf["scale"].device
    return leaf.device


def wrap_leaf(generator: torch.Generator, leaf, r: int, alpha: float,
              dtype: torch.dtype = torch.float32) -> dict:
    """Attach a rank-``r`` adapter to one weight leaf (plain or quantized).
    A ~ he-uniform over the ``in`` axis (``U(-sqrt(6 / in), sqrt(6 / in))``,
    JAX's ``he_uniform(in_axis=-1)``), B = 0, so the wrapped model starts at
    the base model.  ``generator`` lives on the leaf's device."""
    d_out, d_in = _weight_shape(leaf)
    dev = _leaf_device(leaf)
    bound = (6.0 / d_in) ** 0.5
    a = (torch.rand((r, d_in), generator=generator, device=dev,
                    dtype=torch.float32) * 2 - 1).mul_(bound).to(dtype)
    return {"w": leaf, "lora_a": a,
            "lora_b": torch.zeros((d_out, r), dtype=dtype, device=dev),
            "lora_scale": torch.full((1, 1), alpha / r, dtype=dtype,
                                     device=dev)}


def _is_container(tree) -> bool:
    return isinstance(tree, (dict, list)) and not is_quantized(tree) \
        and not is_lora(tree)


def _map_tree(tree, fn, path=""):
    """Rebuild dicts and lists, calling ``fn(path, leaf)`` on every plain,
    quantized or LoRA leaf.  A list index is no part of ``path`` (the JAX
    tree stacks the layers, so its paths have none either)."""
    if isinstance(tree, list):
        return [_map_tree(v, fn, path) for v in tree]
    if _is_container(tree):
        return {k: _map_tree(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def add_lora(params: dict, generator: torch.Generator, r: int = 128,
             alpha: float = 256.0, target: str = DEFAULT_TARGET,
             exclude: str = DEFAULT_EXCLUDE,
             dtype: torch.dtype = torch.float32) -> dict:
    """Wrap every matching weight leaf of a (possibly quantized) parameter
    tree; returns a new tree that shares the base tensors.  The default
    target is every LM linear projection, excluding vision tower,
    projector, router, embeddings and lm_head."""
    if r < 1:
        raise ValueError(f"LoRA rank must be >= 1, got r={r}")
    t_re, e_re = re.compile(target), re.compile(exclude)
    n_wrapped = 0

    def wrap(path, leaf):
        nonlocal n_wrapped
        if is_lora(leaf) or not (t_re.search(path)
                                 and not e_re.search(path)):
            return leaf
        n_wrapped += 1
        return wrap_leaf(generator, leaf, r, alpha, dtype)

    out = _map_tree(params, wrap)
    if n_wrapped == 0:
        raise ValueError(f"no leaves matched target={target!r}")
    return out


def merge_lora_weights(params: dict, dtype=None) -> dict:
    """Collapse every LoRA wrapper into a plain merged tensor
    (``base + B @ A * scale``), dequantizing quantized bases."""
    from .quant import dequantize_array

    def merge(_, leaf):
        if not is_lora(leaf):
            return leaf
        with torch.no_grad():
            merged = dequantize_array(leaf, dtype or torch.float32)
        return merged

    return _map_tree(params, merge)


def strip_lora(params: dict) -> dict:
    """Drop adapters, returning the untouched base tree."""
    return _map_tree(params, lambda _, leaf: leaf["w"] if is_lora(leaf)
                     else leaf)


def extract_lora(params: dict):
    """Adapter-only tree (same nesting, LoRA leaves only; a list keeps its
    length, with None where a layer has no adapter)."""
    def rec(tree):
        if is_lora(tree):
            return {k: tree[k] for k in _ADAPTER_KEYS}
        if isinstance(tree, list):
            sub = [rec(v) for v in tree]
            return sub if any(v is not None for v in sub) else None
        if _is_container(tree):
            sub = {k: rec(v) for k, v in tree.items()}
            return {k: v for k, v in sub.items() if v is not None} or None
        return None

    return rec(params) or {}


def load_lora(params: dict, adapters) -> dict:
    """Attach a saved adapter tree onto a base tree."""
    def rec(tree, ad):
        if ad is None:
            return tree
        if isinstance(ad, dict) and "lora_a" in ad:
            return {"w": tree, **ad}
        if isinstance(tree, list):
            return [rec(v, a) for v, a in zip(tree, ad)]
        return {k: rec(v, ad.get(k)) for k, v in tree.items()}

    return rec(params, adapters)


def count_lora_params(params: dict) -> int:
    total = 0

    def count(_, leaf):
        nonlocal total
        if is_lora(leaf):
            total += leaf["lora_a"].numel() + leaf["lora_b"].numel()
        return leaf

    _map_tree(params, count)
    return total
