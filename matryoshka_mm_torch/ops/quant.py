"""Weight-only int8 / int4 quantization (port of
``matryoshka_mm_tpu/ops/quant.py``), the ``load_8bit`` / ``load_4bit``
analog of the reference's bitsandbytes loading.

Formats, byte for byte those of the JAX package:

* int8, symmetric per output channel: ``scale = max|w| / 127`` (f32,
  at least 1e-8), ``q = clip(round(w / scale), -127, 127)``; a leaf is
  ``{"qint8": (N, K) int8, "scale": (N, 1) f32}``;
* int4, split-half "e8m": ``scale = max|w| / 7``, ``q`` clipped to
  ``[-7, 7]``; byte column ``j`` of the ``(N, K/2)`` packed matrix holds
  input ``j`` in its low nibble (excess-8) and input ``j + K/2`` in its high
  nibble (two's complement); a leaf is ``{"qint4": (N, K/2) int8,
  "scale": (N, 1) f32}``.

``round`` is half to even on both sides.  Dequantization rounds
``q * scale`` to bf16 by default, as the JAX package does.

Left out on purpose: the TPU tile padding (``pad_int4_leaf`` /
``pad_int8_leaf``); the CUDA kernels mask their own ragged edges, and
:func:`~matryoshka_mm_torch.models.convert.params_from_jax` strips the
padding off bridged JAX leaves.  Kept: the fused ``qkv_proj`` /
``gateup_proj`` layout (numerics-neutral, fewer launches per decode step).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

QKEY = "qint8"
Q4KEY = "qint4"


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and (QKEY in leaf or Q4KEY in leaf)


def _absmax_scale(wf: torch.Tensor, qmax: float,
                  stacked: bool) -> torch.Tensor:
    """``max|w| / qmax`` over the last axis, at least 1e-8.  The JAX
    package quantizes a stacked (per-layer) leaf under ``jit``, where XLA
    turns the division by the constant ``qmax`` into a product with its f32
    reciprocal, and a 2-D leaf op by op, with a true division.  Both forms
    are kept so the bytes match: ``stacked`` picks the first."""
    amax = wf.abs().amax(dim=-1, keepdim=True)
    scale = amax * (1.0 / qmax) if stacked else amax / qmax
    return torch.clamp(scale, min=1e-8)


def _quantize_2d(w: torch.Tensor, stacked: bool = False
                 ) -> Dict[str, torch.Tensor]:
    wf = w.float()
    scale = _absmax_scale(wf, 127.0, stacked)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {QKEY: q, "scale": scale}


def _quantize_2d_int4(w: torch.Tensor, stacked: bool = False
                      ) -> Dict[str, torch.Tensor]:
    wf = w.float()
    scale = _absmax_scale(wf, 7.0, stacked)
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int16)
    half = q.shape[-1] // 2
    lo = q[..., :half] + 8                      # excess-8, in [1, 15]
    hi = q[..., half:] & 0xF                    # two's-complement nibble
    packed = (hi << 4) | lo                     # 0..255
    packed = torch.where(packed > 127, packed - 256, packed)
    return {Q4KEY: packed.to(torch.int8), "scale": scale}


def _per_slice(fn, w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Quantize a stacked ``(n, out, in)`` tensor one slice at a time, so
    the f32 intermediate is one slice (as the JAX ``fori_loop``)."""
    parts = [fn(w[i], stacked=True) for i in range(w.shape[0])]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def quantize_array(w: torch.Tensor, stacked: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """``(..., out, in)`` float -> int8 values + per-output-channel f32
    scale.  ``stacked``: a 2-D slice of a JAX stacked leaf (one layer's
    weight), quantized as the JAX package quantizes the stack."""
    return _quantize_2d(w, stacked) if w.ndim <= 2 \
        else _per_slice(_quantize_2d, w)


def quantize_array_int4(w: torch.Tensor, stacked: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """``(..., out, in)`` float with an even ``in`` -> split-half e8m packed
    ``(..., out, in/2)`` int8 + per-output-channel f32 scale (``stacked``
    as for :func:`quantize_array`)."""
    if w.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even input dim, got "
                         f"{tuple(w.shape)}")
    return _quantize_2d_int4(w, stacked) if w.ndim <= 2 \
        else _per_slice(_quantize_2d_int4, w)


def unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., out, in/2)`` packed bytes -> signed ``(lo, hi)`` int8 halves
    (inputs ``[0, in/2)`` and ``[in/2, in)``)."""
    u = packed.to(torch.int16) & 0xFF
    lo = (u & 0xF) - 8
    hi = u >> 4
    hi = torch.where(hi >= 8, hi - 16, hi)
    return lo.to(torch.int8), hi.to(torch.int8)


def int_weight(leaf: dict) -> torch.Tensor:
    """The exact integer weight ``(..., N, K)`` of a quantized leaf, as
    int8."""
    if Q4KEY in leaf:
        return torch.cat(unpack_int4(leaf[Q4KEY]), dim=-1)
    return leaf[QKEY]


def dequantize_array(leaf, dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """A quantized leaf -> ``(q * scale)`` rounded to ``dtype`` (bf16 by
    default, as the JAX package); any other leaf is returned as it is."""
    if not is_quantized(leaf):
        return leaf
    return (int_weight(leaf).float() * leaf["scale"]).to(dtype)


def _concat_quant(leaves, key: str) -> Dict[str, torch.Tensor]:
    """Concatenate quantized leaves along the output channels (exact:
    per-channel scales make quantize-then-concat equal concat-then-
    quantize)."""
    return {key: torch.cat([l[key] for l in leaves], dim=-2),
            "scale": torch.cat([l["scale"] for l in leaves], dim=-2)}


def _fuse_layer_projections(layer: dict, key: str) -> dict:
    """One decoder layer: q/k/v -> ``qkv_proj`` and gate/up ->
    ``gateup_proj`` (gate rows, then up rows), in place."""
    a, m = layer["self_attn"], layer["mlp"]
    a["qkv_proj"] = _concat_quant([a.pop("q_proj"), a.pop("k_proj"),
                                   a.pop("v_proj")], key)
    m["gateup_proj"] = _concat_quant([m.pop("gate_proj"), m.pop("up_proj")],
                                     key)
    return layer


def _should_quantize(name: str, leaf, size: int, min_size: int,
                     bits: int) -> bool:
    """Dense kernels only (the JAX ``_should_quantize``): norms and the
    embedding table stay in the model dtype; int4 needs an even input
    dim.  ``size`` is the element count of the JAX leaf, which stacks the
    layers."""
    return (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
            and size >= min_size and leaf.is_floating_point()
            and "norm" not in name and "embed" not in name
            and (bits == 8 or leaf.shape[-1] % 2 == 0))


def quantize_llama_params(params: dict, bits: int, min_size: int = 4096,
                          fuse: bool = True) -> dict:
    """Quantize ``params["llama"]`` of LLaVA parameters in place, as the
    JAX ``maybe_quantize`` (``load_4bit`` for ``bits=4``, ``load_8bit`` for
    ``bits=8``): the same leaves, ``lm_head`` included, leaf by leaf so
    each float leaf is freed before the next one quantizes.  ``fuse`` then
    merges q/k/v and gate/up per layer.  Returns ``params``."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: expected 4 or 8")
    quant = quantize_array_int4 if bits == 4 else quantize_array
    llama = params["llama"]
    n_layers = len(llama["layers"])

    def rec(tree: dict, stack: int) -> None:
        for k in list(tree):
            child = tree[k]
            if isinstance(child, dict):
                rec(child, stack)
            elif isinstance(child, torch.Tensor) and _should_quantize(
                    k, child, stack * child.numel(), min_size, bits):
                tree[k] = quant(child, stacked=True)
                del child

    for layer in llama["layers"]:
        rec(layer, n_layers)
    for k in [k for k in llama if k != "layers"]:
        leaf = llama[k]
        if isinstance(leaf, torch.Tensor) and _should_quantize(
                k, leaf, leaf.numel(), min_size, bits):
            llama[k] = quant(leaf)
            del leaf
    key = Q4KEY if bits == 4 else QKEY
    if fuse:
        for layer in llama["layers"]:
            a, m = layer["self_attn"], layer["mlp"]
            if all(is_quantized(a.get(n)) for n in ("q_proj", "k_proj",
                                                     "v_proj")) \
                    and all(is_quantized(m.get(n)) for n in ("gate_proj",
                                                             "up_proj")):
                _fuse_layer_projections(layer, key)
    return params


# Gate of the quantized kernels: inside ``disable_fused_proj()`` every
# quantized projection dequantizes and multiplies (the JAX package uses it
# around differentiated traces; here it also gives the kernel-off
# comparison of the same weights).
_FUSED_PROJ_ENABLED = [True]


@contextlib.contextmanager
def disable_fused_proj():
    """Quantized projections dequantize and multiply inside this block."""
    _FUSED_PROJ_ENABLED.append(False)
    try:
        yield
    finally:
        _FUSED_PROJ_ENABLED.pop()


def fused_proj_enabled() -> bool:
    return _FUSED_PROJ_ENABLED[-1]


def _quantize_kv_slots(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., Dh)`` float -> int8 values + ``(...)`` f32 per-(slot, head)
    absmax scale: the JAX ``models/llama.py`` ``_quantize_kv_slots`` as it
    runs inside the jitted forward (the reciprocal form of
    :func:`_absmax_scale`)."""
    xf = x.float()
    scale = _absmax_scale(xf, 127.0, stacked=True)[..., 0]
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale
