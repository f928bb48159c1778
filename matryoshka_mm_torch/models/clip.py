"""CLIP ViT vision tower (ViT-L/14-336), PyTorch port of
``matryoshka_mm_tpu/models/clip.py``: the select-layer features and the
M3 router's feature taps.

Parameters: ``patch_embedding`` is the flattened conv kernel ``(3*P*P, D)``
in ``(c, ph, pw)`` order and the patch embedding is one matmul, as in JAX
(a ``Conv2d`` would send float32 through cuDNN's TF32).  Every other dense
weight is ``{"weight": (out, in), "bias"}`` for ``F.linear``;
``params["layers"]`` is a list of per-layer dicts.

Attention is the plain non-causal ``attention_reference`` (the JAX tower
uses its reference path too; there is no kernel here).
:func:`s2_multiscale_forward` is the S2 multi-scale tower, a function that
neither package's ``generate`` or ``train`` calls.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..config import ClipVisionConfig
from ..ops.attention import attention_reference


def _layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["weight"], p["bias"], eps)


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["weight"], p["bias"])


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _clip_attention(p: dict, x: torch.Tensor,
                    cfg: ClipVisionConfig) -> torch.Tensor:
    B, S, D = x.shape
    H, Dh = cfg.num_attention_heads, cfg.head_dim

    def heads(y):
        return y.view(B, S, H, Dh).transpose(1, 2)

    q = heads(_linear(p["q_proj"], x))
    k = heads(_linear(p["k_proj"], x))
    v = heads(_linear(p["v_proj"], x))
    out = attention_reference(q, k, v, causal=False)
    return _linear(p["out_proj"], out.transpose(1, 2).reshape(B, S, D))


def _encoder_layer(p: dict, x: torch.Tensor,
                   cfg: ClipVisionConfig) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    x = x + _clip_attention(p["self_attn"], _layer_norm(x, p["layer_norm1"],
                                                        eps), cfg)
    h = _layer_norm(x, p["layer_norm2"], eps)
    h = _linear(p["mlp"]["fc2"], _quick_gelu(_linear(p["mlp"]["fc1"], h)))
    return x + h


def embed_pixels(params: dict, pixel_values: torch.Tensor,
                 cfg: ClipVisionConfig) -> torch.Tensor:
    """(B, 3, H, W) pixels -> (B, 1 + G*G, D): cls + patches + positions."""
    B = pixel_values.shape[0]
    P, G = cfg.patch_size, cfg.num_patches_per_side
    w = params["patch_embedding"]
    x = pixel_values.to(w.dtype)
    x = x.reshape(B, 3, G, P, G, P).permute(0, 2, 4, 1, 3, 5) \
        .reshape(B, G * G, 3 * P * P)
    patches = x @ w
    cls = params["class_embedding"].expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, patches], dim=1)
    return x + params["position_embedding"][None]


def clip_vision_forward(params: dict, pixel_values: torch.Tensor,
                        cfg: ClipVisionConfig, *,
                        want_router_taps: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """Run the tower; returns ``patch`` (B, G*G, D) and ``cls_patch``
    (B, 1 + G*G, D) of the select layer.  With ``want_router_taps`` the
    layers past it run too and the router's inputs are added: ``cls``,
    ``patchavgpool`` (select layer), ``clslast``, ``poolout`` (last layer,
    the second through ``post_layernorm``), and ``attnqk`` / ``attnkk``, the
    softmax over the patches of the last layer's raw cls query (or cls key)
    against its raw patch keys, scaled by ``hidden_size ** -0.5``."""
    x = embed_pixels(params, pixel_values, cfg)
    x = _layer_norm(x, params["pre_layrnorm"], cfg.layer_norm_eps)
    n = cfg.num_hidden_layers
    sel = cfg.select_layer if cfg.select_layer >= 0 \
        else n + cfg.select_layer + 1
    if not 0 < sel <= n:
        raise ValueError(f"select_layer {cfg.select_layer} out of range")
    layers = params["layers"]
    for lp in layers[:sel]:
        x = _encoder_layer(lp, x, cfg)
    out = {"cls_patch": x, "patch": x[:, 1:, :]}
    if not want_router_taps:
        return out

    # the last layer's q_proj / k_proj see the result of n - 1 layers (when
    # the select layer IS the last one, that layer runs once more on its
    # own output, as in the JAX package)
    h = x
    for lp in layers[sel:n - 1]:
        h = _encoder_layer(lp, h, cfg)
    last = layers[-1]
    x_ln = _layer_norm(h, last["layer_norm1"], cfg.layer_norm_eps)
    q_raw = _linear(last["self_attn"]["q_proj"], x_ln)
    k_raw = _linear(last["self_attn"]["k_proj"], x_ln)
    h_last = _encoder_layer(last, h, cfg)
    scale = cfg.hidden_size ** -0.5
    attn_qk = torch.einsum("bd,bnd->bn", q_raw[:, 0], k_raw[:, 1:]) * scale
    attn_kk = torch.einsum("bd,bnd->bn", k_raw[:, 0], k_raw[:, 1:]) * scale
    out["attnqk"] = torch.softmax(attn_qk.float(), dim=-1)
    out["attnkk"] = torch.softmax(attn_kk.float(), dim=-1)
    out["cls"] = x[:, 0, :]
    out["patchavgpool"] = x[:, 1:, :].mean(dim=1)
    out["clslast"] = h_last[:, 0, :]
    out["poolout"] = _layer_norm(h_last[:, 0, :], params["post_layernorm"],
                                 cfg.layer_norm_eps)
    return out


def feature_select(outputs: Dict[str, torch.Tensor],
                   select_feature: str) -> torch.Tensor:
    if select_feature == "patch":
        return outputs["patch"]
    if select_feature == "cls_patch":
        return outputs["cls_patch"]
    raise ValueError(f"Unexpected select feature: {select_feature}")


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """``(B, C, H, W)`` -> ``(B, C, size, size)``, bilinear with half-pixel
    centres and an antialiasing filter when it shrinks: the JAX
    ``jax.image.resize(..., "bilinear")``.  Resized in float32, cast back
    (PyTorch's CPU build has no bfloat16 antialiased resize)."""
    if x.shape[-1] == size and x.shape[-2] == size:
        return x
    return F.interpolate(x.float(), size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True).to(x.dtype)


def s2_multiscale_forward(params: dict, pixel_values: torch.Tensor,
                          cfg: ClipVisionConfig,
                          scales=(336, 672, 1008)) -> torch.Tensor:
    """The multi-scale (S2) tower: for each scale ``s`` resize the ``(B, 3,
    S_max, S_max)`` input to ``s x s``, split it into ``(s / base)^2``
    base-size tiles, run the tower over all tiles as one batch, put the
    tiles' patch grids back together and resize the ``(k G)^2`` grid down
    to the base grid ``G x G``.  The scales' features are concatenated on
    the channels -> ``(B, G * G, D * len(scales))``."""
    base = min(scales)
    if base != cfg.image_size:
        raise ValueError(f"the smallest S2 scale {base} must be the tower's "
                         f"image size {cfg.image_size}")
    B = pixel_values.shape[0]
    G, D = cfg.num_patches_per_side, cfg.hidden_size
    outs = []
    for s in sorted(scales):
        k = s // base
        img = _resize(pixel_values, s)
        # (B, 3, k, base, k, base) -> (B * k * k, 3, base, base), row-major
        tiles = img.reshape(B, 3, k, base, k, base).permute(0, 2, 4, 1, 3, 5) \
            .reshape(B * k * k, 3, base, base)
        feats = clip_vision_forward(params, tiles, cfg)["patch"]
        if k > 1:
            grid = feats.reshape(B, k, k, G, G, D).permute(0, 5, 1, 3, 2, 4) \
                .reshape(B, D, k * G, k * G)
            feats = _resize(grid, G).permute(0, 2, 3, 1).reshape(B, G * G, D)
        outs.append(feats)
    return torch.cat(outs, dim=-1)
