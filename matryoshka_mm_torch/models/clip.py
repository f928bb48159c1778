"""CLIP ViT vision tower (ViT-L/14-336), PyTorch port of
``matryoshka_mm_tpu/models/clip.py`` up to the select layer.

Parameters: ``patch_embedding`` is the flattened conv kernel ``(3*P*P, D)``
in ``(c, ph, pw)`` order and the patch embedding is one matmul, as in JAX
(a ``Conv2d`` would send float32 through cuDNN's TF32).  Every other dense
weight is ``{"weight": (out, in), "bias"}`` for ``F.linear``;
``params["layers"]`` is a list of per-layer dicts.

Attention is the plain non-causal ``attention_reference`` (the JAX tower
uses its reference path too; there is no kernel here).  The M3 router taps
(``want_router_taps``) and the S2 multi-scale tower are not ported yet
(ROADMAP.md Queue 1, items 3 and 8).
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
    """Run the tower up to ``select_layer``; returns ``patch`` (B, G*G, D)
    and ``cls_patch`` (B, 1 + G*G, D)."""
    if want_router_taps:
        raise NotImplementedError(
            "CLIP router taps are not ported yet (ROADMAP.md Queue 1, "
            "item 4: gateprobargmax)")
    x = embed_pixels(params, pixel_values, cfg)
    x = _layer_norm(x, params["pre_layrnorm"], cfg.layer_norm_eps)
    n = cfg.num_hidden_layers
    sel = cfg.select_layer if cfg.select_layer >= 0 \
        else n + cfg.select_layer + 1
    if not 0 < sel <= n:
        raise ValueError(f"select_layer {cfg.select_layer} out of range")
    for lp in params["layers"][:sel]:
        x = _encoder_layer(lp, x, cfg)
    return {"cls_patch": x, "patch": x[:, 1:, :]}


def feature_select(outputs: Dict[str, torch.Tensor],
                   select_feature: str) -> torch.Tensor:
    if select_feature == "patch":
        return outputs["patch"]
    if select_feature == "cls_patch":
        return outputs["cls_patch"]
    raise ValueError(f"Unexpected select feature: {select_feature}")
