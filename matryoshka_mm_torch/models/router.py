"""M3-MoE scale router (port of ``matryoshka_mm_tpu/models/router.py``):
the gating network that predicts which matryoshka token scale to use per
sample.

Plain functions over a parameter dict; dense weights are ``{"weight":
(out, in), "bias"}`` for ``F.linear`` like every dense leaf of the port.
The EMA buffer is explicit state threaded through the train step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def init_dense_gating_params(generator: torch.Generator, embed_dim: int,
                             num_experts: int,
                             dtype: torch.dtype = torch.float32,
                             device="cuda") -> dict:
    """``U(-1 / sqrt(in), 1 / sqrt(in))`` weights and zero biases, made on
    ``device`` (the card unless the caller names the CPU; ``generator``
    lives on the same device)."""
    bound = embed_dim ** -0.5

    def dense(out_dim):
        w = torch.rand((out_dim, embed_dim), generator=generator,
                       device=device, dtype=torch.float32) * 2 - 1
        return {"weight": w.mul_(bound).to(dtype),
                "bias": torch.zeros(out_dim, dtype=dtype, device=device)}

    return {"fc1": dense(embed_dim), "fc2": dense(num_experts)}


def dense_gating_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, D) -> (B, K) softmax gating probabilities in float32.  Weights
    of a narrower dtype than ``x`` (a bf16 checkpoint's) are widened to it,
    as JAX promotes them.  (The JAX function's dropout arguments are never
    passed by its callers and are not ported.)"""
    def dense(p, h):
        return F.linear(h, p["weight"].to(h.dtype), p["bias"].to(h.dtype))

    h = torch.tanh(dense(params["fc1"], x))
    return torch.softmax(dense(params["fc2"], h).float(), dim=-1)


def uniform_gating_forward(num_experts: int, x: torch.Tensor) -> torch.Tensor:
    return torch.full((x.shape[0], num_experts), 1.0 / num_experts,
                      dtype=torch.float32, device=x.device)


def build_router_input(encode_outputs: Dict[str, torch.Tensor],
                       feature_types,
                       text_embed: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Concatenate the configured feature taps."""
    parts = []
    for ft in feature_types:
        if ft == "textcls":
            if text_embed is None:
                raise ValueError("feature_type=textcls requires a text "
                                 "embedding")
            parts.append(text_embed)
        elif ft in encode_outputs:
            parts.append(encode_outputs[ft])
        else:
            raise ValueError(f"feature_type={ft} not available")
    return torch.cat(parts, dim=1)


def ema_update(ema: Optional[torch.Tensor], value: torch.Tensor,
               alpha: float) -> torch.Tensor:
    """EMA buffer update; ``alpha`` weights the NEW value.  ``ema=None``
    (first step) initializes to ``value``."""
    value = value.detach()
    if ema is None:
        return value
    return alpha * value + (1.0 - alpha) * ema
