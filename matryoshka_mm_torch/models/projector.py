"""Multimodal projector, PyTorch port of
``matryoshka_mm_tpu/models/projector.py``: ``linear``, ``mlp{N}x_gelu``
(exact-erf GELU between layers, torch ``nn.GELU()``'s default) and
``identity``.  Parameters: ``{"layers": [{"weight": (out, in), "bias"}]}``.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn.functional as F

_MLP_GELU_RE = re.compile(r"^mlp(\d+)x_gelu$")


def projector_depth(projector_type: str) -> int:
    if projector_type == "linear":
        return 1
    if projector_type == "identity":
        return 0
    m = _MLP_GELU_RE.match(projector_type)
    if m:
        return int(m.group(1))
    raise ValueError(f"Unknown projector type: {projector_type}")


def apply_projector(params: Optional[dict], projector_type: str,
                    x: torch.Tensor) -> torch.Tensor:
    if projector_depth(projector_type) == 0:
        return x
    for i, layer in enumerate(params["layers"]):
        if i > 0:
            x = F.gelu(x)
        x = F.linear(x.to(layer["weight"].dtype), layer["weight"],
                     layer["bias"])
    return x
