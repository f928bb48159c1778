"""LLaVA-M3 top level, PyTorch port of the single-image path of
``matryoshka_mm_tpu/models/llava.py``: encode -> project -> M3 pool ->
fixed-shape splice -> LLaMA.

``params`` is one dict: ``vision_tower``, ``mm_projector``, ``llama``.
The router (``is_m3_moe`` configs), multi-image and anyres preparation are
not ported yet (ROADMAP.md Queue 1, items 4 and 8).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import LlavaConfig
from ..ops.pooling import matryoshka_pool
from ..ops.splice import SplicedBatch, splice_multimodal
from .clip import clip_vision_forward, feature_select
from .llama import embed_tokens, llama_forward, lm_head
from .projector import apply_projector


def encode_images(params: dict, cfg: LlavaConfig,
                  pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
    """CLIP forward with feature select."""
    outs = clip_vision_forward(params["vision_tower"], pixel_values,
                               cfg.vision)
    outs["patch"] = feature_select(outs, cfg.vision.select_feature)
    return outs


def project(params: dict, cfg: LlavaConfig, pixel_values: torch.Tensor,
            numtoks: int) -> Dict[str, Optional[torch.Tensor]]:
    """encode -> (projector) -> pool -> (projector) at a fixed scale."""
    if cfg.is_m3_moe:
        raise NotImplementedError(
            "the M3 router (moe configs) is not ported yet (ROADMAP.md "
            "Queue 1, item 4)")
    feats = encode_images(params, cfg, pixel_values)["patch"]
    if cfg.preset.projector_loc == "after_vision_tower":
        feats = apply_projector(params["mm_projector"], cfg.mm_projector_type,
                                feats)
    if cfg.preset.use_alternative and cfg.preset.projection_type == "v4":
        feats = matryoshka_pool(feats, numtoks)
    if cfg.preset.projector_loc == "after_pooling":
        feats = apply_projector(params["mm_projector"], cfg.mm_projector_type,
                                feats)
    return {"image_features": feats, "gating_prob": None}


def splice_capacity(cfg: LlavaConfig, text_len: int, numtoks: int) -> int:
    """Static splice buffer size: text minus the sentinel plus visual
    tokens, clipped to ``tokenizer_model_max_length``."""
    return min(text_len + numtoks - 1,
               cfg.tokenizer_model_max_length)


def prepare_multimodal(
    params: dict,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,              # (B, T)
    pixel_values: torch.Tensor,           # (B, 3, H, W) one image per row
    *,
    numtoks: int,
    labels: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
    out_len: Optional[int] = None,
    padding_side: Optional[str] = None,
) -> Tuple[SplicedBatch, Optional[torch.Tensor]]:
    """Multimodal input preparation; returns ``(spliced, gating_prob)``."""
    T = input_ids.shape[1]
    feats = project(params, cfg, pixel_values, numtoks)["image_features"]
    text = embed_tokens(params["llama"], input_ids)
    L = out_len if out_len is not None else splice_capacity(cfg, T, numtoks)
    spliced = splice_multimodal(
        input_ids, text, feats[:, None], labels=labels, attn_mask=attn_mask,
        out_len=L, padding_side=padding_side or cfg.tokenizer_padding_side)
    return spliced, None


def forward_spliced(params: dict, cfg: LlavaConfig,
                    spliced: SplicedBatch) -> torch.Tensor:
    """LLM forward over spliced embeddings -> float32 logits (B, L, V)."""
    hidden, _ = llama_forward(
        params["llama"], cfg.llama, spliced.embeds,
        position_ids=spliced.position_ids, attn_valid=spliced.attn_mask)
    return lm_head(params["llama"], hidden)
