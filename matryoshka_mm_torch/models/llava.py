"""LLaVA-M3 top level, PyTorch port of ``matryoshka_mm_tpu/models/llava.py``:
encode -> project -> (router) -> M3 pool -> fixed-shape splice -> LLaMA.

``params`` is one dict: ``vision_tower``, ``mm_projector``, ``llama`` and,
for M3-MoE configs with a dense router, ``router``.  Multi-image and anyres
preparation are not ported yet (ROADMAP.md Queue 1, item 8); the router's
``textcls`` feature needs the BERT text embedder, which is not ported
either (Queue 1, slice 3), and raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import LlavaConfig
from ..kvconfig import parse_kv_from_string
from ..ops.pooling import matryoshka_pool
from ..ops.splice import SplicedBatch, splice_multimodal
from .clip import clip_vision_forward, feature_select
from .llama import embed_tokens, llama_forward, lm_head
from .projector import apply_projector
from .router import (build_router_input, dense_gating_forward,
                     uniform_gating_forward)


def router_embed_dim(cfg: LlavaConfig) -> int:
    dim = 0
    fts = cfg.router_feature_types
    if "textcls" in fts:
        dim += cfg.text_embed_dim
    if any(x in fts for x in ("cls", "clslast", "patchavgpool", "poolout")):
        dim += cfg.mm_hidden_size
    elif any(x in fts for x in ("attnqk", "attnkk")):
        dim += cfg.vision.num_patches
    return dim


def encode_images(params: dict, cfg: LlavaConfig,
                  pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
    """CLIP forward with feature select and, for M3-MoE configs, the
    router taps (the JAX package asks for them on every M3 config and lets
    the compiler drop the unused ones)."""
    outs = clip_vision_forward(params["vision_tower"], pixel_values,
                               cfg.vision, want_router_taps=cfg.is_m3_moe)
    outs["patch"] = feature_select(outs, cfg.vision.select_feature)
    return outs


def router_forward(params: dict, cfg: LlavaConfig,
                   encode_outputs: Dict[str, torch.Tensor],
                   text_embed: Optional[torch.Tensor] = None
                   ) -> Optional[torch.Tensor]:
    """(B, K) gating probabilities, or None when the config is not
    M3-MoE."""
    if not cfg.is_m3_moe:
        return None
    kvs = parse_kv_from_string(cfg.preset.moe)
    if kvs.get("t") == "id":
        return uniform_gating_forward(len(cfg.tokscale_list),
                                      encode_outputs["patch"])
    if "textcls" in cfg.router_feature_types and text_embed is None:
        raise NotImplementedError(
            "the router's textcls feature needs the BERT text embedder, "
            "which is not ported yet (ROADMAP.md Queue 1, slice 3)")
    router_input = build_router_input(encode_outputs,
                                      cfg.router_feature_types, text_embed)
    return dense_gating_forward(params["router"], router_input.float())


def project(params: dict, cfg: LlavaConfig, pixel_values: torch.Tensor,
            numtoks: int) -> Dict[str, Optional[torch.Tensor]]:
    """encode -> (projector) -> pool -> (projector) at a fixed scale."""
    outs = encode_images(params, cfg, pixel_values)
    feats = outs["patch"]
    if cfg.preset.projector_loc == "after_vision_tower":
        feats = apply_projector(params["mm_projector"], cfg.mm_projector_type,
                                feats)
    gating_prob = router_forward(params, cfg, outs)
    if cfg.preset.use_alternative and cfg.preset.projection_type == "v4":
        feats = matryoshka_pool(feats, numtoks)
    if cfg.preset.projector_loc == "after_pooling":
        feats = apply_projector(params["mm_projector"], cfg.mm_projector_type,
                                feats)
    return {"image_features": feats, "gating_prob": gating_prob}


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
    proj = project(params, cfg, pixel_values, numtoks)
    feats = proj["image_features"]
    text = embed_tokens(params["llama"], input_ids)
    L = out_len if out_len is not None else splice_capacity(cfg, T, numtoks)
    spliced = splice_multimodal(
        input_ids, text, feats[:, None], labels=labels, attn_mask=attn_mask,
        out_len=L, padding_side=padding_side or cfg.tokenizer_padding_side)
    return spliced, proj["gating_prob"]


def forward_spliced(params: dict, cfg: LlavaConfig,
                    spliced: SplicedBatch) -> torch.Tensor:
    """LLM forward over spliced embeddings -> float32 logits (B, L, V)."""
    hidden, _ = llama_forward(
        params["llama"], cfg.llama, spliced.embeds,
        position_ids=spliced.position_ids, attn_valid=spliced.attn_mask)
    return lm_head(params["llama"], hidden)
