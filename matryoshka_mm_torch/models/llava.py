"""LLaVA-M3 top level, PyTorch port of ``matryoshka_mm_tpu/models/llava.py``:
encode -> project -> (router) -> M3 pool -> fixed-shape splice -> LLaMA.

``params`` is one dict: ``vision_tower``, ``mm_projector``, ``llama``,
for M3-MoE configs with a dense router ``router``, and for an ``*unpad``
patch merge ``image_newline``.  Besides one image per row, a prompt may
carry M images at its M sentinels (:func:`prepare_multimodal_multi`) or one
LLaVA-NeXT anyres tile stack (:func:`prepare_multimodal_anyres`: each tile
pooled to the scale, the grid reassembled, unpadded to the image's aspect
and closed by one ``image_newline`` a row; :func:`anyres_token_count` is
its length on the host).  The router's ``textcls`` feature takes the
prompt embedding of ``models/text_embedder.py`` as ``text_embed`` and
raises the JAX ``ValueError`` without one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..config import LlavaConfig
from ..image_processing import get_anyres_image_grid_shape
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


def prepare_multimodal_multi(
    params: dict,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,              # (1, T) with M image sentinels
    pixel_values: torch.Tensor,           # (M, 3, H, W) distinct images
    *,
    numtoks: int,
    out_len: Optional[int] = None,
    padding_side: Optional[str] = None,
) -> Tuple[SplicedBatch, Optional[torch.Tensor]]:
    """Multi-image preparation for ONE sample: image i's pooled features
    land at the i-th ``IMAGE_TOKEN_INDEX`` sentinel (the M feature blocks
    ride the splice's image-slot axis).  ``out_len`` defaults to
    ``T - M + M * numtoks``."""
    M, T = pixel_values.shape[0], input_ids.shape[1]
    proj = project(params, cfg, pixel_values, numtoks)   # M as the batch
    text = embed_tokens(params["llama"], input_ids)
    L = out_len if out_len is not None else T - M + M * numtoks
    spliced = splice_multimodal(
        input_ids, text, proj["image_features"][None], out_len=L,
        padding_side=padding_side or cfg.tokenizer_padding_side)
    return spliced, proj["gating_prob"]


def unpad_image_features(grid: torch.Tensor, original_size,
                         current_hw) -> torch.Tensor:
    """Crop a (D, H, W) feature grid back to the image's aspect ratio; the
    original ``(width, height)`` is a host tuple, so the shapes are known
    before the call."""
    original_width, original_height = original_size
    current_height, current_width = current_hw
    if original_width / original_height > current_width / current_height:
        new_height = int(original_height * (current_width / original_width))
        padding = (current_height - new_height) // 2
        return grid[:, padding: current_height - padding, :]
    new_width = int(original_width * (current_height / original_height))
    padding = (current_width - new_width) // 2
    return grid[:, :, padding: current_width - padding]


def encode_anyres_features(params: dict, cfg: LlavaConfig,
                           pixel_values: torch.Tensor,   # (T, 3, H, W)
                           image_size, numtoks: int) -> torch.Tensor:
    """One anyres image -> its (L_img, D) token sequence.

    Tile 0 is the base resize, tiles 1..T-1 the grid.  Every tile is pooled
    to ``numtoks``.  ``flat`` concatenates the tiles; ``spatial`` lays the
    grid out row-major after the base; ``spatial_unpad`` reassembles the
    grid, crops it to the image's aspect and ends each of its rows with
    ``image_newline`` (a base alone gets one newline)."""
    feats = project(params, cfg, pixel_values, numtoks)["image_features"]
    merge = cfg.mm_patch_merge_type
    if merge == "flat":
        return feats.reshape(-1, feats.shape[-1])
    base, tiles = feats[0], feats[1:]
    D = base.shape[-1]
    if tiles.shape[0] == 0:
        if "unpad" in merge:
            base = torch.cat([base, params["image_newline"][None].to(
                base.dtype)])
        return base
    h = w = math.isqrt(base.shape[0])
    num_w, num_h = get_anyres_image_grid_shape(
        image_size, cfg.image_grid_pinpoints, cfg.vision.image_size)
    grid = tiles.reshape(num_h, num_w, h, w, D)
    if "unpad" in merge:
        grid = grid.permute(4, 0, 2, 1, 3).reshape(D, num_h * h, num_w * w)
        grid = unpad_image_features(grid, image_size, (num_h * h, num_w * w))
        newline = params["image_newline"].to(grid.dtype)[:, None, None]
        grid = torch.cat([grid, newline.expand(D, grid.shape[1], 1)], dim=2)
        tile_feats = grid.reshape(D, -1).T                # rows * (cols + 1)
    else:
        tile_feats = grid.permute(0, 2, 1, 3, 4).reshape(-1, D)
    return torch.cat([base, tile_feats])


def anyres_token_count(cfg: LlavaConfig, image_size, n_stacks: int,
                       numtoks: int) -> int:
    """The exact number of tokens :func:`encode_anyres_features` gives an
    image of ``image_size`` (width, height) whose stack holds ``n_stacks``
    tiles (the base included), computed on the host."""
    merge = cfg.mm_patch_merge_type
    if merge == "flat":
        return n_stacks * numtoks
    if n_stacks <= 1:
        return numtoks + (1 if "unpad" in merge else 0)
    h = w = math.isqrt(numtoks)
    num_w, num_h = get_anyres_image_grid_shape(
        image_size, cfg.image_grid_pinpoints, cfg.vision.image_size)
    H, W = num_h * h, num_w * w
    if "unpad" in merge:
        ow, oh = image_size
        if ow / oh > W / H:
            H -= 2 * ((H - int(oh * (W / ow))) // 2)
        else:
            W -= 2 * ((W - int(ow * (H / oh))) // 2)
        return numtoks + H * (W + 1)
    return numtoks + (n_stacks - 1) * numtoks


def prepare_multimodal_anyres(
    params: dict, cfg: LlavaConfig, input_ids: torch.Tensor,
    pixel_values: torch.Tensor, image_size, *, numtoks: int,
    out_len: int, padding_side: str = "left",
) -> SplicedBatch:
    """Batch-1 anyres preparation: the one sentinel of ``input_ids``
    (1, T) takes the merged tokens of the tile stack ``pixel_values``
    (T_tiles, 3, H, W)."""
    feats = encode_anyres_features(params, cfg, pixel_values, image_size,
                                   numtoks)
    text = embed_tokens(params["llama"], input_ids)
    return splice_multimodal(input_ids, text, feats[None, None],
                             out_len=out_len, padding_side=padding_side)


def forward_spliced(params: dict, cfg: LlavaConfig,
                    spliced: SplicedBatch) -> torch.Tensor:
    """LLM forward over spliced embeddings -> float32 logits (B, L, V)."""
    hidden, _ = llama_forward(
        params["llama"], cfg.llama, spliced.embeds,
        position_ids=spliced.position_ids, attn_valid=spliced.attn_mask)
    return lm_head(params["llama"], hidden)
