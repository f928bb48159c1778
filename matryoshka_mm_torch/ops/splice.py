"""Fixed-shape multimodal splice (port of ``matryoshka_mm_tpu/ops/splice.py``).

Each ``IMAGE_TOKEN_INDEX`` sentinel is replaced by a block of projected
image features inside a static-capacity ``out_len`` buffer, with
cumulative-sum index arithmetic and scatters (no per-sample Python loop):

* padding (``attn_mask == 0``) is stripped before splicing;
* each sentinel expands to ``N`` feature rows labelled ``IGNORE_INDEX``;
* sequences are truncated to ``out_len``;
* right or left padding of the result, with position ids counting only
  real tokens.

Out-of-range destinations go to one spare row ``L`` that is cut off, the
PyTorch form of JAX's ``mode="drop"`` scatter.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX


class SplicedBatch(NamedTuple):
    embeds: torch.Tensor        # (B, L, D)
    labels: torch.Tensor        # (B, L) int32, IGNORE_INDEX at pad/image rows
    attn_mask: torch.Tensor     # (B, L) bool
    position_ids: torch.Tensor  # (B, L) int32
    lengths: torch.Tensor       # (B,) int32 true (pre-truncation) lengths


def _scatter_rows(buf: torch.Tensor, dst: torch.Tensor,
                  val: torch.Tensor) -> torch.Tensor:
    """``buf[b, dst[b, t]] = val[b, t]`` along dim 1 (buf has a spare
    last row that takes the dropped writes)."""
    if val.dim() == 3:
        dst = dst[:, :, None].expand(-1, -1, val.shape[2])
    return buf.scatter(1, dst, val)


def splice_multimodal(
    input_ids: torch.Tensor,
    text_embeds: torch.Tensor,
    image_features: torch.Tensor,
    *,
    labels: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
    out_len: int,
    padding_side: str = "right",
) -> SplicedBatch:
    """Splice image features into token embeddings.

    input_ids (B, T) with ``IMAGE_TOKEN_INDEX`` sentinels; text_embeds
    (B, T, D); image_features (B, M, N, D), slot i consumed by the i-th
    sentinel of its row; labels / attn_mask optional (B, T)."""
    B, T = input_ids.shape
    D = text_embeds.shape[-1]
    _, M, N, _ = image_features.shape
    L = out_len
    dev = input_ids.device

    if attn_mask is None:
        attn_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    valid = attn_mask.bool()
    if labels is None:
        labels = torch.full((B, T), IGNORE_INDEX, dtype=torch.int32,
                            device=dev)
    labels = labels.to(torch.int32)

    is_img = (input_ids == IMAGE_TOKEN_INDEX) & valid
    img_i = is_img.long()
    vidx = valid.long().cumsum(dim=1) - 1                     # (B, T)
    k_before = img_i.cumsum(dim=1) - img_i                    # (B, T)
    out_pos = vidx + k_before * (N - 1)
    lengths = valid.long().sum(dim=1) + img_i.sum(dim=1) * (N - 1)

    # ---- text tokens ----
    text_ok = valid & ~is_img & (out_pos < L)
    text_dst = torch.where(text_ok, out_pos, torch.full_like(out_pos, L))
    embeds = _scatter_rows(
        torch.zeros((B, L + 1, D), dtype=text_embeds.dtype, device=dev),
        text_dst, text_embeds)
    out_labels = _scatter_rows(
        torch.full((B, L + 1), IGNORE_INDEX, dtype=torch.int32, device=dev),
        text_dst, labels)

    # ---- image blocks: the i-th sentinel of a row takes slot i ----
    arange_n = torch.arange(N, device=dev)[None, :]
    for i in range(M):
        sel = is_img & (k_before == i)
        has = sel.any(dim=1)
        start = torch.where(has, torch.where(sel, out_pos, 0).sum(dim=1),
                            torch.full_like(lengths, L))
        block_dst = start[:, None] + arange_n                 # (B, N)
        block_dst = torch.where(block_dst < L, block_dst,
                                torch.full_like(block_dst, L))
        embeds = _scatter_rows(embeds, block_dst,
                               image_features[:, i].to(embeds.dtype))
    embeds, out_labels = embeds[:, :L], out_labels[:, :L]

    # ---- mask / positions / padding side ----
    clip_len = torch.clamp(lengths, max=L)
    iota = torch.arange(L, device=dev)[None, :]
    if padding_side == "right":
        mask = iota < clip_len[:, None]
        position_ids = torch.where(mask, iota, 0)
    elif padding_side == "left":
        src = iota - (L - clip_len)[:, None]                  # (B, L)
        oob = src < 0
        src_c = src.clamp(0, L - 1)
        embeds = torch.gather(embeds, 1,
                              src_c[:, :, None].expand(-1, -1, D))
        embeds = embeds.masked_fill(oob[:, :, None], 0)
        out_labels = torch.gather(out_labels, 1, src_c)
        out_labels = out_labels.masked_fill(oob, IGNORE_INDEX)
        mask = ~oob
        position_ids = torch.where(mask, src, 0)
    else:
        raise ValueError(f"padding_side={padding_side!r}")

    out_labels = out_labels.masked_fill(~mask, IGNORE_INDEX)
    return SplicedBatch(embeds, out_labels, mask,
                        position_ids.to(torch.int32),
                        lengths.to(torch.int32))
