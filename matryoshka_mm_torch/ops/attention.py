"""Attention dispatch (port of ``matryoshka_mm_tpu/ops/attention.py``).

``attention()`` is the single entry point the models use.  With
``impl="auto"`` a multi-token query (prefill) goes to
:func:`~matryoshka_mm_torch.ops.flash_attention.flash_attention`, which runs
the hand-written CUDA kernel on a CUDA tensor and its plain version on a CPU
tensor; single-token decode steps reach their own kernel from
``models/llama.py``.  ``impl="reference"`` is :func:`attention_reference`,
the plain masked softmax, with the JAX reference's numerics.

Layout: ``(B, H, S, Dh)``, GQA via ``num_kv_heads <= num_heads``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large finite negative; -inf breaks fully masked rows


def _expand_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Repeat kv heads for grouped-query attention (head h reads h // G)."""
    num_kv = k.shape[1]
    if num_kv == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // num_kv, dim=1)


def attention_reference(
    q: torch.Tensor,                             # (B, H, Sq, Dh)
    k: torch.Tensor,                             # (B, Hkv, Sk, Dh)
    v: torch.Tensor,                             # (B, Hkv, Sk, Dh)
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,  # (B, Sq) absolute positions
    kv_positions: Optional[torch.Tensor] = None,  # (B, Sk)
    kv_valid: Optional[torch.Tensor] = None,     # (B, Sk) bool
    bias: Optional[torch.Tensor] = None,         # (1|B, H, Sq, Sk)
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Masked multi-head attention: f32 logits and softmax, masks at
    ``NEG_INF``, probabilities cast to ``v.dtype`` before the PV product,
    output in ``q.dtype``.  Causality is on absolute positions, so the same
    code covers prefill and decode against a cache."""
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)

    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * (Dh ** -0.5)
    if bias is not None:
        logits = logits + bias.float()

    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :].bool()
    if causal or sliding_window is not None:
        if q_positions is None:
            q_positions = torch.arange(Sq, device=q.device).expand(B, Sq)
        if kv_positions is None:
            kv_positions = torch.arange(Sk, device=q.device).expand(B, Sk)
        rel = q_positions[:, None, :, None] - kv_positions[:, None, None, :]
        if causal:
            mask = mask & (rel >= 0)
        if sliding_window is not None:
            mask = mask & (rel < sliding_window)

    logits = torch.where(mask, logits, torch.tensor(NEG_INF,
                                                    device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    q_index_offset: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatch: ``impl="auto"`` sends a multi-token query with no bias to
    the flash kernel (index causality, which equals position causality on
    the monotone layouts the splice and the cache produce); everything
    else, and ``impl="reference"``, to :func:`attention_reference`."""
    if impl == "auto" and bias is None and q.shape[2] > 1:
        from .flash_attention import flash_attention

        return flash_attention(
            q, k, v, causal=causal, kv_valid=kv_valid,
            sliding_window=sliding_window, q_index_offset=q_index_offset)
    return attention_reference(
        q, k, v, causal=causal, q_positions=q_positions,
        kv_positions=kv_positions, kv_valid=kv_valid, bias=bias,
        sliding_window=sliding_window)
