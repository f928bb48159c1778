"""Prefill flash attention, forward only: the hand-written CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``matryoshka_mm_tpu/ops/flash_attention.py``
``_fwd_kernel`` / ``_fwd_call`` behind ``flash_attention`` and
``flash_attention_lse``.  Same function: tiled online softmax with f32
state, index-based causality with ``q_index_offset``, a ``kv_valid`` mask,
a sliding window, GQA by head mapping (no K/V expansion), and the
natural-log ``lse``.  A row with no valid key returns 0 (lse ``-1e30``).

What bounds it on the H100: arithmetic.  A 7B prefill layer does
``4 * B * H * Sq * Sk_seen * Dh`` FLOPs (QK^T and PV) over K/V tiles that
each block reads once into shared memory, so bytes are small beside the
math.  This first kernel does that math as plain f32 FMAs: one block per
(64-row q tile, head, batch row), two threads per row, K/V tiles converted
to f32 in shared memory and read as broadcasts, tiles above the causal
diagonal and below the window skipped.  Its ceiling is the f32 FMA rate,
far under the bf16 tensor-core rate; ``mma.sync``/``wgmma`` with TMA
loads is the next step (ROADMAP Queue 2).

Dispatch: a CPU tensor goes to :func:`flash_attention_plain`; a CUDA
tensor launches the kernel or raises on what it does not take (dtype other
than float32/bfloat16, ``Dh`` other than 64/128, a head dim that is not
contiguous, unaligned strides).  There is no fallback.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _kernels

LSE_MASKED = -1e30   # lse of a row with no valid key


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          kv_valid: Optional[torch.Tensor] = None,
                          sliding_window: Optional[int] = None,
                          q_index_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the whole score matrix at once,
    same masks and numerics (f32 scores, probabilities rounded to
    ``v.dtype`` for the PV product, sum kept in f32)."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    kf = k.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (Dh ** -0.5)

    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=dev)
    if kv_valid is not None:
        mask = mask & kv_valid.bool()[:, None, None, :]
    rows = torch.arange(Sq, device=dev)[:, None] + q_index_offset
    cols = torch.arange(Sk, device=dev)[None, :]
    if causal:
        mask = mask & (cols <= rows)
    if sliding_window:
        mask = mask & (rows - cols < sliding_window)

    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)                                # masked -> 0
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype),
                      v.repeat_interleave(G, dim=1)).float()
    out = torch.where(l > 0, pv / torch.where(l > 0, l, torch.ones_like(l)),
                      torch.zeros_like(pv))
    lse = torch.where(l > 0, m + torch.log(l),
                      torch.full_like(l, LSE_MASKED))[..., 0]
    return out.to(q.dtype), lse


def _check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                   device: torch.device) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}"
                         f", expected {dtype} on {device}")
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} needs a contiguous head "
                         f"dim and 16-byte aligned rows, got strides "
                         f"{t.stride()}")


def _launch(q, k, v, kv_valid, causal, window, q_offset):
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.dtype not in _kernels.DTYPE_CODES or Dh not in (64, 128):
        raise ValueError(f"flash_attention kernel takes float32/bfloat16 "
                         f"with Dh 64 or 128, got {q.dtype} Dh={Dh}")
    if H % Hkv or k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.dtype, q.device)
    if kv_valid is None:
        kv_valid = torch.ones((B, Sk), dtype=torch.bool, device=q.device)
    kv_valid = kv_valid.to(device=q.device, dtype=torch.bool).contiguous()
    if kv_valid.shape != (B, Sk):
        raise ValueError(f"flash_attention: kv_valid {tuple(kv_valid.shape)}"
                         f" != {(B, Sk)}")
    out = torch.empty((B, H, Sq, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _kernels.library().m3_flash_attention_fwd(
        _kernels.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), kv_valid.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, H, Hkv, Sq, Sk, Dh, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], kv_valid.stride(0), int(causal), int(window),
        int(q_offset), Dh ** -0.5, _kernels.stream_ptr(q.device))
    _kernels.check("m3_flash_attention_fwd", err)
    flash_attention_lse.launches += 1
    return out, lse


def flash_attention_lse(
    q: torch.Tensor,                          # (B, H, Sq, Dh)
    k: torch.Tensor,                          # (B, Hkv, Sk, Dh), may be strided
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_valid: Optional[torch.Tensor] = None,  # (B, Sk) bool
    sliding_window: Optional[int] = None,
    q_index_offset: int = 0,                  # q row i <-> kv slot i + offset
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention returning ``(out (B, H, Sq, Dh), lse (B, H, Sq))``.
    ``flash_attention_lse.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, kv_valid=kv_valid,
            sliding_window=sliding_window, q_index_offset=q_index_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return _launch(q, k, v, kv_valid, causal, sliding_window or 0,
                   q_index_offset)


flash_attention_lse.launches = 0


def flash_attention(q, k, v, *, causal: bool = True, q_positions=None,
                    kv_positions=None, kv_valid=None, sliding_window=None,
                    q_index_offset: int = 0) -> torch.Tensor:
    """Flash attention with a padding mask and index-based causality.
    ``q_positions`` / ``kv_positions`` are accepted for signature parity
    with the JAX function and not read: per-row positions are monotone in
    the sequence index on every layout the splice and cache produce."""
    return flash_attention_lse(
        q, k, v, causal=causal, kv_valid=kv_valid,
        sliding_window=sliding_window, q_index_offset=q_index_offset)[0]
