"""Decode attention: one query token per row against one layer's KV cache,
read in place.  The hand-written CUDA kernel ``csrc/decode_attention.cu``
and its plain PyTorch version.

Replaces the Pallas TPU kernels ``matryoshka_mm_tpu/ops/decode_attention.py``
``flash_decode_attention`` and ``flash_decode_attention_stacked``.  The
stacked variant existed only to keep XLA from copying a layer slice; in
PyTorch ``cache.k[l]`` is a free view, so one kernel takes the
``(B, S, n_kv, Dh)`` layer view through its strides.  Same function: f32
logits and online softmax, position causality (``kv_pos <= q_pos``),
``kv_valid``, sliding window, GQA.  A row with no valid slot returns 0.

The int8-KV branch (``kv_cache_dtype="int8"``): K and V are int8 with f32
per-(slot, kv head) scales ``k_scale`` / ``v_scale`` of shape
``(B, S, n_kv)``.  The K scale multiplies the logits and the V scale the
probabilities; the math stays in f32 on the card.  Its plain version is
attention over the cache dequantized to f32.

What bounds it on the H100: bytes.  Each decode step reads the layer's
whole cache, ``2 * B * S * n_kv * Dh`` elements, for two FLOPs per element;
that is far below the card's FLOP-per-byte balance.  The design reads each
cache byte once: one block per (kv head, batch row) serves the whole query
group (the TPU kernel multiplied every query head by every kv head to feed
its matrix unit; not copied), with 16-byte coalesced loads, several slots'
loads in flight per lane group, and the partial softmax states merged in
shared memory.  Any ``S`` is taken: the ragged tail is masked (no
``_pick_bs`` divisibility rule).  At B = 1 the grid is only ``n_kv``
blocks (32 at 7B) on 132 SMs, so one step cannot reach the card's
bandwidth; splitting the slot axis over blocks (split-K flash-decoding) is
a later change (ROADMAP Queue 2).

Dispatch: a CPU tensor goes to :func:`decode_attention_plain`; a CUDA
tensor launches the kernel or raises on what it does not take.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels


def decode_attention_plain(q, k, v, kv_valid, kv_positions, q_positions, *,
                           sliding_window: Optional[int] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same masks and numerics); an
    int8 cache is dequantized to f32 with its scales first."""
    if k.dtype == torch.int8:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
    B, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.float().reshape(B, Hkv, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (Dh ** -0.5)
    rel = q_positions[:, None] - kv_positions                      # (B, S)
    ok = kv_valid.bool() & (rel >= 0)
    if sliding_window:
        ok = ok & (rel < sliding_window)
    s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v).float()
    out = torch.where(l > 0, pv / torch.where(l > 0, l, torch.ones_like(l)),
                      torch.zeros_like(pv))
    return out.reshape(B, H, Dh).to(q.dtype)


def _launch(q, k, v, kv_valid, kv_positions, q_positions, window,
            k_scale=None, v_scale=None):
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    int8 = k.dtype == torch.int8
    kv_dtype = torch.int8 if int8 else q.dtype
    if q.dtype not in _kernels.DTYPE_CODES or Dh not in (64, 128) \
            or H % Hkv or H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention kernel takes float32/bfloat16, "
                         f"Dh 64 or 128, query groups of 1/2/4/8; got "
                         f"{q.dtype} Dh={Dh} H={H} Hkv={Hkv}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t, dtype in (("q", q, q.dtype), ("k", k, kv_dtype),
                           ("v", v, kv_dtype)):
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"decode_attention: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {q.device}")
        vec = 8 if int8 and name != "q" else 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} needs a contiguous "
                             f"head dim and 16-byte aligned rows, got "
                             f"strides {t.stride()}")
    valid = kv_valid.to(device=q.device, dtype=torch.bool).contiguous()
    kv_pos = kv_positions.to(device=q.device, dtype=torch.int32).contiguous()
    q_pos = q_positions.to(device=q.device, dtype=torch.int32).contiguous()
    if valid.shape != (B, S) or kv_pos.shape != (B, S) \
            or q_pos.shape != (B,):
        raise ValueError("decode_attention: kv_valid/kv_positions must be "
                         "(B, S) and q_positions (B,)")
    out = torch.empty((B, H, Dh), dtype=q.dtype, device=q.device)
    if int8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.dtype != torch.float32 \
                    or t.shape != (B, S, Hkv) or t.device != q.device \
                    or t.stride() != k_scale.stride():
                raise ValueError(f"decode_attention: an int8 cache needs "
                                 f"float32 {name} of shape {(B, S, Hkv)} "
                                 f"(k_scale and v_scale with one layout)")
        err = _kernels.library().m3_decode_attention_int8(
            _kernels.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            valid.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
            out.data_ptr(), B, H, Hkv, S, Dh, q.stride(0), q.stride(1),
            *k.stride()[:3], *v.stride()[:3], *k_scale.stride(),
            valid.stride(0), kv_pos.stride(0), int(window), Dh ** -0.5,
            _kernels.stream_ptr(q.device))
        _kernels.check("m3_decode_attention_int8", err)
        flash_decode_attention.launches += 1
        return out
    err = _kernels.library().m3_decode_attention(
        _kernels.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), valid.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), B, H, Hkv, S, Dh, q.stride(0), q.stride(1),
        *k.stride()[:3], *v.stride()[:3], valid.stride(0), kv_pos.stride(0),
        int(window), Dh ** -0.5, _kernels.stream_ptr(q.device))
    _kernels.check("m3_decode_attention", err)
    flash_decode_attention.launches += 1
    return out


def flash_decode_attention(
    q: torch.Tensor,             # (B, H, Dh) one query token per row
    k: torch.Tensor,             # (B, S, n_kv, Dh), e.g. the view cache.k[l]
    v: torch.Tensor,             # (B, S, n_kv, Dh)
    kv_valid: torch.Tensor,      # (B, S) bool
    kv_positions: torch.Tensor,  # (B, S) int
    q_positions: torch.Tensor,   # (B,) int absolute position of the query
    *,
    sliding_window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # (B, S, n_kv) f32, int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-> (B, H, Dh) attention output in ``q.dtype``.
    ``flash_decode_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_valid, kv_positions,
                                      q_positions,
                                      sliding_window=sliding_window,
                                      k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    return _launch(q, k, v, kv_valid, kv_positions, q_positions,
                   sliding_window or 0, k_scale, v_scale)


flash_decode_attention.launches = 0
