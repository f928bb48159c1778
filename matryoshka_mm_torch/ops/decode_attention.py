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
cache byte once: a block serves the whole query group of one kv head (the
TPU kernel multiplied every query head by every kv head to feed its matrix
unit; not copied), with 16-byte coalesced loads, several slots' loads in
flight per lane group, and its lane groups' partial softmax states merged in
shared memory.  A row's slots are split over ``n_split`` blocks
(split-K flash-decoding; :func:`decode_splits` picks it from the launch
geometry): at B = 1 the 7B model has only 32 (kv head, row) pairs for 132
SMs.  The ``n_split`` blocks of one pair form a thread-block cluster and
merge their (max, sum, accumulator) states through distributed shared
memory, so a call is one launch and allocates nothing.
:func:`decode_attention_split_plain` runs the same split and merge in
PyTorch.  Any ``S`` is taken: the ragged tail is masked (no ``_pick_bs``
divisibility rule).

Dispatch: a CPU tensor goes to :func:`decode_attention_plain`; a CUDA
tensor launches the kernel or raises on what it does not take.
"""

from __future__ import annotations

import functools
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


MAX_SPLIT = 8          # blocks of a cluster: the portable size
SPLIT_MIN_SLOTS = 128  # slots of one split at the least: four steps of a
                       # block's walk, so that the walk and not the merge
                       # sets a block's time
BLOCKS_PER_SM = 2      # beyond this, clusters of 4 no longer fit one wave
                       # (scripts/sweep_torch_decode_splits.py)
H100_SMS = 132


def decode_splits(B: int, Hkv: int, S: int, sms: int = H100_SMS) -> int:
    """Blocks over which the kernel splits the slots of one (kv head, row):
    the largest power of two, at most :data:`MAX_SPLIT`, with which the
    ``B * Hkv * n_split`` blocks stay within :data:`BLOCKS_PER_SM` a SM and
    every split keeps :data:`SPLIT_MIN_SLOTS` slots: 4 for the 7B model at
    B = 1 and 672 slots, 2 at B = 4, 1 where ``B * Hkv`` already exceeds
    the SMs (B = 8) or the cache is short.  It changes the order of the f32
    sums only, never the masks."""
    n = 1
    while (2 * n <= MAX_SPLIT and B * Hkv * 2 * n <= BLOCKS_PER_SM * sms
           and S >= 2 * n * SPLIT_MIN_SLOTS):
        n *= 2
    return n


def split_ranges(S: int, n_split: int) -> list:
    """``[(begin, end), ...]``: the contiguous slots of each split, as the
    kernel's blocks take them (split r: ``[r S / n, (r + 1) S / n)``)."""
    return [(r * S // n_split, (r + 1) * S // n_split)
            for r in range(n_split)]


def merge_split_states(ms, ls, accs) -> torch.Tensor:
    """The splits' states merged as the kernels' cluster merge does: each
    split's max ``m_r``, sum ``l_r`` and accumulator ``acc_r`` (relative to
    ``exp(m_r)``; ``m_r = -inf`` for a split with no valid slot) weighted
    by ``exp(m_r - max_r m_r)``, so an empty split weighs 0; a row with no
    valid slot at all gives 0.  Returns ``acc / l`` in f32."""
    zero = torch.zeros((), dtype=torch.float32, device=ms[0].device)
    mx = torch.stack(ms).amax(dim=0)
    base = torch.where(mx == float("-inf"), zero, mx)
    w = [torch.exp(m - base) for m in ms]          # 0 for an empty split
    l = sum(li * wi for li, wi in zip(ls, w))
    acc = sum(ai * wi for ai, wi in zip(accs, w))
    return torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)),
                       zero)


def decode_attention_split_plain(q, k, v, kv_valid, kv_positions,
                                 q_positions, *,
                                 sliding_window: Optional[int] = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None,
                                 n_split: Optional[int] = None
                                 ) -> torch.Tensor:
    """The kernel's split and merge in PyTorch: each split's (max, sum,
    accumulator) over its own slots, then the states merged with weights
    ``exp(m_r - max_r m_r)``; a split with no valid slot weighs 0 and a row
    with none at all gives 0.  ``n_split`` defaults to the kernel's rule
    (:func:`decode_splits`).  For tests."""
    if k.dtype == torch.int8:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    n = decode_splits(B, Hkv, S) if n_split is None else n_split
    qg = q.float().reshape(B, Hkv, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (Dh ** -0.5)
    rel = q_positions[:, None] - kv_positions                      # (B, S)
    ok = kv_valid.bool() & (rel >= 0)
    if sliding_window:
        ok = ok & (rel < sliding_window)
    s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    ms, ls, accs = [], [], []
    for a, e in split_ranges(S, n):
        part = s[..., a:e]
        m = part.amax(dim=-1, keepdim=True) if e > a \
            else torch.full((B, Hkv, G, 1), float("-inf"), device=q.device)
        base = torch.where(m == float("-inf"), zero, m)
        p = torch.exp(part - base)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype),
                                 v[:, a:e]).float())
    return merge_split_states(ms, ls, accs).reshape(B, H, Dh).to(q.dtype)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(q, k, v, kv_valid, kv_positions, q_positions, window,
            k_scale=None, v_scale=None, n_split=None):
    """The kernel launch; ``n_split`` (1 to 8) overrides
    :func:`decode_splits` for the tests and the split sweep."""
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
    if n_split is None:
        n_split = decode_splits(B, Hkv, S, _sm_count(q.device.index or 0))
    if not 1 <= n_split <= MAX_SPLIT:
        raise ValueError(f"decode_attention: n_split={n_split} is not in "
                         f"1..{MAX_SPLIT}")
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
            out.data_ptr(), B, H, Hkv, S, Dh, n_split, q.stride(0),
            q.stride(1), *k.stride()[:3], *v.stride()[:3], *k_scale.stride(),
            valid.stride(0), kv_pos.stride(0), int(window), Dh ** -0.5,
            _kernels.stream_ptr(q.device))
        _kernels.check("m3_decode_attention_int8", err)
        _kernels.count_launch(flash_decode_attention)
        return out
    err = _kernels.library().m3_decode_attention(
        _kernels.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), valid.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), B, H, Hkv, S, Dh, n_split, q.stride(0), q.stride(1),
        *k.stride()[:3], *v.stride()[:3], valid.stride(0), kv_pos.stride(0),
        int(window), Dh ** -0.5, _kernels.stream_ptr(q.device))
    _kernels.check("m3_decode_attention", err)
    _kernels.count_launch(flash_decode_attention)
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
    """-> (B, H, Dh) attention output in ``q.dtype``; on the card the
    slots are split as :func:`decode_splits` says.
    ``flash_decode_attention.launches`` counts kernel launches, one a
    call."""
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
