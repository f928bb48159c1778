"""Prefill flash attention, forward and backward: the hand-written CUDA
kernels ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` and
their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``matryoshka_mm_tpu/ops/flash_attention.py``:
``_fwd_kernel`` / ``_fwd_call`` behind ``flash_attention`` and
``flash_attention_lse``, and ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` /
``_bwd_call`` behind the custom VJP ``_flash`` / ``_flash_fwd`` /
``_flash_bwd``.  Same function: tiled online softmax with f32 state,
index-based causality with ``q_index_offset``, a ``kv_valid`` mask, a
sliding window, GQA by head mapping (no K/V expansion), and the natural-log
``lse``.  A row with no valid key returns 0 (lse ``-1e30``) and passes no
gradient.

:func:`flash_attention` is differentiable through a
``torch.autograd.Function`` whose backward launches the dQ and the dK/dV
kernel; :func:`flash_attention_lse` stays non-differentiable, as in JAX.

What bounds them on the H100: arithmetic.  A 7B prefill layer does
``4 * B * H * Sq * Sk_seen * Dh`` FLOPs forward (QK^T and PV) and
``14 * B * H * Sq * Sk_seen * Dh`` backward (QK^T and dO V^T recomputed in
both kernels, then dQ, dV and dK) over tiles that each block reads once
into shared memory, so bytes are small beside the math.

The forward kernel, for bfloat16 operands, does both products on the tensor
cores with the building blocks of the backward's dQ kernel: a block of four
warps owns 64 query rows of one head and keeps their Q fragments, running
max and sum and f32 output accumulator in registers; per 64-key kv tile it
computes ``S = Q K^T``, runs the online softmax in the exp2 domain on the S
fragments (row max and sum over the four lanes of a row), rounds ``P`` to
bf16 in registers and adds ``P V``.  K and V stream through a two-stage
``cp.async`` ring, the per-element mask runs only on tiles that need it,
and a row that has seen no valid key yet exponentiates against 0, so a row
padded on the left starts cleanly at its first valid tile.
:func:`flash_attention_tiled_plain` walks the same tiles in PyTorch for the
CPU tests.  For float32 operands the forward stays on f32 FMAs (one block
per 64-row q tile, two threads a row).

The backward kernels, for bfloat16 operands, do every product on the tensor
cores (``mma.sync`` m16n8k16, bf16 in, f32 sums; fragments fetched with
``ldmatrix`` from bf16 tiles whose rows are padded by 16 bytes against bank
conflicts).  Four warps own a 64-row tile of the output, 16 rows each, keep
its f32 accumulators in registers and write once (no atomics, the same bits
on every run).  dQ: a block owns 64 query rows of one head, holds their Q
and dO fragments, ``lse`` and ``delta`` in registers and loops over 64-key
kv tiles: ``S = Q K^T``, ``dP = dO V^T``, ``dS`` in registers, ``dQ += dS
K``.  dK/dV: a block owns 64 keys of one kv head (K and V resident in
shared memory), loops over the heads of its query group and the 64-row q
tiles that can see it, with the keys as the rows of every product: ``S^T =
K Q^T``, ``dP^T = V dO^T``, then ``dV += P^T dO`` and ``dK += dS^T Q``.  The
accumulator fragment of the first product, rounded to bf16 pairs, is the A
fragment of the next, so probabilities never leave registers.  The tile a
block loops over streams through a two-stage ``cp.async`` ring (rows past a
sequence's end zero-filled), tiles above the causal diagonal or outside the
window are loop bounds, the per-element mask runs only on tiles that need
it, and blocks go out heaviest first.  :func:`flash_attention_bwd_tiled_plain`
walks the same tiles in PyTorch for the CPU tests.  For float32 operands the
backward stays on f32 FMAs (four threads a row, a quarter of the head dim
each): TF32 tensor cores keep three decimal digits, too few for float32
callers.  ``wgmma`` fed by TMA is the step that remains.

Dispatch: a CPU tensor goes to the plain versions
(:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`), through
the same ``autograd.Function``; a CUDA tensor launches the kernels or raises
on what they do not take (dtype other than float32/bfloat16, ``Dh`` other
than 64/128, a head dim that is not contiguous, unaligned strides).  There
is no fallback.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _kernels

LSE_MASKED = -1e30   # lse of a row with no valid key
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _mask(B, Sq, Sk, kv_valid, causal, sliding_window, q_index_offset, dev):
    """``(B, 1, Sq, Sk)`` bool: the pairs (query row, kv slot) that attend."""
    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=dev)
    if kv_valid is not None:
        mask = mask & kv_valid.bool()[:, None, None, :]
    rows = torch.arange(Sq, device=dev)[:, None] + q_index_offset
    cols = torch.arange(Sk, device=dev)[None, :]
    if causal:
        mask = mask & (cols <= rows)
    if sliding_window:
        mask = mask & (rows - cols < sliding_window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          kv_valid: Optional[torch.Tensor] = None,
                          sliding_window: Optional[int] = None,
                          q_index_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: the whole score matrix
    at once, same masks and numerics (f32 scores, probabilities rounded to
    ``v.dtype`` for the PV product, sum kept in f32)."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = k.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (Dh ** -0.5)
    mask = _mask(B, Sq, Sk, kv_valid, causal, sliding_window, q_index_offset,
                 q.device)
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


TILE = 64   # query rows and keys of a tile of the tensor-core kernels


def _kv_tiles(q0, q1, Sk, kv_valid_b, causal, window, off):
    """The kv tiles that a block of the tensor-core kernels owning query
    rows ``[q0, q1)`` walks: ``(k0, k1, masked)``.  Tiles wholly above the
    causal diagonal or below the window are outside the loop bounds;
    ``masked``: the tile touches the diagonal, the window's edge, the
    ragged end or an invalid slot, so the per-element mask runs on it (on
    the others every pair attends)."""
    q_first, q_last = q0 + off, q1 - 1 + off
    kv_end = min(Sk, q_last + 1) if causal else Sk
    kv_begin = max(0, q_first - window + 1) // TILE * TILE if window else 0
    for k0 in range(kv_begin, kv_end, TILE):
        k1 = min(k0 + TILE, Sk)
        all_valid = k0 + TILE <= Sk and bool(kv_valid_b[k0:k1].all())
        masked = (not all_valid
                  or (causal and k0 + TILE - 1 > q_first)
                  or (window > 0 and q_last - k0 >= window))
        yield k0, k1, masked


def flash_attention_tiled_plain(q, k, v, *, causal: bool = True,
                                kv_valid: Optional[torch.Tensor] = None,
                                sliding_window: Optional[int] = None,
                                q_index_offset: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` computed tile by tile, the way the tensor-core forward
    kernel walks: ``TILE`` query rows at a time over ``TILE``-key tiles,
    the kernel's loop bounds and its rule for which tiles run the
    per-element mask, the online softmax in the exp2 domain in the kernel's
    order (row max, rescale, ``P = exp2(S - m)``, the sum over f32 ``P``,
    ``P`` rounded to ``v.dtype`` for the PV product), a row without a valid
    key so far exponentiating against 0.  For tests: it shows on the CPU
    that bounds, rule and order lose no pair, let no masked one through and
    give 0 and ``lse = -1e30`` on rows without a key."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    off, window = q_index_offset, sliding_window or 0
    c = (Dh ** -0.5) * LOG2E
    if kv_valid is None:
        kv_valid = torch.ones((B, Sk), dtype=torch.bool, device=q.device)
    kv_valid = kv_valid.bool()
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, Sq), LSE_MASKED, dtype=torch.float32,
                     device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    for b in range(B):
        sees = _mask(1, Sq, Sk, kv_valid[b:b + 1], causal, sliding_window,
                     off, q.device)[0]                      # (1, Sq, Sk)
        kb = k[b].float().repeat_interleave(G, dim=0)       # (H, Sk, Dh)
        vb = v[b].repeat_interleave(G, dim=0)
        for q0 in range(0, Sq, TILE):
            q1 = min(q0 + TILE, Sq)
            qt = q[b, :, q0:q1].float()
            m = torch.full((H, q1 - q0), float("-inf"), device=q.device)
            l = torch.zeros((H, q1 - q0), device=q.device)
            acc = torch.zeros((H, q1 - q0, Dh), device=q.device)
            for k0, k1, masked in _kv_tiles(q0, q1, Sk, kv_valid[b], causal,
                                            window, off):
                s = torch.einsum("hqd,hkd->hqk", qt, kb[:, k0:k1]) * c
                if masked:
                    s = torch.where(sees[:, q0:q1, k0:k1], s,
                                    torch.full_like(s, float("-inf")))
                mx = torch.maximum(m, s.amax(dim=-1))
                base = torch.where(mx == float("-inf"), zero, mx)
                alpha = torch.exp2(m - base)
                p = torch.exp2(s - base[..., None])
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "hqk,hkd->hqd", p.to(v.dtype).float(),
                    vb[:, k0:k1].float())
                m = mx
            has = l > 0
            out[b, :, q0:q1] = torch.where(
                has[..., None], acc / torch.where(has, l, 1.0)[..., None],
                zero)
            lse[b, :, q0:q1] = torch.where(
                has, m * LN2 + torch.log(torch.where(has, l, 1.0)),
                torch.full_like(l, LSE_MASKED))
    return out.to(q.dtype), lse


def _bwd_p_ds(q, k, v, kv_valid, out, lse, do, causal, sliding_window,
              q_index_offset):
    """``(p, ds)`` of the backward, both ``(B, H, Sq, Sk)`` f32 and both 0
    off the mask: ``p = exp2(s * scale * log2e - lse * log2e)`` recomputed
    from the saved natural-log ``lse``, ``ds = p * (do . v^T - delta)`` with
    ``delta = rowsum(out * do)``.  The mask is applied by selection, never
    by a product: a row with no valid key has ``lse = -1e30`` and an
    infinite ``exp2``."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    mask = _mask(B, Sq, Sk, kv_valid, causal, sliding_window, q_index_offset,
                 q.device)
    c = (Dh ** -0.5) * LOG2E
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(G, dim=1))
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    p = torch.where(mask, torch.exp2(s * c - lse[..., None] * LOG2E), zero)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(),
                      v.float().repeat_interleave(G, dim=1))
    delta = (out.float() * do.float()).sum(dim=-1, keepdim=True)
    return p, p * (dp - delta)


def flash_attention_bwd_dq_plain(q, k, v, kv_valid, out, lse, do, *,
                                 causal: bool = True,
                                 sliding_window: Optional[int] = None,
                                 q_index_offset: int = 0) -> torch.Tensor:
    """Plain version of the dQ kernel: ``dq = scale * ds . k`` with ``ds``
    rounded to the input dtype first and the sum in f32."""
    G = q.shape[1] // k.shape[1]
    _, ds = _bwd_p_ds(q, k, v, kv_valid, out, lse, do, causal, sliding_window,
                      q_index_offset)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                      k.float().repeat_interleave(G, dim=1))
    return (dq * (q.shape[-1] ** -0.5)).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, kv_valid, out, lse, do, *,
                                  causal: bool = True,
                                  sliding_window: Optional[int] = None,
                                  q_index_offset: int = 0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: ``dv = p^T . do`` (``p`` rounded
    to ``do``'s dtype), ``dk = scale * ds^T . q`` (``ds`` rounded to the
    input dtype), sums in f32 and over the query group of each kv head."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    p, ds = _bwd_p_ds(q, k, v, kv_valid, out, lse, do, causal,
                      sliding_window, q_index_offset)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dv = dv.reshape(B, Hkv, H // Hkv, Sk, Dh).sum(dim=2)
    dk = dk.reshape(B, Hkv, H // Hkv, Sk, Dh).sum(dim=2) * (Dh ** -0.5)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, kv_valid, out, lse, do, **kw):
    """``(dq, dk, dv)`` by the explicit formulas of the two kernels (not
    autograd through the plain forward)."""
    dq = flash_attention_bwd_dq_plain(q, k, v, kv_valid, out, lse, do, **kw)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, kv_valid, out, lse, do,
                                           **kw)
    return dq, dk, dv


def flash_attention_bwd_tiled_plain(q, k, v, kv_valid, out, lse, do, *,
                                    causal: bool = True,
                                    sliding_window: Optional[int] = None,
                                    q_index_offset: int = 0):
    """``(dq, dk, dv)`` computed tile by tile, the way the tensor-core
    kernels walk: ``TILE`` x ``TILE`` tiles, the kernels' loop
    bounds for causality, the window and ``q_index_offset`` (tiles outside
    them are never touched), their rule for which tiles run the per-element
    mask (on the others ``p`` is used without a select), the same bf16
    roundings, GQA summed head by head.  For tests: it shows on the CPU
    that bounds and rule lose no pair and let no masked one through."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G, T = H // Hkv, TILE
    off, window = q_index_offset, sliding_window or 0
    scale = Dh ** -0.5
    c = scale * LOG2E
    if kv_valid is None:
        kv_valid = torch.ones((B, Sk), dtype=torch.bool, device=q.device)
    kv_valid = kv_valid.bool()
    delta = (out.float() * do.float()).sum(dim=-1)          # (B, H, Sq)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)

    def p_ds(qt, kt, vt, dot, lse_t, delta_t, ok, masked):
        """(p, ds) of one pair of tiles, ``(heads, rows, keys)`` f32."""
        s = torch.einsum("hqd,hkd->hqk", qt.float(), kt.float())
        p = torch.exp2(s * c - lse_t[..., None] * LOG2E)
        if masked:
            p = torch.where(ok, p, zero)
        dp = torch.einsum("hqd,hkd->hqk", dot.float(), vt.float())
        return p, p * (dp - delta_t[..., None])

    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for b in range(B):
        sees = _mask(1, Sq, Sk, kv_valid[b:b + 1], causal, sliding_window,
                     off, q.device)[0]                      # (1, Sq, Sk)
        kb = k[b].repeat_interleave(G, dim=0)               # (H, Sk, Dh)
        vb = v[b].repeat_interleave(G, dim=0)
        # ---- dQ: a block per q tile, a loop over kv tiles ----
        for q0 in range(0, Sq, T):
            q1 = min(q0 + T, Sq)
            for k0, k1, masked in _kv_tiles(q0, q1, Sk, kv_valid[b], causal,
                                            window, off):
                _, ds = p_ds(q[b, :, q0:q1], kb[:, k0:k1], vb[:, k0:k1],
                             do[b, :, q0:q1], lse[b, :, q0:q1],
                             delta[b, :, q0:q1], sees[:, q0:q1, k0:k1],
                             masked)
                dq[b, :, q0:q1] += torch.einsum(
                    "hqk,hkd->hqd", ds.to(k.dtype).float(),
                    kb[:, k0:k1].float())
        # ---- dK/dV: a block per kv tile, a loop over the group's heads
        # and the q tiles that can see it ----
        for k0 in range(0, Sk, T):
            k1 = min(k0 + T, Sk)
            keys_all = k0 + T <= Sk and bool(kv_valid[b, k0:k1].all())
            q_begin = max(0, k0 - off) // T * T if causal else 0
            q_end = max(0, min(Sq, k1 - 1 + window - off)) if window else Sq
            for g in range(G):
                heads = slice(g, H, G)        # head hk * G + g of each hk
                for q0 in range(q_begin, q_end, T):
                    q1 = min(q0 + T, Sq)
                    masked = (not keys_all or q0 + T > Sq
                              or (causal and k0 + T - 1 > q0 + off)
                              or (window > 0
                                  and q0 + T - 1 + off - k0 >= window))
                    p, ds = p_ds(q[b, heads, q0:q1], k[b, :, k0:k1],
                                 v[b, :, k0:k1], do[b, heads, q0:q1],
                                 lse[b, heads, q0:q1], delta[b, heads, q0:q1],
                                 sees[:, q0:q1, k0:k1], masked)
                    dv[b, :, k0:k1] += torch.einsum(
                        "hqk,hqd->hkd", p.to(do.dtype).float(),
                        do[b, heads, q0:q1].float())
                    dk[b, :, k0:k1] += torch.einsum(
                        "hqk,hqd->hkd", ds.to(q.dtype).float(),
                        q[b, heads, q0:q1].float())
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def _operand_ok(t: torch.Tensor) -> bool:
    """A contiguous head dim and 16-byte aligned rows."""
    vec = 16 // t.element_size()
    return t.stride(-1) == 1 and not any(s % vec for s in t.stride()[:-1]) \
        and t.data_ptr() % 16 == 0


def _check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                   device: torch.device) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}"
                         f", expected {dtype} on {device}")
    if not _operand_ok(t):
        raise ValueError(f"flash_attention: {name} needs a contiguous head "
                         f"dim and 16-byte aligned rows, got strides "
                         f"{t.stride()}")


def _check_shapes(q, k, v, kv_valid):
    """Raise on what the kernels do not take; returns ``kv_valid`` as a
    contiguous ``(B, Sk)`` bool tensor on q's device."""
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
    return kv_valid


def _launch(q, k, v, kv_valid, causal, window, q_offset):
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kv_valid = _check_shapes(q, k, v, kv_valid)
    out = torch.empty((B, H, Sq, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _kernels.library().m3_flash_attention_fwd(
        _kernels.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), kv_valid.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, H, Hkv, Sq, Sk, Dh, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], kv_valid.stride(0), int(causal), int(window),
        int(q_offset), Dh ** -0.5, _kernels.stream_ptr(q.device))
    _kernels.check("m3_flash_attention_fwd", err)
    _kernels.count_launch(flash_attention_lse)
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
    Not differentiable.  ``flash_attention_lse.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        with torch.no_grad():
            return flash_attention_plain(
                q, k, v, causal=causal, kv_valid=kv_valid,
                sliding_window=sliding_window, q_index_offset=q_index_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return _launch(q, k, v, kv_valid, causal, sliding_window or 0,
                   q_index_offset)


flash_attention_lse.launches = 0


def _bwd_operands(q, k, v, kv_valid, out, lse, do):
    """Checked operands of a backward launch: ``do`` in whatever layout
    autograd handed over is made contiguous where the kernels cannot read
    it; ``delta = rowsum(out * do)`` in f32."""
    kv_valid = _check_shapes(q, k, v, kv_valid)
    B, H, Sq, Dh = q.shape
    if do.shape != q.shape or out.shape != q.shape \
            or lse.shape != (B, H, Sq):
        raise ValueError(f"flash_attention backward: do {tuple(do.shape)} "
                         f"out {tuple(out.shape)} lse {tuple(lse.shape)} for "
                         f"q {tuple(q.shape)}")
    if do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_attention backward: do is {do.dtype} on "
                         f"{do.device}, expected {q.dtype} on {q.device}")
    if not _operand_ok(do):
        do = do.contiguous()
    lse = lse.to(torch.float32).contiguous()
    # f32 products of the two, summed in f32: one f32 copy of `out` (a copy
    # also where it is float32 already) multiplied in place by `do`, which
    # is widened inside the multiply
    delta = out.to(torch.float32, copy=True).mul_(do).sum(dim=-1).contiguous()
    return kv_valid, lse, delta, do


def _bwd_args(q, k, v, kv_valid, do, lse, delta, outs, causal, window,
              q_offset):
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    return (_kernels.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), kv_valid.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outs), B, H, Hkv, Sq,
            Sk, Dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], kv_valid.stride(0), int(causal), int(window),
            int(q_offset), Dh ** -0.5, _kernels.stream_ptr(q.device))


def _launch_dq(q, k, v, kv_valid, do, lse, delta, causal, window, q_offset):
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _kernels.library().m3_flash_attention_bwd_dq(*_bwd_args(
        q, k, v, kv_valid, do, lse, delta, (dq,), causal, window, q_offset))
    _kernels.check("m3_flash_attention_bwd_dq", err)
    _kernels.count_launch(flash_attention_bwd_dq)
    return dq


def _launch_dkv(q, k, v, kv_valid, do, lse, delta, causal, window, q_offset):
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _kernels.library().m3_flash_attention_bwd_dkv(*_bwd_args(
        q, k, v, kv_valid, do, lse, delta, (dk, dv), causal, window,
        q_offset))
    _kernels.check("m3_flash_attention_bwd_dkv", err)
    _kernels.count_launch(flash_attention_bwd_dkv)
    return dk, dv


def _bwd_dispatch(plain, launch, q, k, v, kv_valid, out, lse, do, causal,
                  sliding_window, q_index_offset):
    if q.device.type == "cpu":
        return plain(q, k, v, kv_valid, out, lse, do, causal=causal,
                     sliding_window=sliding_window,
                     q_index_offset=q_index_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    kv_valid, lse, delta, do = _bwd_operands(q, k, v, kv_valid, out, lse, do)
    return launch(q, k, v, kv_valid, do, lse, delta, causal,
                  sliding_window or 0, q_index_offset)


def flash_attention_bwd_dq(q, k, v, kv_valid, out, lse, do, *,
                           causal: bool = True,
                           sliding_window: Optional[int] = None,
                           q_index_offset: int = 0) -> torch.Tensor:
    """``dq (B, H, Sq, Dh)`` from the forward's operands, its ``out`` and
    ``lse`` and the output gradient ``do``.
    ``flash_attention_bwd_dq.launches`` counts kernel launches."""
    return _bwd_dispatch(flash_attention_bwd_dq_plain, _launch_dq, q, k, v,
                         kv_valid, out, lse, do, causal, sliding_window,
                         q_index_offset)


def flash_attention_bwd_dkv(q, k, v, kv_valid, out, lse, do, *,
                            causal: bool = True,
                            sliding_window: Optional[int] = None,
                            q_index_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``, each ``(B, Hkv, Sk, Dh)``, summed over the query group
    of each kv head.  ``flash_attention_bwd_dkv.launches`` counts kernel
    launches."""
    return _bwd_dispatch(flash_attention_bwd_dkv_plain, _launch_dkv, q, k, v,
                         kv_valid, out, lse, do, causal, sliding_window,
                         q_index_offset)


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, kv_valid, out, lse, do, *,
                        causal: bool = True,
                        sliding_window: Optional[int] = None,
                        q_index_offset: int = 0):
    """``(dq, dk, dv)``: both backward kernels on a CUDA tensor (``delta``
    and the operand checks shared), both plain versions on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, kv_valid, out, lse, do, causal=causal,
            sliding_window=sliding_window, q_index_offset=q_index_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    kv_valid, lse, delta, do = _bwd_operands(q, k, v, kv_valid, out, lse, do)
    args = (q, k, v, kv_valid, do, lse, delta, causal, sliding_window or 0,
            q_index_offset)
    return (_launch_dq(*args), *_launch_dkv(*args))


class FlashResiduals:
    """``out`` and ``lse`` of one flash forward, kept by the caller across
    a recompute of the layer around it (the ``flash_out`` / ``flash_lse``
    names of the JAX remat policy): the first forward that is handed an
    empty holder fills it, and a later forward handed the same holder
    returns what it holds instead of launching the kernel again."""

    __slots__ = ("out", "lse")

    def __init__(self):
        self.out = self.lse = None


class _FlashAttention(torch.autograd.Function):
    """The port of the JAX custom VJP ``_flash``: forward through
    :func:`flash_attention_lse`, backward through
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, sliding_window,
                q_index_offset, residuals):
        if residuals is not None and residuals.out is not None:
            out, lse = residuals.out.detach(), residuals.lse
        else:
            out, lse = flash_attention_lse(
                q, k, v, causal=causal, kv_valid=kv_valid,
                sliding_window=sliding_window, q_index_offset=q_index_offset)
            if residuals is not None:
                residuals.out, residuals.lse = out.detach(), lse
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.masks = (causal, sliding_window, q_index_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        causal, sliding_window, q_index_offset = ctx.masks
        dq, dk, dv = flash_attention_bwd(
            q, k, v, kv_valid, out, lse, do, causal=causal,
            sliding_window=sliding_window, q_index_offset=q_index_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_positions=None,
                    kv_positions=None, kv_valid=None, sliding_window=None,
                    q_index_offset: int = 0,
                    residuals: Optional[FlashResiduals] = None
                    ) -> torch.Tensor:
    """Flash attention with a padding mask and index-based causality,
    differentiable in q, k and v.  ``q_positions`` / ``kv_positions`` are
    accepted for signature parity with the JAX function and not read:
    per-row positions are monotone in the sequence index on every layout
    the splice and cache produce.  ``residuals``: see
    :class:`FlashResiduals`."""
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if not needs_grad and residuals is None:
        return flash_attention_lse(
            q, k, v, causal=causal, kv_valid=kv_valid,
            sliding_window=sliding_window, q_index_offset=q_index_offset)[0]
    return _FlashAttention.apply(q, k, v, kv_valid, causal, sliding_window,
                                 q_index_offset, residuals)
