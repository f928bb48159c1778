"""Paged decode attention: one query token per row over that row's KV pages,
read in place through its page table.  The hand-written CUDA kernel
``csrc/paged_attention.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernels ``matryoshka_mm_tpu/ops/paged_attention.py``
``paged_decode_attention`` and ``paged_decode_attention_stacked`` (same
arguments).  For row ``b``, ``seq_len = row_len[b] + 1`` (the new token is
already in its slot): f32 logits ``q . k[t] * Dh**-0.5`` over the slots
``t < seq_len`` of the row's pages, softmax, ``sum p v``.  GQA inside (the
pools are never expanded).  int8 pools carry f32 per-(slot, kv head) scales
``(n_pages, page, Hkv)`` (the flat ``(n_pages, page * Hkv)`` of the JAX
package is the same bytes and is accepted): the K scale multiplies the
logits and the V scale the probabilities, in f32 (the TPU kernel rounded
``q * scale`` and the scaled probabilities to bf16 for its matrix unit; the
difference is inside the tolerances the tests state).

What bounds it on the H100: bytes, ``2 * seq_len * Hkv * Dh`` pool elements
per row and step for two FLOPs each.  The slots of one (kv head, row) are
split over ``n_split`` blocks of one thread-block cluster (split r walks the
slots ``[r S / n, (r + 1) S / n)``, ``S = seq_len``; :func:`paged_splits`
picks ``n_split`` from the launch geometry and the table's capacity, never
from ``row_len``, which lies on the device), which merge their softmax
states through distributed shared memory; each block serves the whole query
group, stages its K and V rows through a ring of tiles in shared memory
filled with ``cp.async`` so that the next tiles are in flight while one is
reduced, and reads only the pages of its own range.  The reduction is the
dense decode kernel's (``csrc/decode_body.cuh``).
:func:`paged_attention_split_plain` runs the same split and merge in
PyTorch.  Table entries past ``seq_len`` are never read; a used entry
outside the pool, which is an index error in the plain version, makes that
row's output NaN.  Dropped TPU rules: ``page * Hkv % 128``, ``Dh % 128``
(the kernel takes Dh 64 and 128 and query groups of 1/2/4/8).

Dispatch: a CPU tensor goes to :func:`paged_attention_plain`; a CUDA tensor
launches the kernel or raises on what it does not take.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from .decode_attention import (H100_SMS, MAX_SPLIT, _sm_count,
                               merge_split_states)


def _scale_view(scale: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Scales as ``(n_pages, page, Hkv)``, from that shape or the flat
    ``(n_pages, page * Hkv)``."""
    return scale.reshape(pool.shape[:-1])


def paged_attention_plain(q, k_pages, v_pages, page_tables, row_len,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather each row's pages, mask the
    slots past ``row_len + 1``, softmax in f32.  An int8 pool is dequantized
    to f32 with its scales first."""
    B, H, Dh = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = H // Hkv
    tables = page_tables.long()
    k = k_pages[tables]                          # (B, P, page, Hkv, Dh)
    v = v_pages[tables]
    if k_pages.dtype == torch.int8:
        k = k.float() * _scale_view(k_scale, k_pages)[tables][..., None]
        v = v.float() * _scale_view(v_scale, v_pages)[tables][..., None]
    S = tables.shape[1] * page
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    qg = q.float().reshape(B, Hkv, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (Dh ** -0.5)
    ok = torch.arange(S, device=q.device)[None, :] \
        < (row_len.long() + 1)[:, None]                          # (B, S)
    s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v).float()
    out = pv / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(B, H, Dh).to(q.dtype)


SPLIT_MIN_SLOTS = 128  # slots of the table's capacity a split at the least
BLOCKS_PER_SM = 4      # blocks of the launch an SM at the most


def paged_splits(B: int, Hkv: int, P: int, page_size: int,
                 sms: int = H100_SMS) -> int:
    """Blocks over which the kernel splits the slots of one (kv head, row):
    the largest power of two, at most :data:`MAX_SPLIT` (the portable
    cluster size), with which the ``B * Hkv * n_split`` blocks stay within
    :data:`BLOCKS_PER_SM` a SM and every split keeps
    :data:`SPLIT_MIN_SLOTS` slots of the table's capacity ``P *
    page_size``.  Shapes alone: the serving step launches the kernel with
    no host sync, so the rule cannot read ``row_len``, and it takes plain
    ints only.  It changes the order of the f32 sums, never the masks."""
    for name, x in (("B", B), ("Hkv", Hkv), ("P", P),
                    ("page_size", page_size), ("sms", sms)):
        if not isinstance(x, int) or isinstance(x, bool):
            raise TypeError(f"paged_splits: {name} must be an int, got "
                            f"{type(x).__name__}")
    n = 1
    while (2 * n <= MAX_SPLIT and B * Hkv * 2 * n <= BLOCKS_PER_SM * sms
           and P * page_size >= 2 * n * SPLIT_MIN_SLOTS):
        n *= 2
    return n


def paged_attention_split_plain(q, k_pages, v_pages, page_tables, row_len,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None,
                                n_split: Optional[int] = None
                                ) -> torch.Tensor:
    """The kernel's split and merge in PyTorch: row ``b`` attends ``S_b =
    min(row_len[b] + 1, P * page)`` slots, split ``r`` takes ``[r S_b / n,
    (r + 1) S_b / n)`` and keeps its (max, sum, accumulator); the states
    are merged with weights ``exp(m_r - max_r m_r)``, an empty split
    weighing 0.  Like the kernel it reads no table entry past ``S_b`` (they
    may hold anything).  ``n_split`` defaults to :func:`paged_splits`.  For
    tests."""
    B, H, Dh = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = H // Hkv
    tables = page_tables.long()
    P = tables.shape[1]
    S = P * page
    n = paged_splits(B, Hkv, P, page) if n_split is None else n_split
    seq = (row_len.long() + 1).clamp(0, S)                        # (B,)
    used = torch.arange(P, device=q.device)[None] * page < seq[:, None]
    tables = torch.where(used, tables, torch.zeros_like(tables))
    k = k_pages[tables]                          # (B, P, page, Hkv, Dh)
    v = v_pages[tables]
    if k_pages.dtype == torch.int8:
        k = k.float() * _scale_view(k_scale, k_pages)[tables][..., None]
        v = v.float() * _scale_view(v_scale, v_pages)[tables][..., None]
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    qg = q.float().reshape(B, Hkv, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (Dh ** -0.5)
    t = torch.arange(S, device=q.device)[None]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    ms, ls, accs = [], [], []
    for r in range(n):
        lo, hi = r * seq // n, (r + 1) * seq // n
        inside = (t >= lo[:, None]) & (t < hi[:, None])           # (B, S)
        part = s.masked_fill(~inside[:, None, None, :], float("-inf"))
        m = part.amax(dim=-1, keepdim=True)      # -inf for an empty split
        p = torch.exp(part - torch.where(m == float("-inf"), zero, m))
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype),
                                 v).float())
    return merge_split_states(ms, ls, accs).reshape(B, H, Dh).to(q.dtype)


def _launch(q, k_pages, v_pages, page_tables, row_len, k_scale, v_scale,
            n_split=None):
    """The kernel launch; ``n_split`` (1 to 8) overrides
    :func:`paged_splits` for the tests and the split sweep."""
    B, H, Dh = q.shape
    n_pages, page, Hkv, _ = k_pages.shape
    int8 = k_pages.dtype == torch.int8
    kv_dtype = torch.int8 if int8 else q.dtype
    if q.dtype not in _kernels.DTYPE_CODES or Dh not in (64, 128) \
            or H % Hkv or H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"paged_attention kernel takes float32/bfloat16, "
                         f"Dh 64 or 128, query groups of 1/2/4/8; got "
                         f"{q.dtype} Dh={Dh} H={H} Hkv={Hkv}")
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != Dh:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k_pages.shape)} v {tuple(v_pages.shape)}")
    vec = 8 if int8 else 16 // q.element_size()
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or t.dtype != kv_dtype:
            raise ValueError(f"paged_attention: {name} is {t.dtype} on "
                             f"{t.device}, expected {kv_dtype} on {q.device}")
        if t.stride(3) != 1 or t.stride(0) != page * t.stride(1) \
                or t.stride()[1:3] != k_pages.stride()[1:3] \
                or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} needs pages back to "
                             f"back, a contiguous head dim and 16-byte "
                             f"aligned rows, got strides {t.stride()}")
    if q.stride(2) != 1 or any(s % (16 // q.element_size())
                               for s in q.stride()[:2]) or q.data_ptr() % 16:
        raise ValueError(f"paged_attention: q needs a contiguous head dim "
                         f"and 16-byte aligned rows, got strides "
                         f"{q.stride()}")
    tables = page_tables.to(device=q.device, dtype=torch.int32)
    if tables.dim() != 2 or tables.shape[0] != B or tables.stride(1) != 1:
        tables = tables.reshape(B, -1).contiguous()
    P = tables.shape[1]
    if P > 2048:
        raise ValueError(f"paged_attention: at most 2048 pages a row, got "
                         f"{P}")
    lens = row_len.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError("paged_attention: row_len must be (B,)")
    ks_ptr = vs_ptr = 0
    sc_strides = (0, 0)
    if int8:
        scales = []
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.dtype != torch.float32 \
                    or t.device != q.device \
                    or t.numel() != n_pages * page * Hkv:
                raise ValueError(f"paged_attention: an int8 pool needs "
                                 f"float32 {name} of shape "
                                 f"{(n_pages, page, Hkv)}")
            t = _scale_view(t, k_pages)
            if t.stride(0) != page * t.stride(1):
                raise ValueError(f"paged_attention: {name} needs pages "
                                 f"back to back, got strides {t.stride()}")
            scales.append(t)
        if scales[0].stride() != scales[1].stride():
            raise ValueError("paged_attention: k_scale and v_scale need one "
                             "layout")
        ks_ptr, vs_ptr = scales[0].data_ptr(), scales[1].data_ptr()
        sc_strides = scales[0].stride()[1:]
    if n_split is None:
        n_split = paged_splits(B, Hkv, P, page,
                               _sm_count(q.device.index or 0))
    if not 1 <= n_split <= MAX_SPLIT:
        raise ValueError(f"paged_attention: n_split={n_split} is not in "
                         f"1..{MAX_SPLIT}")
    out = torch.empty((B, H, Dh), dtype=q.dtype, device=q.device)
    err = _kernels.library().m3_paged_attention(
        _kernels.DTYPE_CODES[q.dtype], int(int8), q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), ks_ptr, vs_ptr,
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(), B, H, Hkv, P,
        page, n_pages, Dh, n_split, q.stride(0), q.stride(1),
        k_pages.stride(1), k_pages.stride(2), *sc_strides, tables.stride(0), Dh ** -0.5,
        _kernels.stream_ptr(q.device))
    _kernels.check("m3_paged_attention", err)
    _kernels.count_launch(paged_decode_attention)
    return out


def paged_decode_attention(
    q: torch.Tensor,             # (B, H, Dh) current-token queries
    k_pages: torch.Tensor,       # (n_pages, page, Hkv, Dh), e.g. pool.k[l]
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,   # (B, P) int physical page per logical slot
    row_len: torch.Tensor,       # (B,) tokens already stored (excl. current)
    k_scale: Optional[torch.Tensor] = None,  # (n_pages, page, Hkv) f32, int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-> (B, H, Dh) attention output in ``q.dtype``; on the card the
    slots are split as :func:`paged_splits` says.
    ``paged_decode_attention.launches`` counts kernel launches, one a
    call."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_tables,
                                     row_len, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    return _launch(q, k_pages, v_pages, page_tables, row_len, k_scale,
                   v_scale)


paged_decode_attention.launches = 0


def paged_decode_attention_stacked(
    q: torch.Tensor,             # (B, H, Dh)
    k_all: torch.Tensor,         # (L, n_pages, page, Hkv, Dh) stacked pools
    v_all: torch.Tensor,
    layer_idx: int,
    page_tables: torch.Tensor,
    row_len: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # (L, n_pages, page, Hkv) f32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The layer-indexed form of the JAX package.  There it kept XLA from
    copying a layer's pool; a PyTorch layer view is free, so this is
    :func:`paged_decode_attention` on ``k_all[layer_idx]``."""
    l = int(layer_idx)
    return paged_decode_attention(
        q, k_all[l], v_all[l], page_tables, row_len,
        None if k_scale is None else k_scale[l],
        None if v_scale is None else v_scale[l])
