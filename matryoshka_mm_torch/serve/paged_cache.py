"""Paged KV cache, PyTorch port of ``matryoshka_mm_tpu/serve/paged_cache.py``
for ``arch="llama"``.

Instead of one fixed ``(B, capacity)`` cache region per pool, KV storage is a
flat pool of fixed-size **pages**; each request maps its logical token
positions onto pages through a per-row page table.

* :class:`PagedKVCache`: ``(n_layers, n_pages, page_size, n_kv, Dh)`` K/V
  pools, **updated in place** by every function here (the JAX package
  returned new pools from donated jits; each function still returns the
  cache it was given, advanced).  int8 pools carry f32 scales
  ``(n_layers, n_pages, page_size, n_kv)``: the bytes of the JAX package's
  flat ``(n_layers, n_pages, page_size * n_kv)``, whose flat form only
  served the TPU compiler.
* :class:`PageAllocator`: host-side free list and per-row tables; page 0 is
  reserved as the trash page.
* :func:`paged_decode_step` / :func:`paged_pool_decode` /
  :func:`paged_spec_verify`: batched decode over the pool.  A single-token
  step attends through the paged-attention kernel
  (``ops/paged_attention.py``) when ``use_kernel`` is true; a multi-token
  verify block, and ``use_kernel=False``, gather each row's pages and use
  the plain attention.
* :func:`import_prefill` / :func:`import_prefill_group` /
  :func:`import_dense_cache` scatter a prefill's dense cache into pages.

**Inactive rows write to the trash page.**  The JAX package pushed their
scatter index out of bounds and let XLA drop the write; an out-of-range
index is a device assert in CUDA, so their page id becomes 0, which no
live row owns and no table of a live row lists below its length.  A retired
row whose table was recycled therefore cannot clobber a live row.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import LlamaConfig, torch_dtype
from ..models.llama import (KVCache, _mlp, apply_rope, embed_tokens, lm_head,
                            proj, rms_norm, rope_cos_sin)
from ..ops.attention import attention_reference
from ..ops.paged_attention import paged_decode_attention
from ..ops.quant import _quantize_kv_slots


@dataclasses.dataclass
class PagedKVCache:
    """K/V page pools of all layers, updated in place."""

    k: torch.Tensor   # (n_layers, n_pages, page_size, n_kv, Dh)
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # (n_layers, n_pages, page, n_kv)
    v_scale: Optional[torch.Tensor] = None  # f32, int8 pools only

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def init_paged_cache(cfg: LlamaConfig, n_pages: int, page_size: int, *,
                     device, dtype: Optional[torch.dtype] = None
                     ) -> PagedKVCache:
    dtype = dtype or (torch.int8 if cfg.kv_cache_dtype == "int8"
                      else torch_dtype(cfg.dtype))
    shape = (cfg.num_hidden_layers, n_pages, page_size,
             cfg.num_key_value_heads, cfg.head_dim)

    def scales():
        return torch.zeros(shape[:4], dtype=torch.float32, device=device) \
            if dtype == torch.int8 else None

    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device),
                        scales(), scales())


def _check_dense_dtype(paged: PagedKVCache, dense: KVCache) -> None:
    """A float page pool cannot absorb an int8 dense cache: the per-slot
    scales would be dropped."""
    if paged.k_scale is None and dense.k_scale is not None:
        raise ValueError(
            "cannot import an int8 dense KV cache into a float page pool: "
            "the per-slot dequant scales would be dropped; build the pool "
            "with kv_cache_dtype='int8' or dequantize the dense cache first")


class PageAllocator:
    """Host-side page bookkeeping (free list + per-row tables)."""

    def __init__(self, n_pages: int, page_size: int, max_rows: int,
                 max_pages_per_row: int):
        self.page_size = page_size
        self.max_pages_per_row = max_pages_per_row
        # Page 0 is RESERVED as a trash page and never handed out: it is
        # the placeholder in unallocated table slots and the target of
        # inactive rows' writes, so a row that overruns its allocation
        # scatters into dead storage instead of a page the free list may
        # have given a live request.
        self.free: List[int] = list(range(1, n_pages))
        self.n_allocatable = n_pages - 1
        self.tables = np.full((max_rows, max_pages_per_row), 0, np.int32)
        self.n_alloc = np.zeros(max_rows, np.int32)

    def allocate_row(self, row: int, n_tokens: int, headroom: int = 0) -> bool:
        need = -(-(n_tokens + headroom) // self.page_size)
        if need > self.max_pages_per_row or len(self.free) < need:
            return False
        self.tables[row, :] = 0
        for i in range(need):
            self.tables[row, i] = self.free.pop()
        self.n_alloc[row] = need
        return True

    def extend_row(self, row: int) -> bool:
        if (self.n_alloc[row] >= self.max_pages_per_row
                or not self.free):
            return False
        self.tables[row, self.n_alloc[row]] = self.free.pop()
        self.n_alloc[row] += 1
        return True

    def capacity(self, row: int) -> int:
        return int(self.n_alloc[row]) * self.page_size

    def free_row(self, row: int):
        for i in range(int(self.n_alloc[row])):
            self.free.append(int(self.tables[row, i]))
        self.n_alloc[row] = 0
        self.tables[row, :] = 0


# ---------------------------------------------------------------------------
# dense -> paged imports
# ---------------------------------------------------------------------------

def _page_ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, np.int64), device=device)


def _scatter_pages(paged: PagedKVCache, idx: torch.Tensor, k_pages, v_pages,
                   ks, vs) -> PagedKVCache:
    """Write ``(n_layers, n, page, n_kv, Dh)`` pages (and their scales) at
    page ids ``idx (n,)``; a float page block is quantized for an int8
    pool."""
    if paged.k_scale is not None and ks is None:
        k_pages, ks = _quantize_kv_slots(k_pages)
        v_pages, vs = _quantize_kv_slots(v_pages)
    paged.k.index_copy_(1, idx, k_pages.to(paged.k.dtype))
    paged.v.index_copy_(1, idx, v_pages.to(paged.v.dtype))
    if paged.k_scale is not None:
        paged.k_scale.index_copy_(1, idx, ks)
        paged.v_scale.index_copy_(1, idx, vs)
    return paged


def import_dense_cache(paged: PagedKVCache, dense: KVCache, row_table,
                       page_size: int) -> PagedKVCache:
    """Scatter a solo (B=1) dense prefill cache into a row's pages.

    ``dense.k``: (n_layers, 1, S, n_kv, Dh) with S a multiple of page_size;
    ``row_table``: page ids for S / page_size pages (numpy)."""
    _check_dense_dtype(paged, dense)
    n_layers, _, S, n_kv, Dh = dense.k.shape
    n_p = S // page_size
    shape = (n_layers, n_p, page_size, n_kv)
    ks = vs = None
    if dense.k_scale is not None:
        ks = dense.k_scale[:, 0].reshape(shape)
        vs = dense.v_scale[:, 0].reshape(shape)
    return _scatter_pages(
        paged, _page_ids(row_table[:n_p], dense.k.device),
        dense.k[:, 0].reshape(shape + (Dh,)),
        dense.v[:, 0].reshape(shape + (Dh,)), ks, vs)


@torch.inference_mode()
def import_prefill_group(paged: PagedKVCache, dense: KVCache, pads,
                         row_tables, page_size: int) -> PagedKVCache:
    """Compact the ``G`` left-padded rows of one batched prefill cache into
    their pages.

    Row ``g`` of ``dense`` holds its valid tokens in slots ``[pads[g],
    S)``; after compaction token ``i`` lands in page ``i // page_size`` of
    ``row_tables[g]`` at offset ``i % page_size``.  ``row_tables`` is
    ``(G, n_pt)`` page ids (numpy); ``min(n_pt, S // page_size)`` pages are
    written per row, the slots past a row's tokens holding the wrapped-round
    left pad (masked by ``row_len`` at decode time), and entries that are
    the trash page 0 (a row whose allocation is shorter, or failed) scatter
    into dead storage."""
    _check_dense_dtype(paged, dense)
    tables = np.asarray(row_tables, np.int32)
    G, n_pt = tables.shape
    n_layers, _, S, n_kv, Dh = dense.k.shape
    n_pt = min(n_pt, S // page_size)
    dev = dense.k.device
    src = (torch.as_tensor(np.asarray(pads, np.int64), device=dev)[:, None]
           + torch.arange(n_pt * page_size, device=dev)[None]) % S   # (G, T)
    rows = torch.arange(G, device=dev)[:, None]
    shape = (n_layers, G * n_pt, page_size, n_kv)

    def compact(x):
        return x[:, rows, src].reshape(shape + x.shape[4:])

    ks = vs = None
    if dense.k_scale is not None:
        ks, vs = compact(dense.k_scale), compact(dense.v_scale)
    return _scatter_pages(paged, _page_ids(tables[:, :n_pt].reshape(-1), dev),
                          compact(dense.k), compact(dense.v), ks, vs)


def import_prefill(paged: PagedKVCache, dense: KVCache, pad: int, row_table,
                   n_p: int, page_size: int) -> PagedKVCache:
    """Compact a left-padded solo (B=1) prefill cache into a row's first
    ``n_p`` pages: :func:`import_prefill_group` for one row."""
    return import_prefill_group(
        paged, dense, [pad], np.asarray(row_table, np.int32)[None, :n_p],
        page_size)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _resolve_use_kernel(use_kernel: Optional[bool], cfg: LlamaConfig,
                        device: torch.device) -> bool:
    """``None`` means "the tensors are on a CUDA device".  The paged kernel
    attends the whole row, so a sliding-window config that resolves to the
    kernel raises; ``use_kernel=False`` picks the gather path, which masks
    the slots older than the window."""
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    if use_kernel and cfg.sliding_window:
        raise NotImplementedError(
            f"sliding_window={cfg.sliding_window}: the paged attention "
            f"kernel has no window mask; pass use_kernel=False for the "
            f"gather path (ROADMAP.md Queue 1, item 2)")
    return bool(use_kernel)


def _decode_core(params: dict, cfg: LlamaConfig, paged: PagedKVCache,
                 tables: torch.Tensor, row_len: torch.Tensor,
                 tokens: torch.Tensor, active: torch.Tensor, *,
                 use_kernel: bool) -> torch.Tensor:
    """One batched paged decode step -> logits ``(B, S, V)`` f32; the pools
    advance in place.

    ``tokens`` is ``(B,)``, one decode token per row, or ``(B, S)`` for a
    speculative verify block: all S tokens' K/V land in the row's pages at
    slots ``[row_len, row_len + S)`` and every position's logits come back;
    causality inside the block rides the position mask.  Rejected drafts
    need no rewind: ``row_len`` only advances over the accepted prefix, so
    stale slots beyond it are masked and overwritten by the next write.

    Inactive rows read nothing that counts (their output is discarded) and
    write to the trash page 0."""
    if cfg.arch != "llama":
        raise NotImplementedError(
            f"arch={cfg.arch!r}: the paged decode is ported for 'llama' only "
            f"(Mistral and MPT: ROADMAP.md Queue 1, item 2)")
    tokens = tokens if tokens.dim() == 2 else tokens[:, None]
    B, S = tokens.shape
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    dev = tokens.device
    page_size = paged.page_size
    max_pages = tables.shape[1]
    S_virt = max_pages * page_size
    use_kernel = use_kernel and S == 1
    tables32 = tables
    tables = tables.long()
    row_len = row_len.long()

    hidden = embed_tokens(params, tokens)                       # (B, S, D)
    pos = row_len[:, None] + torch.arange(S, device=dev)[None]  # (B, S)
    cos, sin = rope_cos_sin(pos, Dh, cfg.rope_theta)

    w_page = torch.clamp(pos // page_size, max=max_pages - 1)
    w_off = pos % page_size
    w_page_id = tables.gather(1, w_page)
    w_page_id = torch.where(active[:, None], w_page_id,
                            torch.zeros_like(w_page_id))        # trash page
    int8 = paged.k_scale is not None

    if use_kernel:
        # retired rows get a 1-slot attention whose output is discarded
        eff_len = torch.where(active, row_len, torch.zeros_like(row_len)) \
            .to(torch.int32)
        tables32 = tables32.to(torch.int32)
    else:
        kv_pos = torch.arange(S_virt, device=dev)[None]
        kv_valid = (kv_pos < (row_len + S)[:, None]) & active[:, None]

    def gather_rows(pool, s_pool):
        """This batch's rows of one layer's pool as (B, Hkv, S_virt, Dh);
        int8 pages dequantize right after the gather."""
        rows = pool[tables].reshape(B, S_virt, Hkv, Dh)
        if int8:
            rows = (rows.float() * s_pool[tables].reshape(B, S_virt, Hkv, 1)
                    ).to(hidden.dtype)
        return rows.transpose(1, 2)

    for l, lp in enumerate(params["layers"]):
        a = lp["self_attn"]
        x = rms_norm(hidden, lp["input_layernorm"], cfg.rms_norm_eps)
        if "qkv_proj" in a:
            q, k, v = proj(x, a["qkv_proj"]).split(
                [H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
        else:
            q, k, v = (proj(x, a[n]) for n in ("q_proj", "k_proj", "v_proj"))
        q = apply_rope(q.reshape(B, S, H, Dh).transpose(1, 2), cos, sin)
        k = apply_rope(k.reshape(B, S, Hkv, Dh).transpose(1, 2), cos, sin)
        k = k.transpose(1, 2)                                # (B, S, Hkv, Dh)
        v = v.reshape(B, S, Hkv, Dh)

        # the new tokens' K/V into each row's page slots of this layer
        kl, vl = paged.k[l], paged.v[l]
        if int8:
            k, ks = _quantize_kv_slots(k)
            v, vs = _quantize_kv_slots(v)
            paged.k_scale[l].index_put_((w_page_id, w_off), ks)
            paged.v_scale[l].index_put_((w_page_id, w_off), vs)
        kl.index_put_((w_page_id, w_off), k.to(kl.dtype))
        vl.index_put_((w_page_id, w_off), v.to(vl.dtype))

        if use_kernel:
            attn = paged_decode_attention(
                q[:, :, 0], kl, vl, tables32, eff_len,
                paged.k_scale[l] if int8 else None,
                paged.v_scale[l] if int8 else None).reshape(B, 1, H * Dh)
        else:
            attn = attention_reference(
                q, gather_rows(kl, paged.k_scale[l] if int8 else None),
                gather_rows(vl, paged.v_scale[l] if int8 else None),
                causal=True, q_positions=pos, kv_positions=kv_pos,
                kv_valid=kv_valid,
                sliding_window=cfg.sliding_window or None)
            attn = attn.transpose(1, 2).reshape(B, S, H * Dh)
        hidden = hidden + proj(attn, a["o_proj"])
        x = rms_norm(hidden, lp["post_attention_layernorm"], cfg.rms_norm_eps)
        hidden = hidden + _mlp(lp["mlp"], x)

    hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    return lm_head(params, hidden)


@torch.inference_mode()
def paged_decode_step(params: dict, cfg: LlamaConfig, paged: PagedKVCache,
                      tables: torch.Tensor, row_len: torch.Tensor,
                      tokens: torch.Tensor, active: torch.Tensor,
                      page_size: int, use_kernel: Optional[bool] = None
                      ) -> Tuple[PagedKVCache, torch.Tensor]:
    """One decode step for every active row -> ``(paged, logits (B, V))``.
    ``params`` is the decoder's tree (``params["llama"]`` of a model);
    ``use_kernel=None`` takes the paged-attention kernel when the tensors
    lie on a CUDA device, ``False`` the gather path."""
    if page_size != paged.page_size:
        raise ValueError(f"page_size={page_size} but the pool's pages hold "
                         f"{paged.page_size} slots")
    logits = _decode_core(
        params, cfg, paged, tables, row_len, tokens, active,
        use_kernel=_resolve_use_kernel(use_kernel, cfg, tokens.device))
    return paged, logits[:, 0]


@dataclasses.dataclass
class PoolState:
    """Per-row decode state of a pool, all ``(max_batch,)`` device tensors.
    The decode functions return a NEW state and never write into the
    tensors of the one they were given."""

    tokens: torch.Tensor      # int32: the token each row feeds next
    lengths: torch.Tensor     # int32: tokens stored per row
    budget: torch.Tensor      # int32: tokens a row may still emit
    active: torch.Tensor      # bool
    fsm_state: Optional[torch.Tensor] = None   # int64: DFA row per slot


@torch.inference_mode()
def paged_pool_decode(params: dict, cfg: LlamaConfig, gen_cfg, steps: int,
                      paged: PagedKVCache, tables: torch.Tensor,
                      state: PoolState, *, use_kernel: bool,
                      generator: Optional[torch.Generator] = None,
                      fsm_allow: Optional[torch.Tensor] = None,
                      fsm_trans: Optional[torch.Tensor] = None
                      ) -> Tuple[PoolState, torch.Tensor]:
    """``steps`` batched decode steps over a paged pool with sampling, EOS
    and budget -> ``(state, toks (B, steps))``; ``-1`` in ``toks`` marks
    "no token this step" (out of band, so a sampled ``pad_token_id`` still
    reaches the client).  No host sync inside.

    The caller guarantees every active row page capacity for
    ``lengths + steps`` tokens; rows that finish mid-chunk stop writing.

    With ``fsm_allow`` / ``fsm_trans`` (``serve/constrained.py``) each row
    carries a DFA state: the state's allow row masks the logits before the
    token is chosen and the transition table advances it, all on the
    device."""
    from ..generate import _select_token

    fsm = fsm_allow is not None
    token, row_len, budget, active = (state.tokens, state.lengths,
                                      state.budget, state.active)
    fstate = state.fsm_state
    toks = []
    for _ in range(steps):
        logits = _decode_core(params, cfg, paged, tables, row_len, token,
                              active, use_kernel=use_kernel)[:, 0]
        if fsm:
            logits = torch.where(fsm_allow[fstate], logits,
                                 torch.full_like(logits, -1e30))
        nxt = _select_token(logits, gen_cfg, generator)
        if fsm:
            fstate = torch.where(active, fsm_trans[fstate, nxt.long()],
                                 fstate)
        toks.append(torch.where(active, nxt, torch.full_like(nxt, -1)))
        nxt = torch.where(active, nxt,
                          torch.full_like(nxt, gen_cfg.pad_token_id))
        row_len = row_len + active.to(row_len.dtype)
        budget = torch.where(active, budget - 1, budget)
        active = active & (nxt != gen_cfg.eos_token_id) & (budget > 0)
        token = nxt
    return (PoolState(token, row_len, budget, active, fstate),
            torch.stack(toks, dim=1))


@torch.inference_mode()
def paged_spec_verify(params: dict, cfg: LlamaConfig, gen_cfg, k: int,
                      paged: PagedKVCache, tables: torch.Tensor,
                      state: PoolState, drafts: torch.Tensor, *,
                      use_kernel: bool = False
                      ) -> Tuple[PoolState, torch.Tensor, torch.Tensor]:
    """Batched speculative verify over the paged pool (greedy only) ->
    ``(state, out (B, k + 1), n_emit (B,))``.

    One ``k + 1``-token forward scores every row's ``k`` host-proposed draft
    tokens; each row accepts its greedy-consistent draft prefix plus the
    model's own next token, so a step emits 1..k+1 tokens per row (``-1``
    in ``out`` marks lanes not kept).  EOS and budget as in
    :func:`paged_pool_decode`: the EOS token itself is emitted, everything
    after it in the block is dropped, and a row deactivates on EOS or an
    exhausted budget."""
    eos, pad = gen_cfg.eos_token_id, gen_cfg.pad_token_id
    row_len, budget, active = state.lengths, state.budget, state.active
    block = torch.cat([state.tokens[:, None], drafts], dim=1)   # (B, k + 1)
    logits = _decode_core(params, cfg, paged, tables, row_len, block, active,
                          use_kernel=use_kernel)
    greedy = logits.argmax(dim=-1).to(torch.int32)              # (B, k + 1)

    match = drafts == greedy[:, :k]
    n_acc = torch.where(match.all(dim=1),
                        torch.full_like(row_len, k),
                        (~match).int().argmax(dim=1).to(row_len.dtype))
    j = torch.arange(k + 1, device=block.device)[None]
    is_eos = greedy == eos
    eos_before = is_eos.int().cumsum(dim=1) - is_eos.int()
    keep = ((j <= n_acc[:, None]) & (eos_before == 0)
            & (j < budget[:, None]) & active[:, None])
    n_emit = keep.sum(dim=1).to(row_len.dtype)
    out = torch.where(keep, greedy, torch.full_like(greedy, -1))

    row_len = row_len + n_emit
    budget = budget - n_emit
    active = (active & ~(keep & is_eos).any(dim=1) & (budget > 0)
              & (n_emit > 0))
    nxt = greedy.gather(1, torch.clamp(n_emit - 1, 0, k).long()[:, None])[:, 0]
    nxt = torch.where(active, nxt, torch.full_like(nxt, pad))
    return (PoolState(nxt, row_len, budget, active, state.fsm_state), out,
            n_emit)
