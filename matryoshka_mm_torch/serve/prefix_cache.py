"""Prefix caching for the paged serving pool (radix-lite), PyTorch port of
``matryoshka_mm_tpu/serve/prefix_cache.py``.

The SGLang backend the reference can serve through gets its throughput
from two mechanisms: continuous batching (serve/batching.py) and
RadixAttention — reusing KV pages across requests that share a prompt
prefix.  This module is the analog of the latter:

* ``PrefixIndex`` — chain hashes of page-aligned chunks of the *spliced*
  token-key sequence (text ids; image spans keyed by image-content hash ×
  scale) → physical page id.  A lookup walks consecutive chunks from the
  root, so any hit is a complete, position-aligned KV prefix.
* ``RefcountAllocator`` — pages carry refcounts so one physical page can
  back many rows' tables; retired pages that the index still references
  are retained ("cached") and flushed wholesale under allocation
  pressure.
* ``suffix_prefill`` — given H cached pages, prefills only the remaining
  (pure-text) suffix: the prefix KV is copied into a fresh dense
  cache, ``llama_forward`` appends the suffix at ``write_idx = H*page``
  with ``q_index_offset`` (flash-kernel causality stays exact),
  and only the new pages are imported back into the pool.

Shared pages are never written: a row's write cursor starts at
``row_len`` which lies beyond the shared region, and the decode scatter
targets the row's own fresh pages.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import LlavaConfig, torch_dtype
from ..models.llama import (KVCache, embed_tokens, init_kv_cache,
                            llama_forward, lm_head)
from .paged_cache import PageAllocator, PagedKVCache, _page_ids, _scatter_pages


# ---------------------------------------------------------------------------
# key sequence + chain hashing
# ---------------------------------------------------------------------------

def image_pseudo_ids(image_bytes_hash: int, numtoks: int) -> np.ndarray:
    """Stable per-position pseudo token ids for an image's feature span."""
    base = np.int64(image_bytes_hash & 0x7FFFFFFFFFFF)
    return base + np.arange(numtoks, dtype=np.int64)


def build_key_seq(input_ids: np.ndarray, numtoks: Optional[int],
                  image_hash: Optional[int], image_token_index: int
                  ) -> Tuple[np.ndarray, int]:
    """Spliced token-key sequence + index where pure text resumes.

    Returns (key_seq, text_resume): key_seq[i] uniquely keys the content
    of spliced position i; positions < text_resume may be image features
    (a cached prefix must cover them before suffix prefill applies)."""
    ids = np.asarray(input_ids).reshape(-1).astype(np.int64)
    img_pos = np.nonzero(ids == image_token_index)[0]
    if img_pos.size == 0 or numtoks is None:
        return ids, 0
    p = int(img_pos[0])
    key = np.concatenate([ids[:p], image_pseudo_ids(image_hash or 0, numtoks),
                          ids[p + 1:]])
    return key, p + numtoks


def chain_hashes(key_seq: np.ndarray, page_size: int,
                 salt: str = "") -> List[bytes]:
    """hash_i = H(hash_{i-1} || chunk_i) for each FULL page chunk.

    ``salt`` roots the chain (e.g. a LoRA adapter name): pages produced
    under different adapters hold different KV and must never match."""
    out, h = [], salt.encode() if salt else b""
    n_full = len(key_seq) // page_size
    for i in range(n_full):
        chunk = key_seq[i * page_size:(i + 1) * page_size]
        h = hashlib.blake2b(h + chunk.tobytes(), digest_size=16).digest()
        out.append(h)
    return out


class PrefixIndex:
    """chain hash -> physical page id, with LRU recency."""

    def __init__(self):
        self.pages: "OrderedDict[bytes, int]" = OrderedDict()

    def lookup(self, hashes: Sequence[bytes]) -> List[int]:
        """Longest consecutive run of hits from the root; touches LRU."""
        hit = []
        for h in hashes:
            if h not in self.pages:
                break
            self.pages.move_to_end(h)
            hit.append(self.pages[h])
        return hit

    def register(self, hashes: Sequence[bytes], page_ids: Sequence[int]):
        for h, p in zip(hashes, page_ids):
            self.pages[h] = p
            self.pages.move_to_end(h)

    def drop_pages(self, page_ids) -> None:
        dead = set(page_ids)
        for h in [h for h, p in self.pages.items() if p in dead]:
            del self.pages[h]

    def clear(self):
        self.pages.clear()


class RefcountAllocator(PageAllocator):
    """PageAllocator with per-page refcounts and a retained ("cached") set
    for pages the prefix index still references after their rows retire."""

    def __init__(self, n_pages: int, page_size: int, max_rows: int,
                 max_pages_per_row: int):
        super().__init__(n_pages, page_size, max_rows, max_pages_per_row)
        self.ref = np.zeros(n_pages, np.int32)
        self.cached: set = set()      # ref==0 but retained for the index
        self.pinned: set = set()      # pages the index references

    # -- allocation ---------------------------------------------------
    def allocate_row(self, row: int, n_tokens: int, headroom: int = 0,
                     shared: Sequence[int] = ()) -> bool:
        need = -(-(n_tokens + headroom) // self.page_size)
        n_fresh = need - len(shared)
        assert n_fresh >= 0
        if need > self.max_pages_per_row:
            return False
        if n_fresh > len(self.free) + len(self.cached):
            return False
        if n_fresh > len(self.free):
            return False  # caller flushes the cached set and retries
        self.tables[row, :] = 0
        for i, p in enumerate(shared):
            self.tables[row, i] = p
            if self.ref[p] == 0 and p in self.free:
                # belt-and-braces: a page can only be both shared and free
                # if the caller's hit list went stale (e.g. across a
                # flush_cached); re-reffing it must take it off the free
                # list or it would be handed out twice
                self.free.remove(p)
            self.ref[p] += 1
            self.cached.discard(p)    # active again
        for i in range(len(shared), need):
            p = self.free.pop()
            self.tables[row, i] = p
            self.ref[p] = 1
        self.n_alloc[row] = need
        return True

    def extend_row(self, row: int) -> bool:
        if self.n_alloc[row] >= self.max_pages_per_row or not self.free:
            return False
        p = self.free.pop()
        self.tables[row, self.n_alloc[row]] = p
        self.ref[p] = 1
        self.n_alloc[row] += 1
        return True

    def free_row(self, row: int):
        for i in range(int(self.n_alloc[row])):
            p = int(self.tables[row, i])
            self.ref[p] -= 1
            if self.ref[p] <= 0:
                self.ref[p] = 0
                if p in self.pinned:
                    self.cached.add(p)
                else:
                    self.free.append(p)
        self.n_alloc[row] = 0
        self.tables[row, :] = 0

    # -- prefix-cache management ---------------------------------------
    def pin(self, page_ids: Sequence[int]):
        self.pinned.update(int(p) for p in page_ids)

    def flush_cached(self) -> List[int]:
        """Move every retained page back to the free list; returns them so
        the caller can drop their index entries."""
        flushed = sorted(self.cached)
        self.free.extend(flushed)
        self.cached.clear()
        self.pinned.difference_update(flushed)
        return flushed


# ---------------------------------------------------------------------------
# suffix prefill
# ---------------------------------------------------------------------------

@torch.inference_mode()
def suffix_prefill(params: dict, cfg: LlavaConfig, k_sel: torch.Tensor,
                   v_sel: torch.Tensor, suffix_ids: torch.Tensor,
                   suffix_valid: torch.Tensor, capacity: int
                   ) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """Prefill only a (pure-text, right-padded) suffix behind a cached
    prefix -> ``(logits (1, V), dense cache, lengths (1,))``.

    ``k_sel`` / ``v_sel``: ``(n_layers, n_prefix, n_kv, Dh)`` prefix KV in
    the model's dtype, gathered from the cached pages; they fill the first
    ``n_prefix`` slots of a fresh dense cache (always of the model's dtype),
    and ``llama_forward`` appends the suffix behind them with
    ``q_index_offset=n_prefix``, which keeps the flash kernel's index
    causality exact."""
    n_prefix = k_sel.shape[1]
    s_suf = suffix_ids.shape[1]
    dev = suffix_ids.device
    dtype = torch_dtype(cfg.llama.dtype)
    cache = init_kv_cache(cfg.llama, 1, capacity, device=dev, dtype=dtype)
    cache.k[:, 0, :n_prefix] = k_sel.to(dtype)
    cache.v[:, 0, :n_prefix] = v_sel.to(dtype)
    cache.valid[:, :n_prefix] = True
    cache.positions[:, :n_prefix] = torch.arange(n_prefix, device=dev)
    cache.set_write_idx(n_prefix)
    embeds = embed_tokens(params["llama"], suffix_ids)          # (1, s_suf, D)
    pos = n_prefix + torch.arange(s_suf, device=dev)[None]
    hidden, cache = llama_forward(
        params["llama"], cfg.llama, embeds, position_ids=pos,
        attn_valid=suffix_valid, cache=cache, q_index_offset=n_prefix)
    n_real = suffix_valid.sum(dim=1)
    idx = torch.clamp(n_real - 1, min=0)
    last = hidden[torch.arange(hidden.shape[0], device=dev), idx][:, None]
    logits = lm_head(params["llama"], last)[:, 0]
    return logits, cache, n_prefix + n_real


@torch.inference_mode()
def import_page_range(paged: PagedKVCache, dense: KVCache, n_skip: int,
                      n_new: int, page_ids, page_size: int) -> PagedKVCache:
    """Scatter dense slots ``[n_skip * page, (n_skip + n_new) * page)`` of a
    suffix prefill's cache (model dtype; quantized for an int8 pool) into
    the pages ``page_ids[:n_new]``."""
    lo, hi = n_skip * page_size, (n_skip + n_new) * page_size
    n_layers, _, _, n_kv, dh = dense.k.shape
    shape = (n_layers, n_new, page_size, n_kv, dh)
    return _scatter_pages(
        paged, _page_ids(page_ids[:n_new], dense.k.device),
        dense.k[:, 0, lo:hi].reshape(shape),
        dense.v[:, 0, lo:hi].reshape(shape), None, None)
