"""Continuous batching, PyTorch port of
``matryoshka_mm_tpu/serve/batching.py``.

One batched KV pool serves many requests: the scheduler thread admits
requests into free rows between decode chunks and retires them as they end,
and per-request token streams come out of thread-safe queues.

* ``backend="dense"``: a fixed ``(max_batch, L + max_new_tokens)`` KV cache;
  every request is left-padded into the ``L``-slot prefill region and decode
  tokens of all rows share the write slots behind it.  When the write region
  runs out the pool is reset and every in-flight request re-admitted with
  prompt + generated-so-far.
* ``backend="paged"``: the paged KV pool (``serve/paged_cache.py``): each row
  maps its tokens onto free-list pages, finished rows return their pages at
  once, and every single-token step attends through the hand-written paged
  attention kernel when the model lies on a CUDA device.

New requests prefill into pool rows: compatible burst arrivals share ONE
batched ``(G, L)`` prefill (``_admit_group``), the rest a batch-1 prefill.

The model runs on the device of ``params``.  Nothing is compiled ahead of
time here, so what the JAX package did to bound its number of traces
(power-of-two group sizes, full-row-width imports, a warm-up list) is not
carried over; pools and row state live in tensors updated in place on the
scheduler thread.

The paged scheduler is pipelined: round ``k + 1`` is enqueued before round
``k``'s tokens are fetched.  CUDA launches are asynchronous already; what
the loop adds is that each round's results are copied to pinned host buffers
behind a CUDA event recorded right after the round, and only that event is
waited on, so reading round ``k`` never waits for round ``k + 1``.
Admissions under it stay device futures: a prefill's first token reaches the
host through the next round's echo of its pre-round token vector.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item): ``adapters=`` (multi-LoRA), anyres multi-tile requests, decoders other
than ``arch="llama"``.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
import traceback
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import _kernels
from ..config import LlavaConfig
from ..constants import IMAGE_TOKEN_INDEX
from ..generate import (GenerationConfig, _params_device, _round_up,
                        _select_token, prefill_image, prefill_text)
from ..models.llama import (KVCache, embed_tokens, init_kv_cache,
                            llama_forward, lm_head)
from .paged_cache import (PageAllocator, PoolState, _resolve_use_kernel,
                          import_prefill, import_prefill_group,
                          init_paged_cache, paged_pool_decode,
                          paged_spec_verify)


class BatchError(RuntimeError):
    """Raised out of ``stream()`` when the pool had to abort the request
    (e.g. capacity exhaustion that re-admission could not absorb)."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


@dataclass
class _StreamError:
    message: str
    code: int = 2


@dataclass
class _Request:
    rid: int
    input_ids: np.ndarray
    pixel_values: Optional[np.ndarray]
    numtoks: Optional[int]
    max_new_tokens: int
    out_queue: "queue.Queue" = field(default_factory=queue.Queue)
    emitted: int = 0
    slot: int = -1
    # tokens streamed so far; lets a pool reset re-admit the request with
    # prompt+generated instead of silently truncating the stream
    generated: List[int] = field(default_factory=list)
    # regex the output must full-match (serve/constrained.py); admits solo
    constraint: Optional[str] = None
    # (trans_local, offset, start_local) installed at admission
    fsm: Optional[tuple] = None
    # continuation of an out-of-pages requeue: resume the constraint DFA
    # at this local state instead of dfa.start (the prompt now embeds the
    # tokens already matched)
    fsm_resume: Optional[int] = None
    # client-side early stop (stop string hit / disconnect): the
    # scheduler retires the row at its next round instead of decoding the
    # remaining budget into a stream nobody reads
    cancelled: bool = False
    # host copy of the row length right after prefill (== the spliced
    # prompt length, computed host-side): lets the pipelined loop compute
    # page needs without fetching device lengths (row_len == len0 +
    # len(generated) - 1 for every processed round)
    len0: int = 0
    # deferred-admission marker: the prefill's first token is still on the
    # device (not yet in ``generated`` / the client stream); the round that
    # echoes it delivers it
    pending: bool = False


def _ngram_propose(ids, k: int, ngram: int):
    """Prompt-lookup draft: continue the most recent earlier occurrence of
    the trailing n-gram; pad by repeating when the match runs short."""
    if len(ids) <= ngram:
        return [int(ids[-1])] * k
    pat = list(ids[-ngram:])
    for s in range(len(ids) - ngram - 1, -1, -1):
        if list(ids[s:s + ngram]) == pat:
            cont = [int(x) for x in ids[s + ngram: s + ngram + k]]
            if cont:
                return (cont + [cont[-1]] * k)[:k]
    return [int(ids[-1])] * k


@dataclass
class _Round:
    """One dispatched decode round: host copies of its results, the event
    recorded behind them, and the slot -> request mapping at dispatch."""

    toks: torch.Tensor
    echo: Optional[torch.Tensor]
    active: torch.Tensor
    snap: list
    t_dispatch: float
    event: Optional["torch.cuda.Event"] = None


class ContinuousBatcher:
    """Single-model continuous batcher; thread-safe submit/stream API."""

    def __init__(self, params, cfg: LlavaConfig, max_batch: int = 4,
                 prefill_len: int = 1024, max_new_tokens: int = 512,
                 gen_cfg: Optional[GenerationConfig] = None,
                 chunk: int = 8, backend: str = "dense",
                 page_size: int = 64, use_kernel: Optional[bool] = None,
                 prefix_cache: bool = False, adapters: Optional[dict] = None,
                 speculative_k: int = 0, spec_ngram: int = 3,
                 fsm_vocab: Optional[list] = None, max_fsm_states: int = 64,
                 n_pages: Optional[int] = None, pipeline_rounds: bool = True):
        if adapters:
            raise NotImplementedError(
                "multi-LoRA serving (adapters=) is not ported yet: it needs "
                "ops/lora.py (ROADMAP.md Queue 1, item 7a)")
        if cfg.llama.arch != "llama":
            raise NotImplementedError(
                f"arch={cfg.llama.arch!r}: the batcher is ported for 'llama' "
                f"only (Mistral and MPT: ROADMAP.md Queue 1, item 2)")
        if backend not in ("dense", "paged"):
            raise ValueError(f"backend={backend!r}; expected 'dense' or "
                             f"'paged'")
        self.params = params
        self.cfg = cfg
        self.device = _params_device(params)
        dev = self.device
        self.max_batch = max_batch
        # A/B lever for the pipelined decode loop; only the paged
        # non-speculative scheduler pipelines
        self.pipeline_rounds = pipeline_rounds
        self.L = _round_up(prefill_len, 64)
        self.capacity = self.L + max_new_tokens
        self.gen_cfg = gen_cfg or GenerationConfig(decode_chunk=chunk)
        self.chunk = chunk
        self.backend = backend
        self.spec_k = int(speculative_k)
        self.spec_ngram = int(spec_ngram)
        if self.spec_k > 0:
            # batched prompt-lookup speculative decoding: host proposes k
            # drafts per row from each request's prompt+generated history,
            # one (k+1)-token paged verify accepts the greedy-consistent
            # prefix
            if backend != "paged":
                raise ValueError("speculative_k requires the paged backend")
            if self.gen_cfg.do_sample or self.gen_cfg.temperature > 0:
                raise ValueError(
                    "speculative decoding is greedy-only: draft acceptance "
                    "compares against argmax (set temperature=0/do_sample="
                    "False, the reference eval protocol)")
        self.spec_stats = {"verify_steps": 0, "tokens_emitted": 0}
        # page headroom per decode dispatch: a vanilla chunk advances a row
        # by `chunk` slots, a speculative verify writes k+1 slots up front
        self._headroom = max(self.chunk, self.spec_k + 1) + 1

        # constrained decoding (serve/constrained.py): per-slot DFA spans
        # in one dense (2 + max_batch*quota, V) table pool; row 0 is the
        # dead state (eos only), row 1 the unconstrained free state
        self.fsm_vocab = fsm_vocab
        self.fsm_quota = int(max_fsm_states)
        self._fsm_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._fsm_pad_ids: List[int] = []
        self.fsm_allow = self.fsm_trans = self.fsm_state = None
        if fsm_vocab is not None:
            if backend != "paged":
                raise ValueError("constrained decoding (fsm_vocab) requires "
                                 "the paged backend")
            if self.spec_k:
                raise ValueError("constrained decoding and speculative_k "
                                 "cannot combine: the verify step does not "
                                 "mask draft logits")
            # the allow mask must broadcast against the model's logits:
            # pad short vocabs (lm_head wider than the tokenizer) with
            # never-matchable sentinels; a vocab WIDER than the logits
            # means the wrong tokenizer
            V_model = cfg.llama.vocab_size
            if len(fsm_vocab) > V_model:
                raise ValueError(
                    f"fsm_vocab has {len(fsm_vocab)} entries but the model "
                    f"emits {V_model} logits — wrong tokenizer?")
            self._fsm_pad_ids = list(range(len(fsm_vocab), V_model))
            self.fsm_vocab = list(fsm_vocab) + [""] * len(self._fsm_pad_ids)
            n_rows = 2 + max_batch * self.fsm_quota
            self.fsm_allow = torch.zeros((n_rows, V_model), dtype=torch.bool,
                                         device=dev)
            self.fsm_allow[0, self.gen_cfg.eos_token_id] = True  # dead: eos
            self.fsm_allow[1, :] = True                          # free: any
            self.fsm_trans = torch.zeros((n_rows, V_model),
                                         dtype=torch.int64, device=dev)
            self.fsm_trans[1, :] = 1
            self.fsm_state = torch.ones((max_batch,), dtype=torch.int64,
                                        device=dev)
        self.index = None
        if backend == "paged":
            self.page_size = page_size
            # rows get one dispatch's headroom of extra page room on top of
            # L + max_new so _ensure_pages never kills a row that still
            # has budget (a speculative verify advances up to k+1 slots)
            self.capacity = _round_up(self.capacity + self._headroom,
                                      page_size)
            self.pages_per_row = -(-self.capacity // page_size)
            # n_pages override: bound the pool's memory below the worst
            # case (every row at full capacity); admissions that cannot get
            # pages retry at the front of the line
            if n_pages is None:
                # +1: page 0 is the allocator's reserved trash page
                n_pages = max_batch * self.pages_per_row + 1
            self.paged = init_paged_cache(cfg.llama, n_pages, page_size,
                                          device=dev)
            if prefix_cache:
                from .prefix_cache import PrefixIndex, RefcountAllocator

                self.alloc = RefcountAllocator(n_pages, page_size, max_batch,
                                               self.pages_per_row)
                self.index = PrefixIndex()
                self.stats = {"prefix_hits": 0, "prefix_misses": 0,
                              "prefix_pages_reused": 0, "admit_retries": 0}
            else:
                self.alloc = PageAllocator(n_pages, page_size, max_batch,
                                           self.pages_per_row)
            self.tables = self._upload(self.alloc.tables)
            self.use_kernel = _resolve_use_kernel(use_kernel, cfg.llama, dev)
        else:
            # one chunk of slack, so a request of the pool's own
            # max_new_tokens ends inside one write region
            self.capacity += self.chunk
            self.pool = self._new_dense_pool()
        self.tokens = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        self.lengths = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=dev)
        self.active = torch.zeros((max_batch,), dtype=torch.bool, device=dev)
        self.budget = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        # sampling draws from one generator on the device, seeded 0
        self._generator = torch.Generator(device=dev).manual_seed(0)

        # page-table device mirror refresh is batched to one upload per
        # decode dispatch (allocator changes only set this flag)
        self._tables_dirty = False
        # set by the scheduler loop: paged non-speculative scheduling
        # admits asynchronously (first-token fetch deferred)
        self._defer_admit = False
        self.pending: "queue.Queue[_Request]" = queue.Queue()
        # out-of-pages retries and retire continuations go HERE, not back
        # into pending: a tail requeue would let later arrivals jump ahead
        # of a request that already waited; the scheduler drains this
        # front-of-line list before pending each iteration
        self._retry: List[_Request] = []
        self.slots: List[Optional[_Request]] = [None] * max_batch
        # mid-admission, for the crash handler
        self._admitting: List[_Request] = []
        # admissions by path: solo b=1 prefills vs rows sharing a batched
        # group prefill (plus prefix-cache hits in self.stats when enabled)
        self.admit_stats = {"solo": 0, "grouped": 0}
        # batch-occupancy accounting, updated once per decode round:
        # mean(active_rows/max_batch) over rounds is the sustained-load
        # utilization
        self.occupancy = {"rounds": 0, "active_rows": 0}
        # decoder forward passes dispatched over the pool (``chunk`` per
        # decode round, one per speculative verify); on a CUDA device each
        # pass of a round launches the paged kernel once per layer
        self.decode_steps = 0
        self.error: Optional[BaseException] = None
        # opt-in scheduler event log: set ``batcher.events = []`` and every
        # admission / decode round / retry appends ``(t, kind, detail)``
        self.events: Optional[List[tuple]] = None
        self._rid = 0
        self._lock = threading.Lock()
        self._stop = False
        # set to queue a whole burst before the scheduler may admit,
        # forcing the grouped-admission path deterministically
        self._hold_admission = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _ev(self, kind: str, **detail):
        if self.events is not None:
            self.events.append((time.perf_counter(), kind, detail))

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array as a NEW device tensor (the array is copied first,
        so the caller may go on changing it)."""
        return torch.from_numpy(np.array(array)).to(self.device)

    def _new_dense_pool(self) -> KVCache:
        pool = init_kv_cache(self.cfg.llama, self.max_batch, self.capacity,
                             device=self.device)
        # decode tokens go behind the prefill region, which every row's
        # left-padded prompt fills
        pool.write_idx = self.L
        return pool

    # ---- client API ----
    def _vis_tokens(self, numtoks: Optional[int]) -> int:
        return numtoks if numtoks is not None else self.cfg.vision.num_patches

    def spliced_len(self, input_ids: np.ndarray, numtoks: Optional[int],
                    pixel_values=None, image_size=None) -> int:
        """Prompt length after image-token splice — what prefill must fit."""
        ids = np.asarray(input_ids).reshape(-1)
        n_img = int((ids == IMAGE_TOKEN_INDEX).sum())
        if n_img == 0:
            return ids.shape[0]
        return ids.shape[0] + n_img * (self._vis_tokens(numtoks) - 1)

    def fits(self, input_ids: np.ndarray, numtoks: Optional[int],
             pixel_values=None, image_size=None) -> bool:
        """True when the prompt fits the pool's prefill region; callers
        should route oversized prompts to the solo generate path."""
        return self.spliced_len(input_ids, numtoks) <= self.L

    def submit(self, input_ids: np.ndarray, pixel_values=None,
               numtoks: Optional[int] = None,
               max_new_tokens: int = 128,
               lora_id: Optional[str] = None,
               image_size: Optional[tuple] = None,
               constraint_regex: Optional[str] = None) -> _Request:
        if lora_id is not None:
            raise KeyError(f"unknown LoRA adapter {lora_id!r}: multi-LoRA "
                           f"serving is not ported yet (ROADMAP.md Queue 1, "
                           f"item 7a)")
        if constraint_regex is not None:
            if self.fsm_vocab is None:
                raise ValueError(
                    "constrained decoding needs the batcher constructed "
                    "with fsm_vocab= (the decoded piece per token id, e.g. "
                    "constrained.vocab_from_tokenizer(tokenizer))")
            tables = self._fsm_tables(constraint_regex)   # raises on bad
            n_live = tables[0].shape[0] - 1
            if n_live > self.fsm_quota:
                raise ValueError(
                    f"constraint DFA needs {n_live} states > per-request "
                    f"quota {self.fsm_quota}; raise max_fsm_states")
        if pixel_values is not None:
            px = np.asarray(pixel_values)
            n_img = int((np.asarray(input_ids).reshape(-1)
                         == IMAGE_TOKEN_INDEX).sum())
            if px.ndim == 4 and px.shape[0] > 1 and n_img > 1:
                raise ValueError(
                    "multi-image prompts are not batchable; use the solo "
                    "generate path (the pool treats a multi-frame stack as "
                    "anyres tiles of one image)")
            if px.ndim != 4 or px.shape[0] > 1 or image_size is not None:
                raise NotImplementedError(
                    "anyres multi-tile admission is not ported yet "
                    "(ROADMAP.md Queue 1, item 8a)")
        if not self.fits(input_ids, numtoks):
            # a negative left-pad would crash the scheduler thread and take
            # the whole pool down with it; reject just this request instead
            raise ValueError(
                f"prompt ({self.spliced_len(input_ids, numtoks)} "
                f"spliced tokens) exceeds the pool prefill region ({self.L}); "
                f"use the solo generate path or raise prefill_len")
        req = _Request(0, np.asarray(input_ids, np.int32),
                       None if pixel_values is None
                       else np.asarray(pixel_values, np.float32),
                       numtoks, max_new_tokens, constraint=constraint_regex)
        # the lock spans the error check and the enqueue so the crash
        # handler (which drains pending under the same lock) can never
        # miss a request submitted concurrently with scheduler death
        with self._lock:
            self._rid += 1
            req.rid = self._rid
            if self.error is not None:   # scheduler already dead
                req.out_queue.put(None)
                return req
            self.pending.put(req)
        self._ev("submit", rid=req.rid)
        return req

    def cancel(self, req: _Request):
        """Stop decoding a request early (client stop-string hit or
        disconnect).  Thread-safe: only flips a flag — the scheduler
        thread retires the row (frees pages, ends the stream) at its
        next emission or admission round."""
        req.cancelled = True

    def stream(self, req: _Request):
        """Yield np arrays of new token ids until the request finishes.

        Raises :class:`BatchError` when the pool aborted the request."""
        while True:
            item = req.out_queue.get()
            if item is None:
                return
            if isinstance(item, _StreamError):
                raise BatchError(item.message, item.code)
            yield item

    def warmup(self, with_image: bool = True,
               numtoks: Optional[int] = None,
               batch_sizes: Optional[tuple] = None) -> float:
        """Pay the first-use costs BEFORE real traffic: on a CUDA device
        build and load the kernel library, then run one real request
        through prefill and a decode chunk (which also makes PyTorch pick
        and cache its matmul algorithms and sizes the allocator's pools).
        For each ``g`` in ``batch_sizes`` (none by default: nothing is
        traced per group size here) one burst of ``g`` requests goes
        through the grouped admission as ONE group.  Returns wall seconds
        spent."""
        t0 = time.time()
        if self.device.type == "cuda":
            _kernels.library()
        s = self.cfg.vision.image_size

        def _make(i: int):
            ids = np.full((1, 3), 9, np.int32)
            ids[0, 0] = 5 + i
            ids[0, 1] = IMAGE_TOKEN_INDEX if with_image else 7
            px = None
            if with_image:
                # distinct pixel content per request: group members must
                # miss the prefix cache to take the grouped prefill
                px = np.zeros((1, 3, s, s), np.float32)
                px[0, 0, 0, 0] = float(i)
            return ids, px

        def _drain(reqs):
            for r in reqs:
                for _ in self.stream(r):
                    pass

        _drain([self.submit(*_make(0), numtoks=numtoks,
                            max_new_tokens=self.chunk + 1)])
        for g in batch_sizes or ():
            self._hold_admission = True
            try:
                time.sleep(0.05)   # let any in-flight admission pass end
                reqs = [self.submit(*_make(i + 1), numtoks=numtoks,
                                    max_new_tokens=2) for i in range(g)]
            finally:
                self._hold_admission = False
            _drain(reqs)
        return time.time() - t0

    def shutdown(self, timeout: float = 60.0):
        """Stop the scheduler thread and release the device state.  The
        state is dropped only once the thread has ended: a thread still
        inside a device call would otherwise find it gone.  Raises if the
        thread does not end within ``timeout`` seconds."""
        self._stop = True
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError(
                f"ContinuousBatcher.shutdown: the scheduler thread did not "
                f"end within {timeout} s; its device state is kept")
        # a shut-down batcher object that stays referenced must not pin
        # the model and the multi-GB pools
        for attr in ("params", "paged", "pool", "fsm_allow", "fsm_trans"):
            if hasattr(self, attr):
                setattr(self, attr, None)

    # ---- scheduler ----
    def _key_seq(self, req: _Request):
        """Spliced token-key sequence for prefix caching, or (None, 0) when
        the request shape isn't cacheable (multi-image)."""
        from .prefix_cache import build_key_seq

        ids = np.asarray(req.input_ids)
        if ids.shape[0] != 1 or (ids == IMAGE_TOKEN_INDEX).sum() > 1:
            return None, 0
        if req.pixel_values is None:
            return build_key_seq(ids, None, None, IMAGE_TOKEN_INDEX)
        if req.pixel_values.ndim != 4:
            return None, 0
        n = self._vis_tokens(req.numtoks)
        h = hashlib.blake2b(req.pixel_values.tobytes(), digest_size=8)
        h.update(repr((req.pixel_values.shape[0], None)).encode())
        img_hash = int.from_bytes(h.digest(), "little")
        return build_key_seq(ids, n, img_hash, IMAGE_TOKEN_INDEX)

    def _try_admit_prefix(self, req: _Request, slot: int):
        """Admit via cached prefix pages + suffix-only prefill.  Returns
        True when handled; None to fall through to the full-prefill path."""
        from .prefix_cache import (chain_hashes, import_page_range,
                                   suffix_prefill)

        if req.constraint is not None:
            # the hit path selects the first token before FSM installation
            # could mask it — constrained requests take the full prefill
            return None
        key_seq, text_resume = self._key_seq(req)
        if key_seq is None:
            return None
        T = len(key_seq)
        if T + 1 > self.capacity:
            return None
        hashes = chain_hashes(key_seq, self.page_size)
        max_h = min(len(hashes), (T - 1) // self.page_size)
        hits = self.index.lookup(hashes[:max_h])
        H = len(hits)
        if H == 0 or H * self.page_size < text_resume:
            self.stats["prefix_misses"] += 1
            return None

        if not self.alloc.allocate_row(slot, T, headroom=self._headroom,
                                       shared=hits):
            # flushing the cached set may free exactly the pages `hits`
            # points at (their index entries are dropped with them), so the
            # lookup must be redone — retrying with the stale list would
            # re-ref pages that just went back on the free list and hand
            # the same physical page out twice
            self.index.drop_pages(self.alloc.flush_cached())
            hits = self.index.lookup(hashes[:max_h])
            H = len(hits)
            if H == 0 or H * self.page_size < text_resume:
                self.stats["prefix_misses"] += 1
                return None
            if not self.alloc.allocate_row(slot, T, headroom=self._headroom,
                                           shared=hits):
                return None                       # pool pressure: full path
        n_prefix = H * self.page_size
        # suffix is pure text: map spliced positions back to input ids
        ids = np.asarray(req.input_ids).reshape(-1)
        if text_resume > 0:                      # image inside the prefix
            suffix = ids[n_prefix - self._vis_tokens(req.numtoks) + 1:]
        else:
            suffix = ids[n_prefix:]
        t_suf = len(suffix)
        s_suf = _round_up(max(t_suf, 1), 64)

        p = self.paged
        n_layers, n_kv, dh = p.k.shape[0], p.k.shape[3], p.k.shape[4]
        sel = torch.as_tensor(np.asarray(hits, np.int64), device=self.device)
        k_sel = p.k[:, sel].reshape(n_layers, n_prefix, n_kv, dh)
        v_sel = p.v[:, sel].reshape(n_layers, n_prefix, n_kv, dh)
        if p.k_scale is not None:
            # int8 pool: dequantize the gathered prefix for the dense
            # suffix prefill
            ks = p.k_scale[:, sel].reshape(n_layers, n_prefix, n_kv, 1)
            vs = p.v_scale[:, sel].reshape(n_layers, n_prefix, n_kv, 1)
            k_sel, v_sel = k_sel.float() * ks, v_sel.float() * vs
        ids_p = torch.as_tensor(
            np.pad(suffix, (0, s_suf - t_suf)).astype(np.int64)[None],
            device=self.device)
        valid = torch.as_tensor((np.arange(s_suf) < t_suf)[None],
                                device=self.device)
        logits, dense, _ = suffix_prefill(self.params, self.cfg, k_sel, v_sel,
                                          ids_p, valid,
                                          n_prefix + s_suf)

        n_total = int(self.alloc.n_alloc[slot])
        # only pages the suffix prefill filled are imported; the rest of
        # the allocation is headroom that decode writes later
        n_new = min(n_total, -(-(n_prefix + s_suf) // self.page_size)) - H
        if n_new > 0:
            import_page_range(self.paged, dense, H, n_new,
                              self.alloc.tables[slot][H:H + n_new],
                              self.page_size)
        self._tables_dirty = True
        reg_n = T // self.page_size
        if reg_n > H:
            self.index.register(hashes[H:reg_n],
                                self.alloc.tables[slot][H:reg_n].tolist())
            self.alloc.pin(self.alloc.tables[slot][H:reg_n].tolist())
        self.stats["prefix_hits"] += 1
        self.stats["prefix_pages_reused"] += H

        first = _select_token(logits, self.gen_cfg, self._generator)
        self._complete_admit(req, slot, first, T)
        self._ev("admit_prefix", rid=req.rid, slot=slot, pages=H)
        return True

    def _complete_admit(self, req: _Request, slot: int, first, host_len: int):
        """Activate an admitted request: asynchronously under the paged
        pipelined scheduler (first token stays on the device), else
        through the synchronous finish.  Constrained requests always
        finish synchronously (the DFA advance needs the token value) and
        so do budget-1 requests (activating them would over-emit)."""
        if (self._defer_admit and req.constraint is None
                and req.max_new_tokens > 1 and not req.cancelled):
            self._activate_rows([(req, slot)], first[0:1], [host_len])
        else:
            self._finish_admit(req, slot, first[0:1], host_len)

    def _activate_rows(self, members, first_sel, host_lens):
        """Activate admitted rows WITHOUT any host sync: device-side state
        updates only; ``first_sel`` (G,) stays on the device.  The host
        reads the value out of the NEXT decode round's echo when that round
        is processed (the row joins it in this same scheduler iteration).
        An EOS first token deactivates its row on device; the row is then
        retired by the next round's processing, exactly like a row that
        hits EOS mid-decode."""
        dev = self.device
        sel = torch.as_tensor([s for _, s in members], dtype=torch.int64,
                              device=dev)
        self.tokens[sel] = first_sel.to(torch.int32)
        self.lengths[sel] = torch.as_tensor(host_lens, dtype=torch.int32,
                                            device=dev)
        self.budget[sel] = torch.as_tensor(
            [r.max_new_tokens - 1 for r, _ in members], dtype=torch.int32,
            device=dev)
        self.active[sel] = first_sel != self.gen_cfg.eos_token_id
        if self.fsm_state is not None:
            # deferred admissions are never constrained: free state
            self.fsm_state[sel] = 1
        for i, (req, slot) in enumerate(members):
            req.len0 = int(host_lens[i])
            req.pending = True
            req.slot = slot
            self.slots[slot] = req

    def _emit_pending_first(self, req: _Request, tok: int):
        """Deliver a deferred admission's first token to the client and
        host history (from the processed round's echo, or the requeue
        fallback's state fetch)."""
        req.pending = False
        req.out_queue.put(np.asarray([tok], np.int32))
        req.emitted += 1
        req.generated.append(tok)

    def _sync_tables(self):
        """Refresh the device page-table mirror at most once per decode
        dispatch (allocator mutations only mark it dirty)."""
        if self._tables_dirty:
            self.tables = self._upload(self.alloc.tables)
            self._tables_dirty = False

    def _finish_admit(self, req: _Request, slot: int, first, length: int):
        """Synchronous admission finish (host-syncs on the prefill): emit
        the prefill token and either activate the row or finish the
        request immediately (first token is EOS, or the budget was 1 —
        activating such a row would over-emit past the budget).
        ``length`` is the host-computed spliced prompt length."""
        first_np = first.to(torch.int32).cpu().numpy()
        first_tok = int(first_np[0])
        req.len0 = int(length)
        req.out_queue.put(first_np)
        req.emitted += 1
        req.generated.append(first_tok)
        if self.fsm_state is not None:
            if req.fsm is not None:           # constrained: advance the DFA
                trans_l, offset, start = req.fsm
                nxt = int(trans_l[start, first_tok])
                state = 0 if nxt == 0 else offset + nxt - 1
            else:
                state = 1                     # unconstrained: free row
            self.fsm_state[slot] = state
        if first_tok == self.gen_cfg.eos_token_id or req.max_new_tokens <= 1:
            self._retire(slot, req)
            return
        self.tokens[slot] = first_tok
        self.lengths[slot] = int(length)
        self.active[slot] = True
        self.budget[slot] = req.max_new_tokens - 1
        req.slot = slot
        self.slots[slot] = req

    def _pad_ids(self, reqs) -> tuple:
        """Left-pad raw prompt ids to the ``(G, self.L)`` prefill shape plus
        validity mask, as device tensors."""
        G = len(reqs)
        ids = np.full((G, self.L), self.gen_cfg.pad_token_id, np.int64)
        mask = np.zeros((G, self.L), bool)
        for g, r in enumerate(reqs):
            flat = np.asarray(r.input_ids, np.int64).reshape(-1)
            ids[g, self.L - flat.shape[0]:] = flat
            mask[g, self.L - flat.shape[0]:] = True
        return (torch.as_tensor(ids, device=self.device),
                torch.as_tensor(mask, device=self.device))

    def _prefill(self, reqs):
        """One ``(G, L)`` prefill of compatible requests -> ``(logits (G, V),
        dense cache of exactly L slots)``."""
        ids_p, mask = self._pad_ids(reqs)
        if reqs[0].pixel_values is None:
            logits, cache, _ = prefill_text(self.params, self.cfg, ids_p,
                                            mask, self.L)
        else:
            px = torch.as_tensor(np.concatenate(
                [np.asarray(r.pixel_values, np.float32) for r in reqs], 0),
                device=self.device)
            logits, cache, _ = prefill_image(
                self.params, self.cfg, ids_p, px, mask,
                self._vis_tokens(reqs[0].numtoks), self.L, self.L)
        return logits, cache

    def _fsm_tables(self, pattern: str):
        """Compile a constraint's local token tables; bounded LRU memo
        (each entry holds ~(quota, V) bool+int32 arrays — an unbounded
        cache leaks under per-request schemas embedding request data)."""
        if pattern not in self._fsm_cache:
            from .constrained import build_token_tables, compile_regex

            dfa = compile_regex(pattern)
            allow, trans = build_token_tables(
                dfa, self.fsm_vocab, self.gen_cfg.eos_token_id,
                special_ids=[self.gen_cfg.pad_token_id, *self._fsm_pad_ids])
            self._fsm_cache[pattern] = (allow, trans, dfa.start)
            while len(self._fsm_cache) > 32:
                self._fsm_cache.popitem(last=False)
        self._fsm_cache.move_to_end(pattern)
        return self._fsm_cache[pattern]

    def _install_fsm(self, req: _Request, slot: int, logits):
        """Place the request's DFA span into the slot's table-pool region
        and mask the prefill logits with the start state's allow row.
        Local state s>0 maps to pool row offset+s-1; 0 stays the dead row.
        Only the slot's span of the device pools is written."""
        allow_l, trans_l, start = self._fsm_tables(req.constraint)
        if req.fsm_resume is not None:
            start = req.fsm_resume     # continuation: DFA mid-match
        n = allow_l.shape[0]
        offset = 2 + slot * self.fsm_quota
        remap = np.where(trans_l[1:n] == 0, 0,
                         offset + trans_l[1:n] - 1).astype(np.int64)
        self.fsm_allow[offset:offset + n - 1] = self._upload(allow_l[1:n])
        self.fsm_trans[offset:offset + n - 1] = self._upload(remap)
        req.fsm = (trans_l, offset, start)
        return torch.where(self._upload(allow_l[start])[None], logits,
                           torch.full_like(logits, -1e30))

    def _admit(self, req: _Request, slot: int) -> bool:
        """Admit one request with a batch-1 prefill (a prefix-cache hit was
        tried before, in ``_admit_pending``)."""
        t0 = time.perf_counter()
        logits, cache = self._prefill([req])
        if req.constraint is not None:
            logits = self._install_fsm(req, slot, logits)
        first = _select_token(logits, self.gen_cfg, self._generator)

        # host-computed spliced length == the prefill's device lengths
        # (submit() guarantees it fits self.L) — no sync needed
        T = self.spliced_len(req.input_ids, req.numtoks)
        if self.backend == "paged":
            if not self._insert_paged(req, slot, cache, T):
                return False
        else:
            self._insert_dense(slot, cache, 0)
        self._complete_admit(req, slot, first, T)
        self.admit_stats["solo"] += 1
        self._ev("admit_solo", rid=req.rid, slot=slot,
                 ms=(time.perf_counter() - t0) * 1e3)
        return True

    def _admit_group(self, members) -> bool:
        """Admit several compatible requests with ONE batched prefill.

        ``members`` is a list of ``(req, slot)`` pairs that share the
        batched-prefill signature (all plain single-image with the same
        numtoks, or all text-only).  Serial b=1 admissions each read the
        full weights; one (G, L) prefill reads them once.  Under the paged
        backend the whole group imports with one scatter
        (paged_cache.import_prefill_group) and activates with one batched
        update; allocation failures requeue per row."""
        t0 = time.perf_counter()
        reqs = [r for r, _ in members]
        logits, cache = self._prefill(reqs)
        first = _select_token(logits, self.gen_cfg, self._generator)
        host_lens = [self.spliced_len(r.input_ids, r.numtoks) for r in reqs]
        ok_any = False
        if self.backend == "paged":
            ok = [(g, req, slot) for g, (req, slot) in enumerate(members)
                  if self._alloc_pages(req, slot, host_lens[g])]
            if ok:
                # rows whose allocation failed keep an all-trash table
                tables = np.zeros((len(members), self.pages_per_row),
                                  np.int32)
                pads = np.zeros((len(members),), np.int32)
                for g, req, slot in ok:
                    tables[g] = self.alloc.tables[slot]
                    pads[g] = self.L - host_lens[g]
                import_prefill_group(self.paged, cache, pads, tables,
                                     self.page_size)
                for g, req, slot in ok:
                    self._register_prefix_pages(req, slot, host_lens[g])
                defer = [(g, req, slot) for g, req, slot in ok
                         if self._defer_admit and req.max_new_tokens > 1
                         and not req.cancelled]
                if defer:
                    sel = torch.as_tensor([g for g, _, _ in defer],
                                          dtype=torch.int64,
                                          device=self.device)
                    self._activate_rows(
                        [(req, slot) for _, req, slot in defer],
                        first[sel], [host_lens[g] for g, _, _ in defer])
                deferred = {g for g, _, _ in defer}
                for g, req, slot in ok:
                    if g not in deferred:
                        self._finish_admit(req, slot, first[g:g + 1],
                                           host_lens[g])
                    self.admit_stats["grouped"] += 1
                ok_any = True
        else:
            for g, (req, slot) in enumerate(members):
                self._insert_dense(slot, cache, g)
                self._finish_admit(req, slot, first[g:g + 1], host_lens[g])
                self.admit_stats["grouped"] += 1
                ok_any = True
        self._ev("admit_group", rids=[r.rid for r in reqs],
                 ms=(time.perf_counter() - t0) * 1e3)
        return ok_any

    @staticmethod
    def _group_key(req: _Request):
        """Batched-prefill compatibility key, or None when the request must
        admit solo (constrained requests need per-request first-token
        masking)."""
        if req.constraint is not None:
            return None
        if req.pixel_values is None:
            return ("text",)
        return ("img", req.numtoks)

    def _insert_dense(self, slot: int, cache: KVCache, g: int):
        """Copy row ``g`` of an ``L``-slot prefill cache into pool row
        ``slot``.  The pool's write_idx may have advanced past the prefill
        region; the row's slots behind it are marked invalid, which the
        position-based attention masks handle exactly."""
        pool, L = self.pool, self.L
        pool.k[:, slot, :L] = cache.k[:, g]
        pool.v[:, slot, :L] = cache.v[:, g]
        pool.valid[slot, :L] = cache.valid[g]
        pool.valid[slot, L:] = False
        pool.positions[slot, :L] = cache.positions[g]
        if pool.k_scale is not None:
            pool.k_scale[:, slot, :L] = cache.k_scale[:, g]
            pool.v_scale[:, slot, :L] = cache.v_scale[:, g]

    def _alloc_pages(self, req: _Request, slot: int, T: int) -> bool:
        """Allocate row ``slot``'s pages for a ``T``-token prefill.
        On pool pressure the request retries at the front of the line;
        a request that can never fit gets an explicit error."""
        ok = self.alloc.allocate_row(slot, T, headroom=self._headroom)
        if not ok and self.index is not None and self.alloc.cached:
            self.index.drop_pages(self.alloc.flush_cached())
            ok = self.alloc.allocate_row(slot, T, headroom=self._headroom)
        if not ok:
            need = -(-(T + self._headroom) // self.page_size)
            most = min(self.pages_per_row, self.alloc.n_allocatable)
            if need > most:
                # can never fit, even with the whole pool free: an
                # explicit error, not a clean end-of-stream (and not an
                # eternal front-of-line retry)
                req.out_queue.put(_StreamError(
                    f"request needs {need} KV pages but the pool can "
                    f"serve at most {most} per row; raise n_pages or "
                    f"shorten the prompt"))
                req.out_queue.put(None)
            else:        # out of pages now: retry at the FRONT of the line
                if self.index is not None:
                    self.stats["admit_retries"] += 1
                self._retry.append(req)
                self._ev("retry_pages", rid=req.rid)
            return False
        self._tables_dirty = True
        return True

    def _register_prefix_pages(self, req: _Request, slot: int, T: int):
        """Register a freshly imported row's full pages with the prefix
        index (no-op without the prefix cache)."""
        if self.index is None:
            return
        from .prefix_cache import chain_hashes

        key_seq, _ = self._key_seq(req)
        if key_seq is not None and len(key_seq) == T:
            reg_n = T // self.page_size
            if reg_n > 0:
                hashes = chain_hashes(key_seq, self.page_size)
                pages = self.alloc.tables[slot][:reg_n].tolist()
                self.index.register(hashes[:reg_n], pages)
                self.alloc.pin(pages)

    def _insert_paged(self, req: _Request, slot: int, cache: KVCache,
                      T: int) -> bool:
        if not self._alloc_pages(req, slot, T):
            return False
        import_prefill(self.paged, cache, self.L - T,
                       self.alloc.tables[slot],
                       int(self.alloc.n_alloc[slot]), self.page_size)
        self._register_prefix_pages(req, slot, T)
        return True

    def _propose_drafts(self) -> torch.Tensor:
        """Prompt-lookup drafts for every pool row (host-side): continue the
        most recent earlier occurrence of each row's trailing n-gram over
        prompt+generated.  Rows without a request draft zeros; their
        verify lanes are masked anyway."""
        drafts = np.zeros((self.max_batch, self.spec_k), np.int32)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            ids = np.asarray(req.input_ids).reshape(-1).tolist()
            ids += req.generated
            drafts[slot] = _ngram_propose(ids, self.spec_k, self.spec_ngram)
        return self._upload(drafts)

    def _ensure_pages(self, pipelined: bool = False):
        """Grow each active row to cover the next chunk; rows that cannot
        be extended (pool exhausted) are freed and requeued at the front
        of the line with prompt+generated-so-far — per-row, not
        pool-wide, and never a silent truncation that looks like a normal
        finish (same contract as the dense _retire_all).

        ``pipelined``: compute row lengths host-side instead of fetching
        ``self.lengths`` — that fetch would wait for the round still in
        flight.  The host view (post-prefill length + tokens emitted) lags
        the device by the unprocessed in-flight round, so one extra
        ``chunk`` of margin is added (over-provisions by at most one page
        per row)."""
        if not pipelined:
            lengths = self.lengths.cpu().numpy()
        changed = False
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            if pipelined:
                # an unresolved deferred first token counts as one
                # generated token the host hasn't seen yet
                gen = len(req.generated) + (1 if req.pending else 0)
                cur = req.len0 + gen - 1 + self.chunk
            else:
                cur = int(lengths[slot])
            need = cur + self._headroom
            ok = True
            while self.alloc.capacity(slot) < need:
                if not self.alloc.extend_row(slot):
                    if self.index is not None and self.alloc.cached:
                        self.index.drop_pages(self.alloc.flush_cached())
                        continue
                    ok = False
                    break
                changed = True
            if not ok:
                self.slots[slot] = None
                self.alloc.free_row(slot)
                changed = True
                self._requeue_inflight(req, "out of KV pages mid-decode")
                self.active[slot] = False
        if changed:
            self._tables_dirty = True

    def _continuation(self, req: _Request, reason: str) -> Optional[_Request]:
        """A request that resumes ``req`` with prompt + generated-so-far, or
        None when the stream was ended here (budget spent, or the
        continuation no longer fits: an explicit error chunk, never a
        clean end-of-stream)."""
        remaining = req.max_new_tokens - len(req.generated)
        if remaining <= 0:
            req.out_queue.put(None)
            return None
        ids = np.concatenate(
            [np.asarray(req.input_ids).reshape(-1).astype(np.int32),
             np.asarray(req.generated, np.int32)])[None]
        if not self.fits(ids, req.numtoks):
            req.out_queue.put(_StreamError(
                f"request aborted: {reason} and the continuation prompt "
                f"no longer fits the pool prefill region"))
            req.out_queue.put(None)
            return None
        return _Request(req.rid, ids, req.pixel_values, req.numtoks,
                        remaining, out_queue=req.out_queue,
                        emitted=req.emitted, constraint=req.constraint)

    def _requeue_inflight(self, req: _Request, reason: str):
        """Resume a mid-flight request through the front-of-line retry
        with prompt+generated (its row is already freed)."""
        self._ev("requeue", rid=req.rid, reason=reason)
        if req.pending:
            # deferred admission requeued before any round echoed its
            # first token (a pool so tight _ensure_pages fails in the
            # same iteration): fetch it from the row state now, or the
            # continuation would rebuild the same prompt with no progress
            self._emit_pending_first(req, int(self.tokens[req.slot]))
        cont = self._continuation(req, reason)
        if cont is None:
            return
        if req.constraint is not None and req.fsm is not None:
            # resume the DFA after the tokens already emitted — starting
            # over would re-match the regex against only the continuation
            trans_l, _, start = req.fsm
            s = start
            for t in req.generated:
                s = int(trans_l[s, int(t)])
                if s == 0:
                    break
            if s == 0:     # cannot happen under masked decode; be loud
                req.out_queue.put(_StreamError(
                    "request aborted: constraint DFA state lost across "
                    "an out-of-pages requeue"))
                req.out_queue.put(None)
                return
            cont.fsm_resume = s
        self._retry.append(cont)

    def _loop(self):
        try:
            if self.device.type == "cuda":
                # the current CUDA device is per thread, like inference mode
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                self._loop_inner()
        except Exception as e:     # noqa: BLE001 — scheduler death must not
            # strand clients: fail every active and pending stream
            traceback.print_exc()
            # the lock pairs with submit(): once error is set under the
            # lock, no new request can slip into pending after the drain
            with self._lock:
                self.error = e
                for inflight in self._admitting:
                    inflight.out_queue.put(None)
                self._admitting = []
                for slot, req in enumerate(self.slots):
                    if req is not None:
                        req.out_queue.put(None)
                        self.slots[slot] = None
                for waiting in self._retry:
                    waiting.out_queue.put(None)
                self._retry = []
                while True:
                    try:
                        self.pending.get_nowait().out_queue.put(None)
                    except queue.Empty:
                        break

    def _admit_pending(self) -> bool:
        """Admit as many waiting requests as there are free slots.
        Prefix-cache hits admit immediately (suffix-only prefill); the
        rest are grouped by batched-prefill compatibility and admitted
        with one (G, L) prefill per group.  ``_hold_admission`` parks this
        phase to queue a burst that must land as one group; decode of
        active rows goes on."""
        admitted = False
        free = ([] if self._hold_admission else
                [s for s in range(self.max_batch) if self.slots[s] is None])
        fallthrough = []            # (req, slot) pairs needing full prefill
        retry, self._retry = self._retry, []
        while free:
            if retry:
                req = retry.pop(0)
            else:
                try:
                    req = self.pending.get_nowait()
                except queue.Empty:
                    break
            if req.cancelled:      # client stopped before admission
                req.out_queue.put(None)
                continue
            slot = free.pop(0)
            self._admitting.append(req)  # visible to the crash handler
            if self.index is not None:
                # True (admitted via cached prefix) or None (fall through
                # to full prefill — incl. under pool pressure, where
                # _insert_paged front-requeues)
                if self._try_admit_prefix(req, slot) is True:
                    self._admitting.remove(req)
                    admitted = True
                    continue
            fallthrough.append((req, slot))
        if retry:       # slots ran out first: keep waiting up front
            self._retry = retry + self._retry

        groups: Dict = {}
        for req, slot in fallthrough:
            groups.setdefault(self._group_key(req), []).append((req, slot))
        for key, members in groups.items():
            if key is None or len(members) == 1:
                for req, slot in members:
                    admitted |= self._admit(req, slot)
                    self._admitting.remove(req)
            else:
                admitted |= self._admit_group(members)
                for req, _ in members:
                    self._admitting.remove(req)
        return admitted

    def _state(self) -> PoolState:
        return PoolState(self.tokens, self.lengths, self.budget, self.active,
                         self.fsm_state)

    def _set_state(self, state: PoolState):
        self.tokens, self.lengths = state.tokens, state.lengths
        self.budget, self.active = state.budget, state.active
        self.fsm_state = state.fsm_state

    def _paged_round(self) -> torch.Tensor:
        self.decode_steps += self.chunk
        state, toks = paged_pool_decode(
            self.params["llama"], self.cfg.llama, self.gen_cfg, self.chunk,
            self.paged, self.tables, self._state(),
            use_kernel=self.use_kernel, generator=self._generator,
            fsm_allow=self.fsm_allow, fsm_trans=self.fsm_trans)
        self._set_state(state)
        return toks

    def _dense_round(self) -> torch.Tensor:
        """Advance all pool rows ``chunk`` tokens; inactive rows are
        masked."""
        self.decode_steps += self.chunk
        llama, gen_cfg = self.params["llama"], self.gen_cfg
        token, lengths, budget, active = (self.tokens, self.lengths,
                                          self.budget, self.active)
        toks = []
        for _ in range(self.chunk):
            embeds = embed_tokens(llama, token[:, None])
            hidden, _ = llama_forward(
                llama, self.cfg.llama, embeds, position_ids=lengths[:, None],
                attn_valid=active[:, None], cache=self.pool)
            logits = lm_head(llama, hidden[:, 0:1, :])[:, 0]
            nxt = _select_token(logits, gen_cfg, self._generator)
            # -1 marks "no token" for rows inactive this step — out of
            # band, so a genuinely sampled pad_token_id still reaches the
            # client and the host history stays in sync with the cache
            toks.append(torch.where(active, nxt, torch.full_like(nxt, -1)))
            nxt = torch.where(active, nxt,
                              torch.full_like(nxt, gen_cfg.pad_token_id))
            budget = torch.where(active, budget - 1, budget)
            active = active & (nxt != gen_cfg.eos_token_id) & (budget > 0)
            lengths = lengths + 1
            token = nxt
        self.tokens, self.lengths = token, lengths
        self.budget, self.active = budget, active
        return torch.stack(toks, dim=1)

    def _host_copy(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` that later in-place updates of the row state
        cannot reach: on a CUDA device an asynchronous copy into a pinned
        host buffer (ordered on the stream behind the round that produced
        ``t`` and before anything enqueued later), else a clone."""
        if t.device.type != "cuda":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _snapshot(self, toks, echo, t_round: float) -> _Round:
        rnd = _Round(self._host_copy(toks),
                     None if echo is None else self._host_copy(echo),
                     self._host_copy(self.active), list(self.slots), t_round)
        if self.device.type == "cuda":
            rnd.event = torch.cuda.Event()
            rnd.event.record()
        return rnd

    def _loop_inner(self):
        # Pipeline the paged decode rounds: enqueue round k+1 before
        # fetching round k's tokens, so the host work of a round (result
        # demux, admission bookkeeping, launching the next round's
        # kernels) overlaps the device instead of serializing with it.
        # Safe because (a) inactive rows write only the trash page,
        # (b) state updates between rounds (row activation, prefill
        # imports) are enqueued on the stream AFTER the in-flight round
        # and after the host copies of its results, and (c)
        # _process_round skips rows finalized since their snapshot.
        # Speculative decoding stays serial: its drafts are proposed from
        # host history, which pipelining would leave one round stale.
        pipelined = (self.backend == "paged" and self.spec_k == 0
                     and self.pipeline_rounds)
        # pipelined scheduling also defers admission finishes: prefill
        # results stay on the device until the next round's echo, so
        # admissions cost the host no sync at all
        self._defer_admit = pipelined
        inflight: Optional[_Round] = None
        while not self._stop:
            admitted = self._admit_pending()

            if pipelined:
                new_inflight = None
                if any(r is not None for r in self.slots):
                    self._ensure_pages(pipelined=True)
                if any(r is not None for r in self.slots):
                    self._sync_tables()
                    t_round = time.perf_counter()
                    echo = self.tokens
                    toks = self._paged_round()
                    new_inflight = self._snapshot(toks, echo, t_round)
                if inflight is not None:
                    self._process_round(inflight)
                elif new_inflight is None and not admitted:
                    time.sleep(0.005)
                inflight = new_inflight
                continue

            if not bool(self.active.any()):
                if not admitted:
                    time.sleep(0.005)
                continue

            t_round = time.perf_counter()
            if self.backend == "paged":
                self._ensure_pages()
                if not bool(self.active.any()):
                    continue
                self._sync_tables()
                if self.spec_k > 0:
                    # the verify block always takes the gather path: the
                    # paged kernel serves one query token per row
                    state, toks, n_emit = paged_spec_verify(
                        self.params["llama"], self.cfg.llama, self.gen_cfg,
                        self.spec_k, self.paged, self.tables, self._state(),
                        self._propose_drafts(), use_kernel=False)
                    self._set_state(state)
                    self.spec_stats["verify_steps"] += 1
                    self.decode_steps += 1
                    self.spec_stats["tokens_emitted"] += int(n_emit.sum())
                else:
                    toks = self._paged_round()
            else:
                # write_idx advances pool-wide each chunk; the write region
                # bounds the tokens decoded between resets
                if self.pool.write_idx + self.chunk > self.capacity:
                    self._retire_all("capacity exhausted")
                    continue
                toks = self._dense_round()
            self._process_round(self._snapshot(toks, None, t_round))

    def _process_round(self, rnd: _Round):
        """Fetch a dispatched round's results and demux them to clients.

        ``rnd.echo`` is the round's pre-round token vector (None on the
        non-pipelined paths): rows admitted asynchronously in the round's
        own iteration read their prefill first token from it here — their
        only host materialization.

        ``rnd.snap`` is the slot->request mapping AT DISPATCH TIME: under
        the pipelined loop a snapshot row may have been finalized since
        (finished/cancelled in the previous round's processing, requeued
        by _ensure_pages, or its slot re-admitted to a new request) — the
        ``self.slots[slot] is req`` guard skips those; the round carried
        only -1 sentinel lanes for them (inactive device-side), or, for a
        freed-while-in-flight row, wrote into pages whose next owner's
        prefill import is enqueued behind this round."""
        if rnd.event is not None:
            rnd.event.synchronize()     # this round only, not the next
        toks_np = rnd.toks.numpy()
        toks_in_np = None if rnd.echo is None else rnd.echo.numpy()
        active_np = rnd.active.numpy()
        rows = sum(1 for r in rnd.snap if r is not None)
        self._ev("decode_round",
                 ms=(time.perf_counter() - rnd.t_dispatch) * 1e3, rows=rows)
        self.occupancy["rounds"] += 1
        self.occupancy["active_rows"] += rows
        for slot, req in enumerate(rnd.snap):
            if req is None or self.slots[slot] is not req:
                continue
            if req.pending and toks_in_np is not None:
                self._emit_pending_first(req, int(toks_in_np[slot]))
            if req.cancelled:
                # client stopped mid-stream: retire the row now — the
                # tokens decoded this chunk are discarded, the budget
                # stops burning
                self.active[slot] = False
                self._retire(slot, req)
                continue
            row = toks_np[slot]
            # -1 is the device-side "no token" sentinel — filtering by
            # value would also drop real pad-id tokens and desync host
            # history from the cache
            row = row[row >= 0].astype(np.int32)
            if row.size:
                req.out_queue.put(row)
                req.emitted += row.size
                req.generated.extend(int(t) for t in row)
            if not active_np[slot]:
                self._retire(slot, req)

    def _retire(self, slot: int, req: _Request):
        """Free a finished row, then end its stream: a client that has seen
        the end of its stream finds the row's pages on the free list."""
        if self.slots[slot] is req:
            self.slots[slot] = None
        if self.backend == "paged":
            self.alloc.free_row(slot)
            self._tables_dirty = True
        req.out_queue.put(None)

    def _retire_all(self, reason: str):
        """Dense pool write region exhausted: reset it and re-admit every
        in-flight request with prompt+generated-so-far, so clients see an
        uninterrupted stream instead of a silent truncation that looks
        like a normal finish."""
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self.slots[slot] = None
            cont = self._continuation(req, reason)
            if cont is not None:
                self._retry.append(cont)
        self.active = torch.zeros_like(self.active)
        # reset the pool for a fresh write region
        self.pool = self._new_dense_pool()
