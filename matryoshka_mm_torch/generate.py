"""Autoregressive generation, PyTorch port of
``matryoshka_mm_tpu/generate.py``: ``generate`` (text-only, one image a
row, multi-image and anyres prompts, ``ver=v2`` combine-logits),
``stream_generate``, ``beam_generate``, ``speculative_generate`` and
``chunked_prefill``.

* Prefill: left-padded splice into ``L = round_up(T - 1 + n, 64)`` slots
  (text only: ``round_up(T, 64)``) of a KV cache with capacity
  ``L + max_new_tokens``; next-token logits from the last position.  A
  B=1 prompt with M sentinels and M images (``(M, 3, H, W)``) splices
  image i at sentinel i into ``round_up(T - M + M * n, 64)`` slots
  (:func:`prefill_multi`); a B=1 anyres tile stack ``(1, T_tiles, 3, H,
  W)`` with its ``image_sizes`` splices its exact merged count
  (``models/llava.py`` ``anyres_token_count``) into ``round_up(T - 1 +
  count, 64)`` slots (:func:`prefill_anyres`).  Each leaves the cache of
  a one-image prefill, so the decode is the same.
* Decode: chunks of ``decode_chunk`` steps run without a host round trip;
  the new slot is valid only for unfinished rows (``attn_valid=~finished``),
  finished rows emit ``pad_token_id``, and EOS / stopping criteria are
  checked on the host once per chunk.  Output shapes equal the JAX
  function's.  On a CUDA device the decode step is a captured CUDA graph
  (:class:`DecodeGraph`, the counterpart of the JAX package's jitted
  chunk): captured once a ``generate`` call, replayed once a step.
  :func:`decode_chunk` is the plain version, the Python loop of the same
  step; the CPU takes it, and so does ``generate(..., cuda_graph=False)``.
  ``generate`` and ``stream_generate`` run one loop, :func:`_decode_loop`,
  which yields the tokens so far after the first token and every chunk.
* ``ver=v2_numtoks=[n_1,...,n_K]_betas=[...]_gamma=g`` or ``..._pickby=
  entropy``: K prefills (:func:`prefill_scales`) into one cache of K * B
  rows, scale-major; each decode step runs one forward over the K * B rows
  and combines the K scales' logits of a row (:class:`LogitCombiner`)
  before the token is chosen.  The captured step takes it too.  Every
  scale's stream continues at the last scale's next position, as in the
  JAX package.  Unlike the JAX package, each scale's prefill takes the
  ``attention_mask``.
* ``beam_generate``: B=1 beam search with the HF hypothesis bank, eager on
  every device (the cache reorder is a gather along the beam axis).
* ``speculative_generate``: B=1 greedy prompt-lookup decoding; each verify
  step is one ``(1, k + 1)`` forward with ``attn_impl="reference"``, then
  one host sync to accept the drafts and rewind the cache's rejected tail.
* ``chunked_prefill``: a long prompt in fixed chunks against one cache,
  the flash kernel's ``q_index_offset`` at each chunk's first slot.
* Token choice: greedy argmax, or temperature / top-p sampling drawn from a
  ``torch.Generator``.
* ``numtoks=gateprobargmax``: the M3-MoE router picks the scale of a B=1
  request (:func:`gating_probs`, the argmax over ``cfg.tokscale_list``).

The S2 multi-scale tower (``models/clip.py`` ``s2_multiscale_forward``) is
ported as a function; neither package's ``generate`` calls it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .constants import IMAGE_TOKEN_INDEX
from .kvconfig import parse_kv_from_string, parse_list

from .config import LlavaConfig
from .models.llama import (KVCache, embed_tokens, init_kv_cache,
                           is_placed, llama_forward, lm_head)
from .models.llava import (anyres_token_count, encode_images,
                           prepare_multimodal, prepare_multimodal_anyres,
                           prepare_multimodal_multi, router_forward)
from .utils.cuda_graph import CapturedStep


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0
    do_sample: bool = False
    eos_token_id: int = 2
    pad_token_id: int = 0
    decode_chunk: int = 32


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _params_device(params: dict) -> torch.device:
    return params["llama"]["embed_tokens"].device


def rank_view(params: dict, cfg: LlavaConfig) -> tuple:
    """``(params, cfg)`` as this rank computes with them: weights placed
    over a mesh of ranks (``parallel/inference.py``) become the rank's view
    (``sharding.compute_view``); plain weights pass unchanged.  Every entry
    point below takes it first, so placed weights run eagerly through each
    (a collective cannot be captured in a CUDA graph)."""
    if not is_placed(params):
        return params, cfg
    from .parallel.sharding import compute_view

    return compute_view(params, cfg)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@torch.inference_mode()
def prefill_image(params: dict, cfg: LlavaConfig, input_ids: torch.Tensor,
                  pixel_values: torch.Tensor,
                  attn_mask: Optional[torch.Tensor], numtoks: int,
                  out_len: int, capacity: int,
                  cache: Optional[KVCache] = None
                  ) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """One image per row -> (last-position logits (B, V) f32, cache,
    next positions (B,)).  ``cache``, when given, is the empty cache of B
    rows to fill."""
    spliced, _ = prepare_multimodal(
        params, cfg, input_ids, pixel_values, numtoks=numtoks,
        attn_mask=attn_mask, out_len=out_len, padding_side="left")
    return _prefill_spliced(params, cfg, spliced, capacity, cache)


@torch.inference_mode()
def prefill_multi(params: dict, cfg: LlavaConfig, input_ids: torch.Tensor,
                  pixel_values: torch.Tensor, numtoks: int, out_len: int,
                  capacity: int
                  ) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """A (1, T) prompt with M sentinels and its M images (M, 3, H, W) ->
    as :func:`prefill_image`."""
    spliced, _ = prepare_multimodal_multi(
        params, cfg, input_ids, pixel_values, numtoks=numtoks,
        out_len=out_len, padding_side="left")
    return _prefill_spliced(params, cfg, spliced, capacity)


@torch.inference_mode()
def prefill_anyres(params: dict, cfg: LlavaConfig, input_ids: torch.Tensor,
                   pixel_values: torch.Tensor, image_size, numtoks: int,
                   out_len: int, capacity: int
                   ) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """A (1, T) prompt with one sentinel and the anyres tile stack
    (T_tiles, 3, H, W) of an image of ``image_size`` (width, height) ->
    as :func:`prefill_image`."""
    spliced = prepare_multimodal_anyres(
        params, cfg, input_ids, pixel_values, image_size, numtoks=numtoks,
        out_len=out_len, padding_side="left")
    return _prefill_spliced(params, cfg, spliced, capacity)


def _prefill_spliced(params: dict, cfg: LlavaConfig, spliced,
                     capacity: int, cache: Optional[KVCache] = None
                     ) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    B, L, _ = spliced.embeds.shape
    if cache is None:
        cache = init_kv_cache(cfg.llama, B, capacity,
                              device=spliced.embeds.device)
    hidden, cache = llama_forward(
        params["llama"], cfg.llama, spliced.embeds,
        position_ids=spliced.position_ids, attn_valid=spliced.attn_mask,
        cache=cache)
    logits = lm_head(params["llama"], hidden[:, -1:, :])[:, 0]
    return logits, cache, torch.clamp(spliced.lengths, max=L)


@torch.inference_mode()
def prefill_text(params: dict, cfg: LlavaConfig, input_ids: torch.Tensor,
                 attn_mask: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """Text-only prompt, already left-padded to its bucket length."""
    B = input_ids.shape[0]
    embeds = embed_tokens(params["llama"], input_ids)
    pos = torch.clamp(attn_mask.int().cumsum(dim=1) - 1, min=0)
    cache = init_kv_cache(cfg.llama, B, capacity, device=input_ids.device)
    hidden, cache = llama_forward(params["llama"], cfg.llama, embeds,
                                  position_ids=pos, attn_valid=attn_mask,
                                  cache=cache)
    logits = lm_head(params["llama"], hidden[:, -1:, :])[:, 0]
    return logits, cache, attn_mask.int().sum(dim=1)


def _cache_rows(cache: KVCache, rows: slice) -> KVCache:
    """The rows ``rows`` of ``cache`` as a cache of their own, a view that
    writes into ``cache``, with its own write slot at 0."""
    def part(t, dim):
        return None if t is None else t[(slice(None),) * dim + (rows,)]

    return KVCache(part(cache.k, 1), part(cache.v, 1), part(cache.valid, 0),
                   part(cache.positions, 0), 0, part(cache.k_scale, 1),
                   part(cache.v_scale, 1))


@torch.inference_mode()
def prefill_scales(params: dict, cfg: LlavaConfig, input_ids: torch.Tensor,
                   pixel_values: torch.Tensor,
                   attn_mask: Optional[torch.Tensor], scales, out_len: int,
                   capacity: int
                   ) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """``ver=v2``: one :func:`prefill_image` a scale of ``scales``, all at
    ``out_len`` slots, into the rows ``[k B, (k + 1) B)`` of one cache of
    K * B rows (scale-major: the JAX package's caches stacked on the batch
    axis, int8 scales included) -> ((K, B, V) logits, the cache, (K * B,)
    next positions).  The next positions are the last scale's, tiled K
    times, as the JAX package's decode takes them."""
    B, K = input_ids.shape[0], len(scales)
    cache = init_kv_cache(cfg.llama, K * B, capacity,
                          device=input_ids.device)
    logits = []
    for k, n in enumerate(scales):
        lg, _, lengths = prefill_image(
            params, cfg, input_ids, pixel_values, attn_mask, n, out_len,
            capacity, cache=_cache_rows(cache, slice(k * B, (k + 1) * B)))
        logits.append(lg)
    cache.set_write_idx(out_len)
    return torch.stack(logits), cache, lengths.repeat(K)


def _prefill_dispatch(params, cfg: LlavaConfig, input_ids: torch.Tensor,
                      pixel_values, attention_mask, numtoks,
                      gen_cfg: GenerationConfig, image_sizes=None):
    """Prompt prefill for the text-only, anyres-tiled (B=1, an unpadded
    prompt; ``image_sizes`` defaults to the tile size) and
    one-image-per-row cases."""
    B, T = input_ids.shape
    dev = input_ids.device
    mask_np = None if attention_mask is None else \
        np.asarray(attention_mask, bool)
    mask = None if mask_np is None else torch.as_tensor(mask_np, device=dev)
    if pixel_values is None:
        text_cap = _round_up(T, 64)
        pad = text_cap - T
        ids_p = torch.nn.functional.pad(input_ids, (pad, 0))
        m = torch.ones((B, T), dtype=torch.bool, device=dev) \
            if mask is None else mask
        m = torch.nn.functional.pad(m, (pad, 0))
        return prefill_text(params, cfg, ids_p, m,
                            text_cap + gen_cfg.max_new_tokens)
    n = numtoks if numtoks is not None else cfg.vision.num_patches
    if pixel_values.dim() == 5:
        if B != 1:
            raise ValueError("anyres generation supports batch_size=1")
        if mask_np is not None and not mask_np.all():
            raise ValueError("anyres prompts must be unpadded")
        tiles = pixel_values[0]
        size = tuple(image_sizes[0]) if image_sizes else \
            (cfg.vision.image_size, cfg.vision.image_size)
        L = _round_up(T - 1 + anyres_token_count(cfg, size, tiles.shape[0],
                                                 n), 64)
        return prefill_anyres(params, cfg, input_ids, tiles, size, n, L,
                              L + gen_cfg.max_new_tokens)
    L = _round_up(T - 1 + n, 64)
    return prefill_image(params, cfg, input_ids, pixel_values, mask, n, L,
                         L + gen_cfg.max_new_tokens)


@torch.inference_mode()
def chunked_prefill(params: dict, cfg: LlavaConfig, embeds: torch.Tensor,
                    position_ids: torch.Tensor, attn_valid: torch.Tensor,
                    capacity: int, chunk: int = 512
                    ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill ``(B, S, D)`` embeddings in chunks of ``chunk`` positions
    against one cache of ``capacity`` slots -> (last-position logits
    (B, V) f32, the cache).  Activations scale with ``chunk``, not ``S``;
    chunk i attends to the cache with ``q_index_offset = i * chunk``, so
    the flash kernel's index causality stays exact."""
    params, cfg = rank_view(params, cfg)
    B, S, _ = embeds.shape
    if S % chunk:
        raise ValueError(f"chunked_prefill: {S} positions are not a "
                         f"multiple of chunk={chunk}")
    cache = init_kv_cache(cfg.llama, B, capacity, device=embeds.device)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        hidden, cache = llama_forward(
            params["llama"], cfg.llama, embeds[:, sl],
            position_ids=position_ids[:, sl], attn_valid=attn_valid[:, sl],
            cache=cache, q_index_offset=i * chunk)
    return lm_head(params["llama"], hidden[:, -1:, :])[:, 0], cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _select_token(logits: torch.Tensor, gen_cfg: GenerationConfig,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax, or a temperature / top-p sample, from (B, V) logits."""
    if not gen_cfg.do_sample or gen_cfg.temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits / gen_cfg.temperature
    if gen_cfg.top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        cutoff_idx = (cum < gen_cfg.top_p).sum(dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # torch.multinomial's own draw of one sample, written out (an
    # exponential race: the same tokens from the same generator state),
    # which keeps multinomial's checks of the distribution out of a
    # captured step
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / race).argmax(dim=-1).to(torch.int32)


class LogitCombiner:
    """The ``ver=v2`` combination of K scales' next-token logits, (K, B, V)
    float32 -> (B, V) (the JAX ``_combine_logits``), for the parsed spec
    ``kvs``:

    * ``betas=[b_1,...,b_K]``: the weighted sum; with ``gamma > 0`` a token
      whose last-scale logit lies below ``log(gamma) + max(sum)`` gets
      -inf;
    * ``pickby=entropy``: each row takes the logits of its scale of least
      entropy.

    The weights live on ``device`` from the start, so the call adds no
    host-to-device copy to a captured step."""

    def __init__(self, kvs: dict, device):
        self.scales = [int(x) for x in parse_list(kvs["numtoks"])]
        self.K = len(self.scales)
        self.betas = self.log_gamma = None
        if "betas" in kvs:
            betas = [float(b) for b in parse_list(kvs["betas"])]
            if len(betas) != self.K:
                raise ValueError(f"v2 spec: {len(betas)} betas for "
                                 f"{self.K} scales")
            self.betas = torch.tensor(betas, dtype=torch.float32,
                                      device=device)[:, None, None]
            gamma = float(kvs.get("gamma", 0))
            if gamma > 0:
                self.log_gamma = math.log(gamma)
        elif kvs.get("pickby") != "entropy":
            raise ValueError("v2 spec needs betas=... or pickby=entropy")

    def __call__(self, logits_k: torch.Tensor) -> torch.Tensor:
        if self.betas is not None:
            combined = (self.betas * logits_k).sum(dim=0)
            if self.log_gamma is not None:
                cutoff = self.log_gamma + combined.amax(dim=-1, keepdim=True)
                combined = combined.masked_fill(logits_k[-1] < cutoff,
                                                float("-inf"))
            return combined
        probs = torch.softmax(logits_k, dim=-1)
        entropy = -(probs * torch.log_softmax(logits_k, dim=-1)).sum(-1)
        best = entropy.argmin(dim=0)                              # (B,)
        return logits_k.gather(
            0, best[None, :, None].expand(1, *logits_k.shape[1:]))[0]


def _decode_step(params: dict, cfg: LlavaConfig, gen_cfg: GenerationConfig,
                 cache: KVCache, token: torch.Tensor, lengths: torch.Tensor,
                 finished: torch.Tensor,
                 generator: Optional[torch.Generator],
                 combine: Optional[LogitCombiner] = None):
    """One decode step -> ``(token, lengths, finished, logits (B, V) f32)``;
    the cache advances in place.  With ``combine`` (``ver=v2``) the cache
    and ``lengths`` hold K * B rows, scale-major: each row's token and
    ``finished`` go to its K streams, and their logits are combined."""
    rows, rows_fin = token, finished
    if combine is not None:
        rows, rows_fin = token.repeat(combine.K), finished.repeat(combine.K)
    embeds = embed_tokens(params["llama"], rows[:, None])
    hidden, _ = llama_forward(
        params["llama"], cfg.llama, embeds, position_ids=lengths[:, None],
        attn_valid=~rows_fin[:, None], cache=cache)
    logits = lm_head(params["llama"], hidden[:, 0:1, :])[:, 0]
    if combine is not None:
        logits = combine(logits.reshape(combine.K, token.shape[0], -1))
    nxt = _select_token(logits, gen_cfg, generator)
    nxt = torch.where(finished, gen_cfg.pad_token_id, nxt)
    return (nxt, lengths + 1, finished | (nxt == gen_cfg.eos_token_id),
            logits)


@torch.inference_mode()
def decode_chunk(params: dict, cfg: LlavaConfig, gen_cfg: GenerationConfig,
                 cache: KVCache, token: torch.Tensor, lengths: torch.Tensor,
                 finished: torch.Tensor, steps: int,
                 generator: Optional[torch.Generator] = None,
                 return_logits: bool = False,
                 combine: Optional[LogitCombiner] = None):
    """Run ``steps`` decode steps on the device with no host sync: the
    plain version of :class:`DecodeGraph`.  ``lengths`` is each row's next
    position.  Returns ``(token, lengths, finished, tokens (B, steps))``,
    and the last step's logits ``(B, V)`` after them with
    ``return_logits``; the cache advances in place."""
    toks = []
    for _ in range(steps):
        token, lengths, finished, logits = _decode_step(
            params, cfg, gen_cfg, cache, token, lengths, finished, generator,
            combine)
        toks.append(token)
    out = (token, lengths, finished, torch.stack(toks, dim=1))
    return out + (logits,) if return_logits else out


class DecodeGraph:
    """The decode step of one ``generate`` call as a captured CUDA graph:
    the counterpart of the JAX package's jitted decode chunks
    (``matryoshka_mm_tpu/generate.py:152``, and ``:209`` for ``ver=v2``).

    The step is :func:`_decode_step` over static buffers it advances in
    place (``token``, ``lengths``, ``finished``; ``logits`` holds the last
    step's, ``toks`` the chunk's tokens at column ``col``, a device index)
    and over the KV cache, whose write slot is a device scalar.  With
    ``combine`` the cache and ``lengths`` hold the K * B rows of a
    ``ver=v2`` request and ``logits`` the combined (B, V).
    :meth:`run` warms the step up and captures it at its first call (the
    warm-up is the chunk's first step), then replays it once a step; the
    cache's host count follows.  :meth:`step` is the same step run eagerly,
    which works on any device."""

    def __init__(self, params: dict, cfg: LlavaConfig,
                 gen_cfg: GenerationConfig, cache: KVCache,
                 token: torch.Tensor, lengths: torch.Tensor,
                 finished: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 combine: Optional[LogitCombiner] = None):
        B, dev = token.shape[0], token.device
        self._args = (params, cfg, gen_cfg, cache)
        self.cache = cache
        self.generator = generator
        self.combine = combine
        self.token = token.clone()
        self.lengths = lengths.clone()
        self.finished = finished.clone()
        self.logits = torch.zeros((B, cfg.llama.vocab_size),
                                  dtype=torch.float32, device=dev)
        self.toks = torch.zeros((B, gen_cfg.decode_chunk), dtype=torch.int32,
                                device=dev)
        self.col = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.graph: Optional[CapturedStep] = None

    @torch.inference_mode()
    def step(self) -> None:
        """One decode step, the buffers advanced in place."""
        token, lengths, finished, logits = _decode_step(
            *self._args, self.token, self.lengths, self.finished,
            self.generator, self.combine)
        self.toks.index_copy_(1, self.col, token[:, None])
        self.col.add_(1)
        self.token.copy_(token)
        self.lengths.copy_(lengths)
        self.finished.copy_(finished)
        self.logits.copy_(logits)

    def _rewind(self) -> None:
        # recording the step runs its Python again, the cache's host count
        # with it, for a step that does not run then
        self.cache.host_idx -= 1

    def release(self) -> None:
        """Destroy the captured graph (``CapturedStep.release``)."""
        if self.graph is not None:
            self.graph.release()

    @torch.inference_mode()
    def run(self, steps: int) -> torch.Tensor:
        """``steps`` decode steps on the card with no host sync -> the
        chunk's tokens ``(B, steps)``, a view of ``toks`` that the next
        call overwrites."""
        cache = self.cache
        if not 1 <= steps <= self.toks.shape[1]:
            raise ValueError(f"DecodeGraph: {steps} steps, a chunk holds 1 "
                             f"to {self.toks.shape[1]}")
        if cache.host_idx + steps > cache.valid.shape[1]:
            raise ValueError(f"KV cache full: {cache.host_idx} + {steps} > "
                             f"{cache.valid.shape[1]}")
        self.col.zero_()
        done = 0
        if self.graph is None:
            self.graph = CapturedStep(self.step, self.token.device,
                                      generator=self.generator,
                                      rewind=self._rewind)
            done = 1
        for _ in range(steps - done):
            self.graph.replay()
            cache.host_idx += 1
        return self.toks[:, :steps]


def _decode_loop(params, cfg, gen_cfg: GenerationConfig, cache, first,
                 lengths, generator, stopping_criteria, cuda_graph: bool,
                 combine: Optional[LogitCombiner] = None):
    """The decode after the first token ``first``, a generator: yields the
    trimmed tokens so far (B, n) after the first token and after every
    chunk; it ends when every row has finished, ``stopping_criteria``
    accepts row 0 (checked after each chunk) or the budget is spent."""
    finished = first == gen_cfg.eos_token_id
    out_tokens = [first.cpu().numpy()[:, None]]
    yield _trim(out_tokens[0], gen_cfg)
    steps_done = 1
    token = first
    graph = DecodeGraph(params, cfg, gen_cfg, cache, first, lengths,
                        finished, generator, combine) \
        if cuda_graph and first.device.type == "cuda" \
        and gen_cfg.max_new_tokens > 1 else None
    try:
        while steps_done < gen_cfg.max_new_tokens:
            nsteps = min(gen_cfg.decode_chunk,
                         gen_cfg.max_new_tokens - steps_done)
            if graph is None:
                token, lengths, finished, toks = decode_chunk(
                    params, cfg, gen_cfg, cache, token, lengths, finished,
                    nsteps, generator, combine=combine)
            else:
                toks, finished = graph.run(nsteps), graph.finished
            steps_done += nsteps
            out_tokens.append(toks.cpu().numpy())     # one sync per chunk
            out = np.concatenate(out_tokens, axis=1)
            yield _trim(out, gen_cfg)
            if bool(finished.all()):
                break
            if stopping_criteria is not None and \
                    stopping_criteria(list(out[0])):
                break
    finally:
        if graph is not None:      # while no other thread captures
            graph.release()


def _trim(tokens: np.ndarray, gen_cfg: GenerationConfig) -> np.ndarray:
    """Cut everything at and after the first EOS of each row (pad after)."""
    out = tokens.astype(np.int32, copy=True)
    for b in range(out.shape[0]):
        eos = np.where(out[b] == gen_cfg.eos_token_id)[0]
        if eos.size:
            out[b, eos[0]:] = gen_cfg.pad_token_id
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

GATE = "gateprobargmax"


def _parse_scale(spec: Optional[str]):
    """``(numtoks, v2)``: the fixed scale of ``spec`` (None for the full
    grid, or ``GATE``), and the parsed keys of a ``ver=v2`` spec (else
    None)."""
    if not spec:
        return None, None
    kvs = parse_kv_from_string(spec)
    if kvs["ver"] == "v2":
        return None, kvs
    if kvs["numtoks"] == GATE:
        return GATE, None
    return int(kvs["numtoks"]), None


@torch.inference_mode()
def gating_probs(params: dict, cfg: LlavaConfig,
                 pixel_values) -> Optional[torch.Tensor]:
    """(B, K) float32 router probabilities over ``cfg.tokscale_list``: the
    CLIP tower once, then the router; None when the config is not
    M3-MoE."""
    params, cfg = rank_view(params, cfg)
    device = params["vision_tower"]["class_embedding"].device
    px = torch.as_tensor(np.asarray(pixel_values, np.float32)) \
        if not isinstance(pixel_values, torch.Tensor) else pixel_values
    px = px.to(device=device, dtype=torch.float32)
    return router_forward(params, cfg, encode_images(params, cfg, px))


def _gate_scale(params: dict, cfg: LlavaConfig, pixel_values) -> int:
    """The scale the M3-MoE router picks for a B=1 request's image."""
    if pixel_values is None or not cfg.is_m3_moe:
        raise ValueError("gateprobargmax needs an image and an M3-MoE "
                         "config (its router picks the scale)")
    if pixel_values.ndim != 4:
        # the JAX package's CLIP tower fails to reshape a tile stack
        # with this TypeError
        raise TypeError(f"gateprobargmax reads one image a row: cannot "
                        f"reshape pixels of shape "
                        f"{tuple(pixel_values.shape)} into patches")
    gp = gating_probs(params, cfg, pixel_values)
    return cfg.tokscale_list[int(gp[0].argmax())]


def _generate_stream(params: dict, cfg: LlavaConfig, input_ids,
                     pixel_values, image_sizes, attention_mask, spec,
                     gen_cfg: GenerationConfig, stopping_criteria,
                     generator: Optional[torch.Generator], cuda_graph: bool):
    """Check the request, prefill, then :func:`_decode_loop`'s yields.
    Weights placed over a mesh of ranks (``parallel/inference.py``) run as
    this rank's view of them (:func:`rank_view`), eagerly."""
    if is_placed(params):
        params, cfg = rank_view(params, cfg)
        cuda_graph = False
    device = _params_device(params)
    ids_np = np.asarray(input_ids, np.int64)
    B, T = ids_np.shape
    numtoks, v2 = _parse_scale(spec)
    multi = False
    if pixel_values is None:
        v2 = None        # the JAX package decodes a text prompt at v0
    else:
        pixel_values = np.asarray(pixel_values, np.float32)
        # M images for the M sentinels of one prompt
        multi = (pixel_values.ndim == 4 and B == 1
                 and pixel_values.shape[0] > 1)
        if v2 is not None and multi:
            raise ValueError("ver=v2 combine-logits supports one image per "
                             "sample (multi-image prompts use ver=v0)")
        if v2 is not None and pixel_values.ndim != 4:
            # the JAX package takes no anyres branch under v2: its CLIP
            # tower fails to reshape the tile stack with this TypeError
            raise TypeError(f"ver=v2 reads one image a row: cannot reshape "
                            f"pixels of shape {pixel_values.shape} into "
                            f"patches")
        multi = multi and pixel_values.shape[0] == int(
            (ids_np == IMAGE_TOKEN_INDEX).sum())
    combine = None if v2 is None else LogitCombiner(v2, device)
    if numtoks == GATE and B != 1:
        raise ValueError("gateprobargmax supports batch_size=1 only")
    if generator is None and gen_cfg.do_sample:
        generator = torch.Generator(device=device).manual_seed(0)
    input_ids = torch.as_tensor(ids_np, device=device)
    if pixel_values is not None:
        pixel_values = torch.as_tensor(pixel_values, device=device)
    if numtoks == GATE:
        numtoks = _gate_scale(params, cfg, pixel_values)

    if combine is not None:
        L = _round_up(T - 1 + max(combine.scales), 64)
        mask = None if attention_mask is None else torch.as_tensor(
            np.asarray(attention_mask, bool), device=device)
        logits_k, cache, lengths = prefill_scales(
            params, cfg, input_ids, pixel_values, mask, combine.scales, L,
            L + gen_cfg.max_new_tokens)
        logits = combine(logits_k)
    elif multi:
        n = numtoks if numtoks is not None else cfg.vision.num_patches
        M = pixel_values.shape[0]
        L = _round_up(T - M + M * n, 64)
        logits, cache, lengths = prefill_multi(
            params, cfg, input_ids, pixel_values, n, L,
            L + gen_cfg.max_new_tokens)
    else:
        logits, cache, lengths = _prefill_dispatch(
            params, cfg, input_ids, pixel_values, attention_mask, numtoks,
            gen_cfg, image_sizes)
    first = _select_token(logits, gen_cfg, generator)
    yield from _decode_loop(params, cfg, gen_cfg, cache, first, lengths,
                            generator, stopping_criteria, cuda_graph,
                            combine)


@torch.inference_mode()
def generate(
    params: dict,
    cfg: LlavaConfig,
    input_ids,                                    # (B, T)
    pixel_values=None,            # (B, 3, H, W), (M, 3, H, W) or
    *,                            # (1, T_tiles, 3, H, W)
    image_sizes=None,                             # [(w, h), ...] for anyres
    attention_mask=None,                          # (B, T) for padded batches
    matryoshka_vis_token_scale: Optional[str] = None,
    gen_cfg: GenerationConfig = GenerationConfig(),
    stopping_criteria=None,
    generator: Optional[torch.Generator] = None,
    cuda_graph: bool = True,
) -> np.ndarray:
    """Generate token ids; returns the (B, <= max_new_tokens) generated
    suffixes as int32 numpy.  ``matryoshka_vis_token_scale`` is
    ``ver=v0_numtoks=N`` for a fixed scale, ``ver=v0_numtoks=gateprobargmax``
    for the router's pick (B=1, M3-MoE configs), ``ver=v2_numtoks=[...]``
    with ``betas=[...]`` (and ``gamma``) or ``pickby=entropy`` for the
    combined logits of several scales (one image a row; a text prompt
    decodes as v0), or None for the full grid.  ``pixel_values`` is one
    image a row; at B=1, M images for a prompt with M sentinels; or an
    anyres tile stack of one image, with its ``image_sizes``.
    Sampling draws from ``generator`` (a new one seeded with 0 on the
    model's device when None).  On a CUDA device the decode replays a
    captured step (:class:`DecodeGraph`) unless ``cuda_graph=False`` asks
    for the eager loop (:func:`decode_chunk`); the CPU always takes the
    eager loop."""
    for out in _generate_stream(params, cfg, input_ids, pixel_values,
                                image_sizes, attention_mask,
                                matryoshka_vis_token_scale, gen_cfg,
                                stopping_criteria, generator, cuda_graph):
        pass
    return out


@torch.inference_mode()
def stream_generate(
    params: dict,
    cfg: LlavaConfig,
    input_ids,
    pixel_values=None,
    *,
    image_sizes=None,
    matryoshka_vis_token_scale: Optional[str] = None,
    gen_cfg: GenerationConfig = GenerationConfig(),
    generator: Optional[torch.Generator] = None,
    cuda_graph: bool = True,
):
    """A generator of the cumulative generated ids (B, n), trimmed as
    ``generate`` trims them: once after the first token, then once after
    every decode chunk (the JAX ``stream_generate``, the counterpart of
    HF's ``TextIteratorStreamer`` in the reference worker).  Text-only,
    one image a row, multi-image and anyres prompts take ``generate``'s
    prefill and its decode loop, the captured step included; a ``ver=v2``
    spec yields ``generate``'s result once."""
    if matryoshka_vis_token_scale and _parse_scale(
            matryoshka_vis_token_scale)[1] is not None:
        yield generate(params, cfg, input_ids, pixel_values,
                       image_sizes=image_sizes,
                       matryoshka_vis_token_scale=matryoshka_vis_token_scale,
                       gen_cfg=gen_cfg, generator=generator,
                       cuda_graph=cuda_graph)
        return
    yield from _generate_stream(params, cfg, input_ids, pixel_values,
                                image_sizes, None,
                                matryoshka_vis_token_scale, gen_cfg, None,
                                generator, cuda_graph)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def _reorder_cache(cache: KVCache, parent: torch.Tensor) -> KVCache:
    """The cache with its rows gathered by ``parent`` (beam i takes row
    ``parent[i]``): K/V and the int8 scales along axis 1, ``valid`` and
    ``positions`` along axis 0; the write slot is shared."""
    def take(t, dim):
        return None if t is None else t.index_select(dim, parent)

    return KVCache(take(cache.k, 1), take(cache.v, 1), take(cache.valid, 0),
                   take(cache.positions, 0), cache.write_idx,
                   take(cache.k_scale, 1), take(cache.v_scale, 1),
                   host_idx=cache.host_idx)


def _beam_steps(params: dict, cfg: LlavaConfig, gen_cfg: GenerationConfig,
                num_beams: int, steps: int, length_penalty: float,
                cache: KVCache, token, lengths, scores, bank_norm,
                bank_seqs, done):
    """``steps`` beam steps on the device, with no host sync (the JAX
    ``_beam_decode_fn``).  Each step takes the top ``2 * num_beams`` flat
    candidates; an EOS candidate ranked inside the top ``num_beams`` enters
    the hypothesis bank (replace-worst, its score normalized by its
    generated length counting the EOS, HF ``BeamHypotheses.add``) unless
    the search is ``done``; the live beams refill with the best non-EOS
    candidates, and the cache follows their parents.  ``done`` is HF's
    ``early_stopping=False`` criterion: the bank is full and the best
    candidate cannot beat its worst.  Returns ``(scores, history, bank
    scores, bank sequences, done)``."""
    dev = token.device
    eos, k2 = gen_cfg.eos_token_id, 2 * num_beams
    hist = torch.full((num_beams, steps + 1), gen_cfg.pad_token_id,
                      dtype=torch.int32, device=dev)
    hist[:, 0] = token
    live = torch.ones((num_beams, 1), dtype=torch.bool, device=dev)
    for i in range(steps):
        embeds = embed_tokens(params["llama"], token[:, None])
        hidden, _ = llama_forward(params["llama"], cfg.llama, embeds,
                                  position_ids=lengths[:, None],
                                  attn_valid=live, cache=cache)
        logits = lm_head(params["llama"], hidden[:, 0:1, :])[:, 0]
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
        cand_scores, cand_idx = torch.topk((scores[:, None] + logp).reshape(-1),
                                           k2)
        cand_parent = cand_idx // V
        cand_tok = (cand_idx % V).to(torch.int32)
        is_eos = cand_tok == eos
        # the bank normalizes by the generated length, the EOS counted
        denom = float(np.float32(i + 2) ** np.float32(length_penalty))
        for r in range(num_beams):
            norm_r = cand_scores[r:r + 1] / denom
            worst = bank_norm.argmin().reshape(1)
            take = is_eos[r:r + 1] & ~done & \
                (norm_r > bank_norm.index_select(0, worst))
            bank_norm = torch.where(take, bank_norm.index_copy(0, worst,
                                                               norm_r),
                                    bank_norm)
            seq_r = hist.index_select(0, cand_parent[r:r + 1])
            seq_r[:, i + 1] = eos
            bank_seqs = torch.where(take[:, None],
                                    bank_seqs.index_copy(0, worst, seq_r),
                                    bank_seqs)
        # live slots: the best non-EOS candidates in order (each beam offers
        # at most one EOS among its top 2N, so N of them always exist); EOS
        # candidates and the ones past N land in slots that are cut off
        keep = ~is_eos
        slot = torch.where(keep, keep.cumsum(0) - 1, k2)

        def fill(values, dtype, base):
            return torch.full((k2 + 1,), base, dtype=dtype, device=dev) \
                .scatter(0, slot, values.to(dtype))[:num_beams]

        new_scores = fill(cand_scores, torch.float32, float("-inf"))
        parent = fill(cand_parent, torch.int64, 0)
        nxt = fill(cand_tok, torch.int32, 0)
        bank_full = (bank_norm > float("-inf")).all()
        done = done | (bank_full & (bank_norm.min()
                                    >= cand_scores[0] / denom))
        hist = hist.index_select(0, parent)
        hist[:, i + 1] = nxt
        cache = _reorder_cache(cache, parent)
        token, lengths, scores = nxt, lengths + 1, new_scores
    return scores, hist, bank_norm, bank_seqs, done


@torch.inference_mode()
def beam_generate(
    params: dict,
    cfg: LlavaConfig,
    input_ids,                                    # (1, T)
    pixel_values=None,                # (1, 3, H, W) | (1, T_tiles, 3, H, W)
    *,
    image_sizes=None,                             # [(w, h)] for anyres
    attention_mask=None,                          # (1, T) for padded rows
    matryoshka_vis_token_scale: Optional[str] = None,
    num_beams: int = 3,
    gen_cfg: GenerationConfig = GenerationConfig(),
    length_penalty: float = 1.0,
    stopping_criteria=None,
) -> np.ndarray:
    """Beam search at B=1 (the reference's HF ``generate(num_beams=N)``
    behind ``--num-beams``) -> the best hypothesis's (1, <= max_new_tokens)
    suffix.  Deterministic; scores are summed log-probs normalized by
    ``len ** length_penalty`` (the HF convention).  The search runs on the
    device with one host sync at its end (:func:`_beam_steps`, eager on
    every device); the first step's seeding and the finalisation run on
    the host, and ``stopping_criteria`` cuts the chosen hypothesis at the
    earliest prefix it accepts, after the search."""
    params, cfg = rank_view(params, cfg)
    device = _params_device(params)
    ids_np = np.asarray(input_ids, np.int64)
    B, T = ids_np.shape
    if B != 1:
        raise ValueError("beam search supports batch_size=1")
    numtoks, v2 = _parse_scale(matryoshka_vis_token_scale)
    if v2 is not None:
        raise ValueError("ver=v2 combine-logits does not compose with beam "
                         "search; use ver=v0")
    if pixel_values is not None:
        pixel_values = np.asarray(pixel_values, np.float32)
        if pixel_values.ndim == 4 and pixel_values.shape[0] != 1:
            raise ValueError("beam search supports one image per prompt")
        pixel_values = torch.as_tensor(pixel_values, device=device)
    if numtoks == GATE:
        numtoks = _gate_scale(params, cfg, pixel_values)
    logits, cache, lengths = _prefill_dispatch(
        params, cfg, torch.as_tensor(ids_np, device=device), pixel_values,
        attention_mask, numtoks, gen_cfg, image_sizes)

    # seed with the steps' 2N-candidate protocol: EOS candidates ranked
    # inside the top num_beams go straight to the bank (generated length
    # 1, the EOS counted), the live beams take the best non-EOS candidates
    eos, pad = gen_cfg.eos_token_id, gen_cfg.pad_token_id
    steps = gen_cfg.max_new_tokens - 1
    logp0 = torch.log_softmax(logits[0].float(), dim=-1).cpu().numpy()
    seed_order = np.argsort(-logp0)[: 2 * num_beams]
    bank_norm0 = np.full((num_beams,), -np.inf, np.float32)
    bank_seqs0 = np.full((num_beams, max(steps, 0) + 1), pad, np.int32)
    live_scores, live_toks = [], []
    for r, t in enumerate(seed_order):
        if int(t) == eos:
            if r < num_beams:
                worst = int(bank_norm0.argmin())
                if logp0[t] > bank_norm0[worst]:
                    bank_norm0[worst] = logp0[t]
                    bank_seqs0[worst, 0] = eos
            continue
        if len(live_toks) < num_beams:
            live_scores.append(logp0[t])
            live_toks.append(int(t))
    done0 = bool(np.all(bank_norm0 > -np.inf)
                 and bank_norm0.min() >= logp0[seed_order[0]])
    scores = np.asarray(live_scores, np.float64)
    seqs = np.asarray(live_toks, np.int32)[:, None]
    bank_norm, bank_seqs, done = bank_norm0, bank_seqs0, done0
    if steps > 0:
        def dev(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        def beams(t, dim):
            return None if t is None else t.repeat_interleave(num_beams, dim)

        cache_b = KVCache(beams(cache.k, 1), beams(cache.v, 1),
                          beams(cache.valid, 0), beams(cache.positions, 0),
                          cache.write_idx, beams(cache.k_scale, 1),
                          beams(cache.v_scale, 1), host_idx=cache.host_idx)
        del cache
        out = _beam_steps(
            params, cfg, gen_cfg, num_beams, steps, length_penalty, cache_b,
            dev(live_toks, torch.int32), beams(lengths, 0),
            dev(live_scores, torch.float32), dev(bank_norm0, torch.float32),
            dev(bank_seqs0, torch.int32), dev(done0, torch.bool))
        scores, seqs, bank_norm, bank_seqs, done = (
            t.cpu().numpy() for t in out)           # the one sync
        scores = scores.astype(np.float64)
        bank_norm = bank_norm.astype(np.float64)
        done = bool(done)

    # HF finalisation: the live beams join the bank unless the search
    # stopped early, normalized by their generated length (steps + 1)
    live_norm = scores / float(steps + 1) ** length_penalty
    if done:
        cand_norm, cand_seqs = bank_norm, bank_seqs
    else:
        cand_norm = np.concatenate([bank_norm, live_norm])
        cand_seqs = np.concatenate([bank_seqs, seqs], axis=0)
    best = _trim(cand_seqs[int(cand_norm.argmax())][None], gen_cfg)
    if stopping_criteria is not None:
        # cut at the earliest prefix the criteria accepts (the reference
        # halts the whole search there)
        row = list(best[0])
        for i in range(1, len(row) + 1):
            if stopping_criteria(row[:i]):
                best = best[:, :i]
                break
    return best


# ---------------------------------------------------------------------------
# speculative decoding (prompt lookup)
# ---------------------------------------------------------------------------

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


def _buffer_propose(buf: np.ndarray, n_buf: int, cur: int, k: int,
                    ngram: int) -> list:
    """The default draft (the JAX ``_pld_loop_fn``'s ``propose``): the k
    tokens of the fixed-length buffer ``buf`` after the latest earlier
    occurrence of its trailing n-gram (``buf[:n_buf]`` is the prompt and
    the tokens so far), the start clipped so that k fit; ``cur`` k times
    when there is none."""
    L = buf.shape[0]
    s = min(max(n_buf - ngram, 0), L - ngram)
    pat = buf[s:s + ngram]
    windows = np.lib.stride_tricks.sliding_window_view(buf, ngram)
    idx = np.arange(L - ngram + 1)
    hits = idx[(windows == pat).all(axis=1) & (idx < n_buf - ngram)]
    if not hits.size:
        return [int(cur)] * k
    start = int(np.clip(hits.max() + ngram, 0, L - k))
    return [int(x) for x in buf[start:start + k]]


def _verify(params: dict, cfg: LlavaConfig, cache: KVCache, tokens: list,
            pos: int) -> np.ndarray:
    """The Sq = k + 1 verify step: ``tokens`` at positions ``pos, pos + 1,
    ...`` appended to the cache, attention through ``attn_impl=
    "reference"`` as in the JAX package -> the greedy next token after
    each, (k + 1,) on the host (the step's one sync)."""
    dev = cache.valid.device
    ids = torch.tensor([tokens], dtype=torch.int64, device=dev)
    pos_t = pos + torch.arange(len(tokens), device=dev)[None]
    ref = dataclasses.replace(cfg.llama, attn_impl="reference")
    hidden, _ = llama_forward(params["llama"], ref,
                              embed_tokens(params["llama"], ids),
                              position_ids=pos_t,
                              attn_valid=torch.ones_like(ids, dtype=torch.bool),
                              cache=cache)
    return lm_head(params["llama"], hidden).argmax(-1)[0].cpu().numpy()


def _rewind(cache: KVCache, k: int, keep: int) -> None:
    """Keep the first ``keep`` of a verify step's k + 1 cache writes: the
    rest lose their ``valid`` bits and the next write goes to the first
    of them."""
    w0 = cache.host_idx - (k + 1)
    cache.valid[:, w0 + keep: w0 + k + 1] = False
    cache.set_write_idx(w0 + keep)


@torch.inference_mode()
def speculative_generate(
    params: dict,
    cfg: LlavaConfig,
    input_ids,                                    # (1, T)
    pixel_values=None,                            # (1, 3, H, W)
    *,
    matryoshka_vis_token_scale: Optional[str] = None,
    gen_cfg: GenerationConfig = GenerationConfig(),
    k: int = 8,
    ngram: int = 3,
    propose_fn=None,                      # (ids, k, ngram) -> [k ids]
) -> np.ndarray:
    """Greedy generation with prompt-lookup speculative decoding, B=1: the
    drafts continue the latest earlier occurrence of the trailing n-gram
    in the prompt and the tokens so far (no draft model), one ``(1, k +
    1)`` forward verifies k of them, and the greedy-consistent prefix is
    kept.  A host loop with one sync a verify step stands for the JAX
    package's ``lax.while_loop``; the tokens are set by greedy
    verification, so they are the JAX function's.

    Without ``propose_fn`` the drafts come from a fixed-length token
    buffer (the JAX on-device loop) and the result is ``(1,
    max_new_tokens)``, the EOS and everything after it ``pad_token_id``;
    with ``propose_fn(ids, k, ngram)`` the result is the tokens emitted,
    up to and including an EOS."""
    params, cfg = rank_view(params, cfg)
    device = _params_device(params)
    ids_np = np.asarray(input_ids, np.int64)
    B, T = ids_np.shape
    if B != 1:
        raise ValueError("speculative decoding supports batch_size=1")
    if gen_cfg.do_sample and gen_cfg.temperature > 0:
        raise ValueError("speculative decoding is greedy-only")
    numtoks, v2 = _parse_scale(matryoshka_vis_token_scale)
    if v2 is not None:
        raise ValueError("speculative decoding supports ver=v0 scales")
    if pixel_values is not None:
        pixel_values = np.asarray(pixel_values, np.float32)
        if pixel_values.shape[0] != 1 or pixel_values.ndim != 4:
            raise ValueError(f"speculative decoding takes one image "
                             f"(1, 3, H, W), not {pixel_values.shape}")
        pixel_values = torch.as_tensor(pixel_values, device=device)
    if numtoks == GATE:
        numtoks = _gate_scale(params, cfg, pixel_values)

    max_new, eos = gen_cfg.max_new_tokens, gen_cfg.eos_token_id
    ids = torch.as_tensor(ids_np, device=device)
    if pixel_values is None:
        text_cap = _round_up(T, 64)
        pad = text_cap - T
        mask = torch.nn.functional.pad(
            torch.ones((1, T), dtype=torch.bool, device=device), (pad, 0))
        logits, cache, lengths = prefill_text(
            params, cfg, torch.nn.functional.pad(ids, (pad, 0)), mask,
            text_cap + max_new + k + 1)
    else:
        n = numtoks if numtoks is not None else cfg.vision.num_patches
        L = _round_up(T - 1 + n, 64)
        logits, cache, lengths = prefill_image(
            params, cfg, ids, pixel_values, None, n, L, L + max_new + k + 1)
    first = int(logits.argmax(-1)[0])
    if first == eos or max_new <= 1:
        return np.asarray([[first]], np.int32)
    seq_len = int(lengths[0])

    if propose_fn is None:
        budget = max_new - 1
        buf = np.full((T + max_new + k + ngram + 1,), gen_cfg.pad_token_id,
                      np.int64)
        buf[:T], buf[T] = ids_np[0], first
        n_buf, cur, emitted, finished = T + 1, first, 0, False
        j = np.arange(k + 1)
        while not finished and emitted < budget:
            draft = _buffer_propose(buf, n_buf, cur, k, ngram)
            greedy = _verify(params, cfg, cache, [cur] + draft, seq_len)
            match = np.asarray(draft) == greedy[:k]
            n_acc = k if match.all() else int(np.argmax(~match))
            is_eos = greedy == eos
            eos_before = np.cumsum(is_eos) - is_eos
            keep = (j <= n_acc) & (eos_before == 0) & (emitted + j < budget)
            n_emit = int(keep.sum())
            # the EOS itself is emitted as pad, as the plain decode does
            buf[n_buf:n_buf + k + 1] = np.where(keep & ~is_eos, greedy,
                                                gen_cfg.pad_token_id)
            _rewind(cache, k, n_emit)
            finished = bool((keep & is_eos).any()) or \
                emitted + n_emit >= budget or n_emit == 0
            cur = int(greedy[min(max(n_emit - 1, 0), k)])
            n_buf, seq_len, emitted = (n_buf + n_emit, seq_len + n_emit,
                                       emitted + n_emit)
        return buf[None, T:T + max_new].astype(np.int32)

    out = [first]
    ids_all = [int(x) for x in ids_np[0]] + [first]
    cur = first
    while len(out) < max_new and cur != eos:
        draft = [int(x) for x in propose_fn(ids_all, k, ngram)]
        g = _verify(params, cfg, cache, [cur] + draft, seq_len)
        n_acc = 0
        while n_acc < k and draft[n_acc] == int(g[n_acc]):
            n_acc += 1
        emitted = draft[:n_acc] + [int(g[n_acc])]
        if eos in emitted:                       # stop at (and keep) the EOS
            emitted = emitted[: emitted.index(eos) + 1]
            n_acc = len(emitted) - 1
        if len(out) + len(emitted) > max_new:    # the budget
            emitted = emitted[: max_new - len(out)]
            n_acc = max(len(emitted) - 1, 0)
        _rewind(cache, k, n_acc + 1)
        seq_len += n_acc + 1
        out.extend(emitted)
        ids_all.extend(emitted)
        cur = emitted[-1]
    return np.asarray([out], np.int32)
