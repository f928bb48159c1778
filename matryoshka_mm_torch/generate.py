"""Autoregressive generation, PyTorch port of the text-only, one image
a row, multi-image and anyres paths of ``matryoshka_mm_tpu/generate.py``.

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
* Token choice: greedy argmax, or temperature / top-p sampling drawn from a
  ``torch.Generator``.
* ``numtoks=gateprobargmax``: the M3-MoE router picks the scale of a B=1
  request (:func:`gating_probs`, the argmax over ``cfg.tokscale_list``).

Not ported yet; each raises ``NotImplementedError`` naming its ROADMAP.md
item: ``ver=v2`` combine-logits, beam search, speculative decoding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .constants import IMAGE_TOKEN_INDEX
from .kvconfig import parse_kv_from_string

from .config import LlavaConfig
from .models.llama import (KVCache, embed_tokens, init_kv_cache,
                           llama_forward, lm_head)
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


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@torch.inference_mode()
def prefill_image(params: dict, cfg: LlavaConfig, input_ids: torch.Tensor,
                  pixel_values: torch.Tensor,
                  attn_mask: Optional[torch.Tensor], numtoks: int,
                  out_len: int, capacity: int
                  ) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """One image per row -> (last-position logits (B, V) f32, cache,
    next positions (B,))."""
    spliced, _ = prepare_multimodal(
        params, cfg, input_ids, pixel_values, numtoks=numtoks,
        attn_mask=attn_mask, out_len=out_len, padding_side="left")
    return _prefill_spliced(params, cfg, spliced, capacity)


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
                     capacity: int
                     ) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    B, L, _ = spliced.embeds.shape
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


def _decode_step(params: dict, cfg: LlavaConfig, gen_cfg: GenerationConfig,
                 cache: KVCache, token: torch.Tensor, lengths: torch.Tensor,
                 finished: torch.Tensor,
                 generator: Optional[torch.Generator]):
    """One decode step -> ``(token, lengths, finished, logits (B, V) f32)``;
    the cache advances in place."""
    embeds = embed_tokens(params["llama"], token[:, None])
    hidden, _ = llama_forward(
        params["llama"], cfg.llama, embeds, position_ids=lengths[:, None],
        attn_valid=~finished[:, None], cache=cache)
    logits = lm_head(params["llama"], hidden[:, 0:1, :])[:, 0]
    nxt = _select_token(logits, gen_cfg, generator)
    nxt = torch.where(finished, gen_cfg.pad_token_id, nxt)
    return (nxt, lengths + 1, finished | (nxt == gen_cfg.eos_token_id),
            logits)


@torch.inference_mode()
def decode_chunk(params: dict, cfg: LlavaConfig, gen_cfg: GenerationConfig,
                 cache: KVCache, token: torch.Tensor, lengths: torch.Tensor,
                 finished: torch.Tensor, steps: int,
                 generator: Optional[torch.Generator] = None,
                 return_logits: bool = False):
    """Run ``steps`` decode steps on the device with no host sync: the
    plain version of :class:`DecodeGraph`.  ``lengths`` is each row's next
    position.  Returns ``(token, lengths, finished, tokens (B, steps))``,
    and the last step's logits ``(B, V)`` after them with
    ``return_logits``; the cache advances in place."""
    toks = []
    for _ in range(steps):
        token, lengths, finished, logits = _decode_step(
            params, cfg, gen_cfg, cache, token, lengths, finished, generator)
        toks.append(token)
    out = (token, lengths, finished, torch.stack(toks, dim=1))
    return out + (logits,) if return_logits else out


class DecodeGraph:
    """The decode step of one ``generate`` call as a captured CUDA graph:
    the counterpart of the JAX package's jitted decode chunk
    (``matryoshka_mm_tpu/generate.py:152``).

    The step is :func:`_decode_step` over static buffers it advances in
    place (``token``, ``lengths``, ``finished``; ``logits`` holds the last
    step's, ``toks`` the chunk's tokens at column ``col``, a device index)
    and over the KV cache, whose write slot is a device scalar.
    :meth:`run` warms the step up and captures it at its first call (the
    warm-up is the chunk's first step), then replays it once a step; the
    cache's host count follows.  :meth:`step` is the same step run eagerly,
    which works on any device."""

    def __init__(self, params: dict, cfg: LlavaConfig,
                 gen_cfg: GenerationConfig, cache: KVCache,
                 token: torch.Tensor, lengths: torch.Tensor,
                 finished: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        B, dev = token.shape[0], token.device
        self._args = (params, cfg, gen_cfg, cache)
        self.cache = cache
        self.generator = generator
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
            self.generator)
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
                 lengths, generator, stopping_criteria,
                 cuda_graph: bool) -> np.ndarray:
    finished = first == gen_cfg.eos_token_id
    out_tokens = [first.cpu().numpy()[:, None]]
    steps_done = 1
    token = first
    graph = DecodeGraph(params, cfg, gen_cfg, cache, first, lengths,
                        finished, generator) \
        if cuda_graph and first.device.type == "cuda" \
        and gen_cfg.max_new_tokens > 1 else None
    while steps_done < gen_cfg.max_new_tokens:
        nsteps = min(gen_cfg.decode_chunk, gen_cfg.max_new_tokens - steps_done)
        if graph is None:
            token, lengths, finished, toks = decode_chunk(
                params, cfg, gen_cfg, cache, token, lengths, finished,
                nsteps, generator)
        else:
            toks, finished = graph.run(nsteps), graph.finished
        steps_done += nsteps
        out_tokens.append(toks.cpu().numpy())     # one sync per chunk
        if bool(finished.all()):
            break
        if stopping_criteria is not None and stopping_criteria(
                list(np.concatenate(out_tokens, axis=1)[0])):
            break
    return _trim(np.concatenate(out_tokens, axis=1), gen_cfg)


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
    """The fixed scale of ``spec``, None for the full grid, or ``GATE``."""
    if not spec:
        return None
    kvs = parse_kv_from_string(spec)
    if kvs["ver"] == "v2":
        raise NotImplementedError(
            "ver=v2 combine-logits decoding is not ported yet (ROADMAP.md "
            "Queue 1, item 4)")
    if kvs["numtoks"] == GATE:
        return GATE
    return int(kvs["numtoks"])


@torch.inference_mode()
def gating_probs(params: dict, cfg: LlavaConfig,
                 pixel_values) -> Optional[torch.Tensor]:
    """(B, K) float32 router probabilities over ``cfg.tokscale_list``: the
    CLIP tower once, then the router; None when the config is not
    M3-MoE."""
    device = params["vision_tower"]["class_embedding"].device
    px = torch.as_tensor(np.asarray(pixel_values, np.float32)) \
        if not isinstance(pixel_values, torch.Tensor) else pixel_values
    px = px.to(device=device, dtype=torch.float32)
    return router_forward(params, cfg, encode_images(params, cfg, px))


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
    for the router's pick (B=1, M3-MoE configs), or None for the full
    grid.  ``pixel_values`` is one image a row; at B=1, M images for a
    prompt with M sentinels; or an anyres tile stack of one image, with its
    ``image_sizes``.
    Sampling draws from ``generator`` (a new one seeded with 0 on the
    model's device when None).  On a CUDA device the decode replays a
    captured step (:class:`DecodeGraph`) unless ``cuda_graph=False`` asks
    for the eager loop (:func:`decode_chunk`); the CPU always takes the
    eager loop."""
    device = _params_device(params)
    ids_np = np.asarray(input_ids, np.int64)
    B, T = ids_np.shape
    multi = False
    if pixel_values is not None:
        pixel_values = np.asarray(pixel_values, np.float32)
        # M images for the M sentinels of one prompt
        multi = (pixel_values.ndim == 4 and B == 1
                 and pixel_values.shape[0] > 1)
        if multi and matryoshka_vis_token_scale and parse_kv_from_string(
                matryoshka_vis_token_scale)["ver"] == "v2":
            raise ValueError("ver=v2 combine-logits supports one image per "
                             "sample (multi-image prompts use ver=v0)")
        multi = multi and pixel_values.shape[0] == int(
            (ids_np == IMAGE_TOKEN_INDEX).sum())
    numtoks = _parse_scale(matryoshka_vis_token_scale)
    if generator is None and gen_cfg.do_sample:
        generator = torch.Generator(device=device).manual_seed(0)
    input_ids = torch.as_tensor(ids_np, device=device)
    if pixel_values is not None:
        pixel_values = torch.as_tensor(pixel_values, device=device)
    if numtoks == GATE:
        if B != 1:
            raise ValueError("gateprobargmax supports batch_size=1 only")
        if pixel_values is None or not cfg.is_m3_moe:
            raise ValueError("gateprobargmax needs an image and an M3-MoE "
                             "config (its router picks the scale)")
        if pixel_values.dim() != 4:
            # the JAX package's CLIP tower fails to reshape a tile stack
            # with this TypeError
            raise TypeError(f"gateprobargmax reads one image a row: cannot "
                            f"reshape pixels of shape "
                            f"{tuple(pixel_values.shape)} into patches")
        gp = gating_probs(params, cfg, pixel_values)
        numtoks = cfg.tokscale_list[int(gp[0].argmax())]

    if multi:
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
    return _decode_loop(params, cfg, gen_cfg, cache, first, lengths,
                        generator, stopping_criteria, cuda_graph)
