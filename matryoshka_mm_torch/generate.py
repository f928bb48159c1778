"""Autoregressive generation, PyTorch port of the single-image and
text-only paths of ``matryoshka_mm_tpu/generate.py``.

* Prefill: left-padded splice into ``L = round_up(T - 1 + n, 64)`` slots
  (text only: ``round_up(T, 64)``) of a KV cache with capacity
  ``L + max_new_tokens``; next-token logits from the last position.
* Decode: chunks of ``decode_chunk`` steps run without a host round trip;
  the new slot is valid only for unfinished rows (``attn_valid=~finished``),
  finished rows emit ``pad_token_id``, and EOS / stopping criteria are
  checked on the host once per chunk.  Output shapes equal the JAX
  function's.
* Token choice: greedy argmax, or temperature / top-p sampling drawn from a
  ``torch.Generator``.

Not ported yet; each raises ``NotImplementedError`` naming its ROADMAP.md
item: ``ver=v2`` combine-logits, ``numtoks=gateprobargmax``, anyres tiles,
multi-image prompts, beam search, speculative decoding.
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
from .models.llava import prepare_multimodal


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
    B, L, _ = spliced.embeds.shape
    cache = init_kv_cache(cfg.llama, B, capacity, device=input_ids.device)
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
                      gen_cfg: GenerationConfig):
    """Prompt prefill for the text-only and one-image-per-row cases."""
    B, T = input_ids.shape
    dev = input_ids.device
    mask = None if attention_mask is None else torch.as_tensor(
        np.asarray(attention_mask, bool), device=dev)
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
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


@torch.inference_mode()
def decode_chunk(params: dict, cfg: LlavaConfig, gen_cfg: GenerationConfig,
                 cache: KVCache, token: torch.Tensor, lengths: torch.Tensor,
                 finished: torch.Tensor, steps: int,
                 generator: Optional[torch.Generator] = None):
    """Run ``steps`` decode steps on the device with no host sync.
    ``lengths`` is each row's next position.  Returns
    ``(token, lengths, finished, tokens (B, steps))``; the cache advances
    in place."""
    toks = []
    for _ in range(steps):
        embeds = embed_tokens(params["llama"], token[:, None])
        hidden, cache = llama_forward(
            params["llama"], cfg.llama, embeds,
            position_ids=lengths[:, None], attn_valid=~finished[:, None],
            cache=cache)
        logits = lm_head(params["llama"], hidden[:, 0:1, :])[:, 0]
        nxt = _select_token(logits, gen_cfg, generator)
        nxt = torch.where(finished, gen_cfg.pad_token_id, nxt)
        finished = finished | (nxt == gen_cfg.eos_token_id)
        lengths = lengths + 1
        token = nxt
        toks.append(nxt)
    return token, lengths, finished, torch.stack(toks, dim=1)


def _decode_loop(params, cfg, gen_cfg: GenerationConfig, cache, first,
                 lengths, generator, stopping_criteria) -> np.ndarray:
    finished = first == gen_cfg.eos_token_id
    out_tokens = [first.cpu().numpy()[:, None]]
    steps_done = 1
    token = first
    while steps_done < gen_cfg.max_new_tokens:
        nsteps = min(gen_cfg.decode_chunk, gen_cfg.max_new_tokens - steps_done)
        token, lengths, finished, toks = decode_chunk(
            params, cfg, gen_cfg, cache, token, lengths, finished, nsteps,
            generator)
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

def _parse_scale(spec: Optional[str]) -> Optional[int]:
    if not spec:
        return None
    kvs = parse_kv_from_string(spec)
    if kvs["ver"] == "v2":
        raise NotImplementedError(
            "ver=v2 combine-logits decoding is not ported yet (ROADMAP.md "
            "Queue 1, item 4)")
    if kvs["numtoks"] == "gateprobargmax":
        raise NotImplementedError(
            "numtoks=gateprobargmax needs the M3 router, not ported yet "
            "(ROADMAP.md Queue 1, item 4)")
    return int(kvs["numtoks"])


@torch.inference_mode()
def generate(
    params: dict,
    cfg: LlavaConfig,
    input_ids,                                    # (B, T)
    pixel_values=None,                            # (B, 3, H, W)
    *,
    image_sizes=None,
    attention_mask=None,                          # (B, T) for padded batches
    matryoshka_vis_token_scale: Optional[str] = None,
    gen_cfg: GenerationConfig = GenerationConfig(),
    stopping_criteria=None,
    generator: Optional[torch.Generator] = None,
) -> np.ndarray:
    """Generate token ids; returns the (B, <= max_new_tokens) generated
    suffixes as int32 numpy.  ``matryoshka_vis_token_scale`` is
    ``ver=v0_numtoks=N`` for a fixed scale, or None for the full grid.
    Sampling draws from ``generator`` (a new one seeded with 0 on the
    model's device when None)."""
    device = _params_device(params)
    input_ids = torch.as_tensor(np.asarray(input_ids, np.int64),
                                device=device)
    B, T = input_ids.shape
    numtoks = _parse_scale(matryoshka_vis_token_scale)
    if generator is None and gen_cfg.do_sample:
        generator = torch.Generator(device=device).manual_seed(0)

    if pixel_values is not None:
        pv = np.asarray(pixel_values, np.float32)
        if pv.ndim == 5:
            raise NotImplementedError(
                "anyres multi-tile input is not ported yet (ROADMAP.md "
                "Queue 1, item 8)")
        n_sent = int((input_ids == IMAGE_TOKEN_INDEX).sum())
        if B == 1 and pv.shape[0] > 1 and pv.shape[0] == n_sent:
            raise NotImplementedError(
                "multi-image prompts are not ported yet (ROADMAP.md "
                "Queue 1, item 8)")
        pixel_values = torch.as_tensor(pv, device=device)

    logits, cache, lengths = _prefill_dispatch(
        params, cfg, input_ids, pixel_values, attention_mask, numtoks,
        gen_cfg)
    first = _select_token(logits, gen_cfg, generator)
    return _decode_loop(params, cfg, gen_cfg, cache, first, lengths,
                        generator, stopping_criteria)
