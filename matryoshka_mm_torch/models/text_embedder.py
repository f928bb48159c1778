"""Frozen text embedder for the M3-MoE router's ``textcls`` feature, PyTorch
port of ``matryoshka_mm_tpu/models/text_embedder.py``.

The reference wraps a frozen BGE BERT (``BAAI/bge-small-en-v1.5``) that
encodes the USER prompt into an L2-normalized CLS embedding.  Here the
encoder is a plain-function BERT over a parameter dict (LayerNorm, exact
GELU, non-causal attention with the padding mask through
``attention_reference``; BERT has no kernel in either package), with a
converter from an HF ``BertModel`` state dict; prompt extraction keeps the
reference's ``USER: ... ASSISTANT:`` regex.

Parameter layout: dense leaves ``{"weight": (out, in), "bias"}`` for
``F.linear`` (the HF orientation; the JAX tree keeps ``kernel (in, out)``),
LayerNorms ``{"weight", "bias"}``, ``layers`` a list of per-layer dicts.
This module imports neither ``jax`` nor ``transformers``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import attention_reference

PROMPT_PATTERN = re.compile(r"USER:\s*(.*?)\s*ASSISTANT:", re.DOTALL)

TEXT_EMBEDDERS = {"bge15small": "BAAI/bge-small-en-v1.5"}


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384        # bge-small-en-v1.5
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def bge_small(cls):
        return cls()

    @classmethod
    def tiny_debug(cls):
        return cls(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64,
                   max_position_embeddings=64)


def init_bert_params(generator: torch.Generator, cfg: BertConfig,
                     device="cuda") -> dict:
    """Random float32 parameters made on ``device`` (the card unless the
    caller names the CPU; ``generator`` lives there too): normal(0, 0.02)
    weights and embeddings, zero biases, unit LayerNorms."""
    D, I = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * 0.02

    def dense(o, i):
        return {"weight": normal(o, i),
                "bias": torch.zeros(o, dtype=torch.float32, device=device)}

    def ln():
        return {"weight": torch.ones(D, dtype=torch.float32, device=device),
                "bias": torch.zeros(D, dtype=torch.float32, device=device)}

    layers = [{
        "attention": {"query": dense(D, D), "key": dense(D, D),
                      "value": dense(D, D), "output": dense(D, D),
                      "output_ln": ln()},
        "intermediate": dense(I, D),
        "output": dense(D, I),
        "output_ln": ln(),
    } for _ in range(cfg.num_hidden_layers)]
    return {
        "word_embeddings": normal(cfg.vocab_size, D),
        "position_embeddings": normal(cfg.max_position_embeddings, D),
        "token_type_embeddings": normal(cfg.type_vocab_size, D),
        "embeddings_ln": ln(),
        "layers": layers,
    }


def convert_bert(sd, cfg: BertConfig, prefix: str = "",
                 device="cuda") -> dict:
    """An HF ``BertModel`` state dict (tensors or numpy arrays) -> float32
    parameters on ``device``."""
    def t(k):
        v = sd[prefix + k]
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        return v.detach().to(device=device, dtype=torch.float32)

    def dense(k):
        return {"weight": t(k + ".weight"), "bias": t(k + ".bias")}

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}."
        layers.append({
            "attention": {
                "query": dense(p + "attention.self.query"),
                "key": dense(p + "attention.self.key"),
                "value": dense(p + "attention.self.value"),
                "output": dense(p + "attention.output.dense"),
                "output_ln": dense(p + "attention.output.LayerNorm"),
            },
            "intermediate": dense(p + "intermediate.dense"),
            "output": dense(p + "output.dense"),
            "output_ln": dense(p + "output.LayerNorm"),
        })
    return {
        "word_embeddings": t("embeddings.word_embeddings.weight"),
        "position_embeddings": t("embeddings.position_embeddings.weight"),
        "token_type_embeddings": t("embeddings.token_type_embeddings.weight"),
        "embeddings_ln": dense("embeddings.LayerNorm"),
        "layers": layers,
    }


def _ln(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["weight"], p["bias"], eps)


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["weight"], p["bias"])


def bert_forward(params: dict, cfg: BertConfig, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) ids -> (B, S, D) hidden states (no pooler)."""
    B, S = input_ids.shape
    D, H = cfg.hidden_size, cfg.num_attention_heads
    Dh = D // H
    valid = attention_mask.bool()

    # ids past the table take its last row, as the JAX gather clamps them
    # (the word-hash tokenizer reaches 150 + vocab - 200, past a small
    # vocabulary's end)
    ids = input_ids.long().clamp(0, params["word_embeddings"].shape[0] - 1)
    x = (params["word_embeddings"][ids]
         + params["position_embeddings"][None, :S]
         + params["token_type_embeddings"][0][None, None])
    x = _ln(x, params["embeddings_ln"], cfg.layer_norm_eps)

    def heads(y):
        return y.view(B, S, H, Dh).transpose(1, 2)

    for lp in params["layers"]:
        a = lp["attention"]
        out = attention_reference(
            heads(_linear(a["query"], x)), heads(_linear(a["key"], x)),
            heads(_linear(a["value"], x)), causal=False, kv_valid=valid)
        out = _linear(a["output"], out.transpose(1, 2).reshape(B, S, D))
        x = _ln(x + out, a["output_ln"], cfg.layer_norm_eps)
        mid = F.gelu(_linear(lp["intermediate"], x))        # exact (erf)
        x = _ln(x + _linear(lp["output"], mid), lp["output_ln"],
                cfg.layer_norm_eps)
    return x


def extract_prompts(texts: List[str]) -> List[str]:
    """Pull the USER prompt out of rendered conversations."""
    prompts = []
    for s in texts:
        m = PROMPT_PATTERN.search(s)
        if m:
            prompts.append(m.group(1).strip())
        else:
            print(f"Could not extract prompt for example:\n {s}")
            prompts.append("")
    return prompts


class TextEmbedder:
    """Decode VLM ids, extract the USER prompt, encode it with BERT, return
    the L2-normalized CLS embedding.  Without ``params`` the BERT is random
    from seed 0 (the JAX package's default too); the device is ``params``'
    or ``device``, the card unless the caller names the CPU."""

    def __init__(self, vlm_tokenizer,
                 embedder_name_or_path: Optional[str] = None,
                 params: Optional[dict] = None,
                 cfg: Optional[BertConfig] = None, bert_tokenizer=None,
                 device="cuda"):
        self.tokenizer_vlm = vlm_tokenizer
        self.cfg = cfg or BertConfig.bge_small()
        if params is None:
            params = init_bert_params(
                torch.Generator(device=device).manual_seed(0), self.cfg,
                device=device)
        self.params = params
        self.device = params["word_embeddings"].device
        self.bert_tokenizer = bert_tokenizer

    @property
    def hidden_size(self) -> int:
        return self.cfg.hidden_size

    def _tokenize(self, prompts: List[str]):
        if self.bert_tokenizer is not None:
            enc = self.bert_tokenizer(prompts, padding=True, truncation=True,
                                      return_tensors="np")
            return (np.asarray(enc["input_ids"]),
                    np.asarray(enc["attention_mask"]))
        # offline fallback: hash words into the BERT vocab, CLS=101 SEP=102
        max_len = max(min(len(p.split()), 62) for p in prompts) + 2
        ids = np.zeros((len(prompts), max_len), np.int32)
        mask = np.zeros((len(prompts), max_len), np.int32)
        for b, p in enumerate(prompts):
            toks = [101] + [hash(w) % (self.cfg.vocab_size - 200) + 150
                            for w in p.split()[:62]] + [102]
            ids[b, : len(toks)] = toks
            mask[b, : len(toks)] = 1
        return ids, mask

    @torch.no_grad()
    def __call__(self, input_ids) -> torch.Tensor:
        """(B, T) VLM input ids -> (B, D) normalized text embedding, float32
        on the embedder's device."""
        ids = np.asarray(input_ids).copy()
        ids[ids < 0] = 0  # strip image sentinels
        texts = self.tokenizer_vlm.batch_decode(ids, skip_special_tokens=True)
        bert_ids, bert_mask = self._tokenize(extract_prompts(texts))
        hidden = bert_forward(
            self.params, self.cfg,
            torch.as_tensor(bert_ids, device=self.device),
            torch.as_tensor(bert_mask, device=self.device))
        cls = hidden[:, 0]
        return cls / torch.linalg.norm(cls, dim=1, keepdim=True)
