"""The float32 reference of the M3 LoRA training step.

The loss (Cai et al. 2024, M3 with ``lm_loss_type`` micro): for every
scale ``k`` of the configuration, each sample's image is pooled to the
scale's tokens and spliced in place of its sentinel, and the decoder's
next-token cross-entropy over the labelled tokens is averaged over the
batch's labelled tokens; the loss is the mean over the scales.  The CLIP
tower is frozen (forward only); the projector and every LoRA pair train.
A LoRA product is ``x W^T + ((x A^T) B^T) * alpha / r`` (peft's
orientation).  The optimizer is AdamW as optax chains it (Loshchilov and
Hutter 2019): each group's gradients clipped to a global norm first, bias-
corrected moments, decoupled weight decay, the rate read from the schedule
at the count before the update.

It runs layer by layer: each (layer, sequence) is recomputed in the
backward (``torch.utils.checkpoint``) and upcasts its layer's weights
inside, so only the layer inputs are kept.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import model as ref
from .spec import ModelSpec

IGNORE = -100
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj")


def _group(name: str) -> str:
    return "self_attn" if name in ("q_proj", "k_proj", "v_proj", "o_proj") \
        else "mlp"


def _lora_lin(base: Dict[str, torch.Tensor], lora: Dict[str, tuple],
              scale: float, lin: ref.Linear):
    """A ``linear`` that adds each targeted weight's adapter."""
    ids = {id(w): n for n, w in base.items()}

    def lora_lin(x, w, b=None):
        y = lin(x, w, b)
        n = ids.get(id(w))
        if n is not None and n in lora:
            a, bb = lora[n]
            y = y + lin(lin(x, a), bb) * scale
        return y

    return lora_lin


def _layer(lp: dict, lora: Dict[str, tuple], scale: float, d, h,
           lin: ref.Linear):
    lp32 = {g: {k: v.float() for k, v in lp[g].items()}
            for g in ("self_attn", "mlp")}
    lp32["input_layernorm"] = lp["input_layernorm"].float()
    lp32["post_attention_layernorm"] = lp["post_attention_layernorm"].float()
    base = {n: lp32[_group(n)][n] for n in LORA_TARGETS}
    return ref._llama_layer(lp32, h, d, _lora_lin(base, lora, scale, lin))


def sequences(weights: dict, spec: ModelSpec, proj: dict, ids, pixels,
              labels, lin: ref.Linear = ref.linear
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Every (scale, sample) sequence's embeddings and labels: the frozen
    tower without a graph, the projector with one."""
    with torch.no_grad():
        feats = ref.clip_patch_features(weights["vision_tower"], pixels,
                                        spec.vision, lin)
    feats = ref.project(proj, feats, lin)
    embed = weights["llama"]["embed_tokens"]
    seqs, labs = [], []
    for n in spec.scales:
        pooled = ref.m3_pool(feats, n)
        for b in range(ids.shape[0]):
            row = ids[b].tolist()
            seqs.append(ref.splice(embed, row, -200, pooled[b]))
            k = row.index(-200)
            lab = labels[b]
            labs.append(torch.cat([lab[:k], torch.full(
                (n,), IGNORE, dtype=lab.dtype, device=lab.device),
                lab[k + 1:]]))
    return seqs, labs


def m3_loss(weights: dict, spec: ModelSpec, lora: List[Dict[str, tuple]],
            scale: float, proj: dict, ids: torch.Tensor, pixels: torch.Tensor,
            labels: torch.Tensor, lin: ref.Linear = ref.linear
            ) -> torch.Tensor:
    """The M3 loss of one batch (``ids``, ``labels`` ``(B, T)`` with one
    sentinel a row) in float32, differentiable in ``lora`` and ``proj``;
    every product through ``lin``."""
    d = spec.decoder
    llama = weights["llama"]
    seqs, labs = sequences(weights, spec, proj, ids, pixels, labels, lin)
    hs = seqs
    for lp, ad in zip(llama["layers"], lora):
        flat = [t for n in LORA_TARGETS for t in ad[n]]

        def fn(h, *t, lp=lp):
            la = {n: (t[2 * i], t[2 * i + 1])
                  for i, n in enumerate(LORA_TARGETS)}
            return _layer(lp, la, scale, d, h, lin)

        hs = [checkpoint(fn, h, *flat, use_reentrant=False) for h in hs]
    head = llama["lm_head"]
    n_scales, B = len(spec.scales), ids.shape[0]
    loss = 0.0
    for k in range(n_scales):
        num, den = 0.0, 0
        for b in range(B):
            i = k * B + b
            x = ref._rms(hs[i][:-1], llama["norm"], d.norm_eps)
            tgt = labs[i][1:]
            ok = tgt != IGNORE

            def ce(x, tgt=tgt, ok=ok):
                lg = lin(x, head)
                return F.cross_entropy(lg[ok], tgt[ok].long(),
                                       reduction="sum")

            num = num + checkpoint(ce, x, use_reentrant=False)
            den += int(ok.sum())
        loss = loss + num / max(den, 1)
    return loss / n_scales


class AdamW:
    """Per-group clipping and AdamW over named float32 leaves."""

    def __init__(self, groups: Dict[str, List[str]], lrs: Dict[str, float],
                 total_steps: int, b1=0.9, b2=0.999, eps=1e-8,
                 max_grad_norm=1.0, weight_decay=0.0):
        self.groups, self.lrs, self.total = groups, lrs, total_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip, self.wd = max_grad_norm, weight_decay
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def rate(self, group: str) -> float:
        """Cosine decay with no warm-up at the count before the update."""
        c = min(self.count, self.total)
        return self.lrs[group] * 0.5 * (1 + math.cos(math.pi * c / self.total))

    @torch.no_grad()
    def clipped(self, grads: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        out = {}
        for names in self.groups.values():
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(grads[n]) for n in names]))
            f = 1.0 if float(norm) < self.clip else self.clip / float(norm)
            out.update({n: grads[n] * f for n in names})
        return out

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        g = self.clipped(grads)
        bc1 = 1 - self.b1 ** (self.count + 1)
        bc2 = 1 - self.b2 ** (self.count + 1)
        for group, names in self.groups.items():
            lr = self.rate(group)
            for n in names:
                mu = self.mu.setdefault(n, torch.zeros_like(params[n]))
                nu = self.nu.setdefault(n, torch.zeros_like(params[n]))
                mu.mul_(self.b1).add_(g[n], alpha=1 - self.b1)
                nu.mul_(self.b2).addcmul_(g[n], g[n], value=1 - self.b2)
                upd = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
                if self.wd:
                    upd = upd + self.wd * params[n]
                params[n].sub_(lr * upd)
        self.count += 1


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in tensors.items()}


def worst_leaf_gap(prog: Dict[str, float], want: Dict[str, float],
                   skip: Sequence[str] = ()) -> Tuple[float, str]:
    """The largest ``|prog - want|`` over the leaves, each measured against
    the larger of that leaf's ``want`` and the median leaf's; returns the
    reading and its leaf."""
    names = [n for n in want if n not in skip]
    med = float(torch.tensor([want[n] for n in names]).median())
    best = (0.0, "")
    for n in names:
        r = abs(prog[n] - want[n]) / max(want[n], med, 1e-30)
        if r > best[0]:
            best = (r, n)
    return best
