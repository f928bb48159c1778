"""Plain float32 forward passes of the LLaVA-M3 configurations.

Weights are read from the benchmark's tree (the layout the program is
handed: ``vision_tower``, ``mm_projector``, ``llama``; dense weights
``(out, in)``) and upcast to float32 where they are used, one layer at a
time.  Every product goes through a ``linear(x, w, b)`` the caller may
replace (the fp8 control does).  Equations:

* CLIP ViT (Radford et al. 2021; HF ``CLIPVisionModel``): a stride-``P``
  convolution for the patches, the class token, learned positions,
  pre-LayerNorm, pre-norm blocks of multi-head attention and a quick-GELU
  MLP; the features are the select layer's patch tokens.
* ``mlp2x_gelu`` (LLaVA-1.5): linear, exact GELU, linear.
* M3 pooling (Cai et al. 2024): ``adaptive_avg_pool2d`` of the 24 x 24 grid
  to ``sqrt(n) x sqrt(n)``.
* Splice: the text before the image sentinel, the pooled tokens, the text
  after it; positions count from 0.
* Mistral (Jiang et al. 2023; HF ``MistralForCausalLM``): RMSNorm, RoPE
  (rotate-half), grouped-query attention (query head ``h`` reads key head
  ``h // (H / Hkv)``), a sliding window when set, SwiGLU.
* MPT (MosaicML 2023; ``modeling_mpt.py``): bias-free LayerNorm, a fused
  ``Wqkv``, alibi (slopes ``2^(-m * alibi_bias_max / H)``), an exact-GELU
  MLP and the head tied to the embedding.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .spec import DecoderSpec, ModelSpec, VisionSpec

Linear = Callable[..., torch.Tensor]


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x W^T + b`` in float32."""
    return F.linear(x, w.float(), None if b is None else b.float())


def fp8_linear(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The control's product: the activation rows and the weight rows
    rounded to float8 e4m3 with one absmax scale each, multiplied in
    float32.  The rounding passes gradients straight through, so a
    backward multiplies by the rounded operands (an fp8 backward without
    loss scaling would flush the gradients to zero instead)."""
    def q(t):
        s = t.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
        r = (t / s).to(torch.float8_e4m3fn).float() * s
        return t + (r - t).detach()

    return F.linear(q(x.float()), q(w.float()),
                    None if b is None else b.float())


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32, restored on exit."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def _softmax_attention(q, k, v, bias=None, mask=None):
    """``(H, S, Dh)`` queries over ``(H, T, Dh)`` keys and values."""
    scores = torch.einsum("hsd,htd->hst", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hst,htd->hsd", torch.softmax(scores, dim=-1), v)


# ---------------------------------------------------------------------------
# vision
# ---------------------------------------------------------------------------

def clip_patch_features(vt: dict, pixels: torch.Tensor, vs: VisionSpec,
                        lin: Linear = linear) -> torch.Tensor:
    """``(B, 3, H, W)`` pixels -> ``(B, G*G, D)`` select-layer patch
    features."""
    B, P, D = pixels.shape[0], vs.patch, vs.hidden
    conv = vt["patch_embedding"].float().t().reshape(D, 3, P, P)
    x = F.conv2d(pixels.float(), conv, stride=P).flatten(2).transpose(1, 2)
    cls = vt["class_embedding"].float().expand(B, 1, D)
    x = torch.cat([cls, x], dim=1) + vt["position_embedding"].float()[None]

    def ln(t, p):
        return F.layer_norm(t, (D,), p["weight"].float(), p["bias"].float(),
                            vs.norm_eps)

    x = ln(x, vt["pre_layrnorm"])
    H, Dh = vs.heads, D // vs.heads
    for lp in vt["layers"][:vs.layers_run]:
        a = lp["self_attn"]
        h = ln(x, lp["layer_norm1"])
        q, k, v = (lin(h, a[n]["weight"], a[n]["bias"])
                   .reshape(B, -1, H, Dh).permute(0, 2, 1, 3)
                   for n in ("q_proj", "k_proj", "v_proj"))
        o = torch.stack([_softmax_attention(q[b], k[b], v[b])
                         for b in range(B)])
        o = o.permute(0, 2, 1, 3).reshape(B, -1, D)
        x = x + lin(o, a["out_proj"]["weight"], a["out_proj"]["bias"])
        h = ln(x, lp["layer_norm2"])
        m = lp["mlp"]
        h = lin(h, m["fc1"]["weight"], m["fc1"]["bias"])
        h = h * torch.sigmoid(1.702 * h)
        x = x + lin(h, m["fc2"]["weight"], m["fc2"]["bias"])
    return x[:, 1:]


def project(proj: dict, feats: torch.Tensor, lin: Linear = linear
            ) -> torch.Tensor:
    """``mlpNx_gelu``: linear layers with exact GELU between them."""
    for i, layer in enumerate(proj["layers"]):
        if i:
            feats = F.gelu(feats)
        feats = lin(feats, layer["weight"], layer["bias"])
    return feats


def m3_pool(feats: torch.Tensor, numtoks: int) -> torch.Tensor:
    """``(B, G*G, D)`` -> ``(B, numtoks, D)`` by adaptive average pooling."""
    B, n, D = feats.shape
    g, h = math.isqrt(n), math.isqrt(numtoks)
    grid = feats.transpose(1, 2).reshape(B, D, g, g)
    return F.adaptive_avg_pool2d(grid, h).reshape(B, D, h * h).transpose(1, 2)


def image_tokens(weights: dict, spec: ModelSpec, pixels: torch.Tensor,
                 scales: Sequence[int], lin: Linear = linear
                 ) -> List[torch.Tensor]:
    """One ``(n_i, D)`` block of visual tokens for each image of
    ``pixels`` at its scale ``scales[i]``."""
    feats = project(weights["mm_projector"],
                    clip_patch_features(weights["vision_tower"], pixels,
                                        spec.vision, lin), lin)
    return [m3_pool(feats[i:i + 1], n)[0] for i, n in enumerate(scales)]


def splice(embed: torch.Tensor, ids: Sequence[int], image_token: int,
           image: torch.Tensor) -> torch.Tensor:
    """One prompt's ``(T, D)`` embeddings with its one sentinel replaced by
    the image's tokens."""
    ids = list(ids)
    k = ids.index(image_token)
    idx = torch.as_tensor(ids[:k] + ids[k + 1:], device=embed.device)
    text = embed[idx].float()
    return torch.cat([text[:k], image.float(), text[k:]])


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _ln_nobias(x, w, eps):
    return F.layer_norm(x, (x.shape[-1],), w.float(), None, eps)


def _rope(x, theta):
    """Rotate-half RoPE of ``(H, S, Dh)`` at positions ``0..S-1``."""
    S, Dh = x.shape[1], x.shape[2]
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float32,
                                       device=x.device) / Dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def alibi_slopes(heads: int, bias_max: float, device) -> torch.Tensor:
    n = 2 ** math.ceil(math.log2(heads))
    m = torch.arange(1, n + 1, dtype=torch.float32, device=device) \
        * (bias_max / n)
    slopes = 1.0 / torch.pow(2.0, m)
    if n != heads:
        slopes = torch.cat([slopes[1::2], slopes[::2]])[:heads]
    return slopes


def _causal(S, window, device):
    i = torch.arange(S, device=device)
    allowed = i[None, :] <= i[:, None]
    if window:
        allowed &= (i[:, None] - i[None, :]) < window
    return allowed


def _llama_layer(lp: dict, h: torch.Tensor, d: DecoderSpec,
                 lin: Linear) -> torch.Tensor:
    S, H, Hkv, Dh = h.shape[0], d.heads, d.kv_heads, d.head_dim
    a, m = lp["self_attn"], lp["mlp"]
    x = _rms(h, lp["input_layernorm"], d.norm_eps)
    q = lin(x, a["q_proj"]).reshape(S, H, Dh).transpose(0, 1)
    k = lin(x, a["k_proj"]).reshape(S, Hkv, Dh).transpose(0, 1)
    v = lin(x, a["v_proj"]).reshape(S, Hkv, Dh).transpose(0, 1)
    q, k = _rope(q, d.rope_theta), _rope(k, d.rope_theta)
    g = H // Hkv
    k, v = k.repeat_interleave(g, dim=0), v.repeat_interleave(g, dim=0)
    o = _softmax_attention(q, k, v, mask=_causal(S, d.window, h.device))
    h = h + lin(o.transpose(0, 1).reshape(S, H * Dh), a["o_proj"])
    x = _rms(h, lp["post_attention_layernorm"], d.norm_eps)
    return h + lin(F.silu(lin(x, m["gate_proj"])) * lin(x, m["up_proj"]),
                   m["down_proj"])


def _mpt_layer(lp: dict, h: torch.Tensor, d: DecoderSpec,
               lin: Linear) -> torch.Tensor:
    S, H, Dh = h.shape[0], d.heads, d.head_dim
    a, f = lp["attn"], lp["ffn"]
    x = _ln_nobias(h, lp["norm_1"], d.norm_eps)
    q, k, v = (t.reshape(S, H, Dh).transpose(0, 1)
               for t in lin(x, a["Wqkv"]).chunk(3, dim=-1))
    i = torch.arange(S, device=h.device, dtype=torch.float32)
    rel = (i[None, :] - i[:, None])                 # key minus query
    bias = alibi_slopes(H, d.alibi_bias_max, h.device)[:, None, None] \
        * rel[None]
    o = _softmax_attention(q, k, v, bias=bias,
                           mask=_causal(S, 0, h.device))
    h = h + lin(o.transpose(0, 1).reshape(S, H * Dh), a["out_proj"])
    x = _ln_nobias(h, lp["norm_2"], d.norm_eps)
    return h + lin(F.gelu(lin(x, f["up_proj"])), f["down_proj"])


def decoder_logits(llama: dict, d: DecoderSpec,
                   sequences: List[torch.Tensor],
                   rows: List[Sequence[int]],
                   lin: Linear = linear) -> List[torch.Tensor]:
    """Run every ``(T_i, D)`` embedded sequence through the decoder, layer
    by layer over all of them, and return the float32 logits of the
    positions ``rows[i]`` of each, ``(len(rows[i]), V)``."""
    layer = _mpt_layer if d.family == "mpt" else _llama_layer
    hs = [s.float() for s in sequences]
    for lp in llama["layers"]:
        lp32 = _upcast(lp)
        hs = [layer(lp32, h, d, lin) for h in hs]
        del lp32
    head = llama["embed_tokens"] if d.tied else llama["lm_head"]
    out = []
    for h, r in zip(hs, rows):
        x = h[torch.as_tensor(list(r), device=h.device)]
        x = _ln_nobias(x, llama["norm"], d.norm_eps) if d.family == "mpt" \
            else _rms(x, llama["norm"], d.norm_eps)
        out.append(lin(x, head))
    return out


def _upcast(tree):
    """A layer's weights as float32 copies (what one layer costs)."""
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    return tree.float()


def served_logits(weights: dict, spec: ModelSpec, image_token: int,
                  prompts: List[Sequence[int]], pixels: torch.Tensor,
                  scales: Sequence[int], served: List[Sequence[int]],
                  lin: Linear = linear) -> List[torch.Tensor]:
    """For each request: the logits, ``(n_i, V)``, at the positions that
    chose its ``n_i`` served tokens, teacher-forced on them."""
    imgs = image_tokens(weights, spec, pixels, scales, lin)
    embed = weights["llama"]["embed_tokens"]
    seqs, rows = [], []
    for ids, img, toks in zip(prompts, imgs, served):
        prompt = splice(embed, ids, image_token, img)
        toks = list(toks)
        tail = embed[torch.as_tensor(toks[:-1], device=embed.device,
                                     dtype=torch.long)].float()
        seqs.append(torch.cat([prompt, tail]))
        t0 = prompt.shape[0]
        rows.append(range(t0 - 1, t0 - 1 + len(toks)))
    return decoder_logits(weights["llama"], spec.decoder, seqs, rows, lin)


def gap_of(logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """Per position, how far the chosen token's logit lies below the
    row's best."""
    t = torch.as_tensor(list(tokens), device=logits.device, dtype=torch.long)
    return logits.max(dim=-1).values - logits.gather(1, t[:, None])[:, 0]

