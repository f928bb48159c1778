"""LLaMA decoder (Vicuna-7B family), PyTorch port of
``matryoshka_mm_tpu/models/llama.py`` for ``arch="llama"``.

Parameters are a plain dict whose names mirror the HF checkpoint keys (and
the JAX pytree): dense weights are ``(out, in)`` for ``F.linear``, and
``params["layers"]`` is a list with one dict per decoder layer (the JAX
package stacks them for ``lax.scan``; a Python loop needs no stacking).

Attention: prefill (S > 1) goes through ``ops.attention.attention``, which
reaches the flash kernel; with ``attn_impl="auto"`` every single-token
decode step goes through the decode kernel, reading ``cache.k[l]`` in place.
The TPU-only gates of the JAX ``_flash_decode_ok`` (the bf16 B=1 pin and the
cache-length divisibility rule) do not apply here.

The KV cache keeps the JAX layout ``(L, B, S_max, n_kv, Dh)`` with absolute
positions per slot, so left-padded prefill and decode share one path.
**Cache writes update the cache tensors in place**: ``llama_forward``
returns the same :class:`KVCache` object, advanced, and a caller that wants
the old state must copy it first.  With ``kv_cache_dtype="int8"`` the slots
are stored int8 with f32 per-(slot, kv head) scales ``(L, B, S_max, n_kv)``
(the bytes of the JAX flat ``(L, B, S_max * n_kv)``, whose flat form exists
only for the TPU compiler).

Quantized weights (``ops/quant.py``): every dense weight, ``lm_head``
included, goes through :func:`proj`, the port of the JAX ``proj`` +
``fused_int4_proj``.  A quantized leaf with bf16 rows <= 1024 on a CUDA
tensor, outside ``disable_fused_proj()``, launches ``int4_matmul`` /
``int8_matmul``; everything else (other dtypes, more rows, the CPU)
dequantizes to bf16 and multiplies, as the JAX package does off the TPU.
The MLP of the fused layout takes ``quant_mlp`` under the JAX rule (rows
<= 32, bf16, CUDA, fused kernels enabled).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import LlamaConfig, torch_dtype
from ..ops.attention import attention
from ..ops.decode_attention import flash_decode_attention
from ..ops.fused_mlp import MAX_ROWS as MLP_MAX_ROWS, quant_mlp
from ..ops.int4_matmul import MAX_FUSED_ROWS, leaf_matmul
from ..ops.quant import (Q4KEY, _quantize_kv_slots, dequantize_array,
                         fused_proj_enabled, is_quantized)


@dataclasses.dataclass
class KVCache:
    """Fixed-capacity KV buffers for all layers, updated in place."""

    k: torch.Tensor          # (n_layers, B, S_max, n_kv, Dh)
    v: torch.Tensor          # (n_layers, B, S_max, n_kv, Dh)
    valid: torch.Tensor      # (B, S_max) bool: filled and attendable slots
    positions: torch.Tensor  # (B, S_max) int32: absolute position per slot
    write_idx: int = 0       # next slot to fill
    k_scale: Optional[torch.Tensor] = None   # (n_layers, B, S_max, n_kv) f32
    v_scale: Optional[torch.Tensor] = None   # int8 caches only


def init_kv_cache(cfg: LlamaConfig, batch: int, capacity: int, *,
                  device, dtype: Optional[torch.dtype] = None) -> KVCache:
    dtype = dtype or (torch.int8 if cfg.kv_cache_dtype == "int8"
                      else torch_dtype(cfg.dtype))
    shape = (cfg.num_hidden_layers, batch, capacity,
             cfg.num_key_value_heads, cfg.head_dim)

    def scales():
        return torch.zeros(shape[:4], dtype=torch.float32, device=device) \
            if dtype == torch.int8 else None

    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        valid=torch.zeros((batch, capacity), dtype=torch.bool, device=device),
        positions=torch.zeros((batch, capacity), dtype=torch.int32,
                              device=device),
        write_idx=0, k_scale=scales(), v_scale=scales())


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) int positions -> f32 cos/sin of shape (B, S, Dh/2)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, H, S, Dh) by per-(B, S) cos/sin (HF rotate-half), in f32,
    cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = cos[:, None], sin[:, None]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_tokens(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup.  Ids are clamped into range first: the image
    sentinel (-200) has no row, and an out-of-range index is a device-side
    assert on CUDA.  Sentinel rows are overwritten by the splice."""
    table = params["embed_tokens"]
    return table[input_ids.long().clamp(0, table.shape[0] - 1)]


def _fused_ok(x: torch.Tensor, rows: int, limit: int) -> bool:
    """The JAX eligibility rule of the quantized kernels, off the TPU
    block rules: bf16 activations on a CUDA tensor, at most ``limit`` rows,
    outside ``disable_fused_proj()``."""
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and rows <= limit and fused_proj_enabled())


def proj(x: torch.Tensor, leaf) -> torch.Tensor:
    """``x (..., in)`` times a weight leaf stored ``(out, in)`` (a tensor
    or a quantized dict) -> ``(..., out)``."""
    if is_quantized(leaf):
        rows = x.numel() // x.shape[-1]
        if _fused_ok(x, rows, MAX_FUSED_ROWS):
            y = leaf_matmul(x.reshape(rows, x.shape[-1]), leaf)
            return y.reshape(*x.shape[:-1], y.shape[-1])
        leaf = dequantize_array(leaf)
    dt = torch.promote_types(x.dtype, leaf.dtype)
    return F.linear(x.to(dt), leaf.to(dt))


def _mlp(m: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: the fused quantized kernel for decode rows of the fused
    layout, else gate/up -> silu * up -> down through :func:`proj`."""
    gu = m.get("gateup_proj")
    rows = x.numel() // x.shape[-1]
    if is_quantized(gu) and is_quantized(m["down_proj"]) \
            and (Q4KEY in gu) == (Q4KEY in m["down_proj"]) \
            and _fused_ok(x, rows, MLP_MAX_ROWS):
        y = quant_mlp(x.reshape(rows, x.shape[-1]), gu, m["down_proj"],
                      bits=4 if Q4KEY in gu else 8,
                      i_orig=gu["scale"].shape[0] // 2)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if gu is not None:
        gate, up = proj(x, gu).chunk(2, dim=-1)
    else:
        gate, up = proj(x, m["gate_proj"]), proj(x, m["up_proj"])
    return proj(F.silu(gate) * up, m["down_proj"])


def lm_head(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Vocabulary logits in float32."""
    return proj(hidden, params.get("lm_head", params["embed_tokens"])).float()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_forward(lp: dict, hidden: torch.Tensor, *, cfg: LlamaConfig,
                   cos, sin, q_positions, kv_valid,
                   cache: Optional[KVCache], layer_idx: int,
                   q_index_offset: int = 0) -> torch.Tensor:
    """One decoder layer.  With a cache, the S new K/V slots are written in
    place at ``cache.write_idx`` of layer ``layer_idx`` and attention reads
    that layer's whole cache."""
    B, S, _ = hidden.shape
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    a, m = lp["self_attn"], lp["mlp"]
    window = cfg.sliding_window or None

    x = rms_norm(hidden, lp["input_layernorm"], cfg.rms_norm_eps)
    if "qkv_proj" in a:
        q, k, v = proj(x, a["qkv_proj"]).split([H * Dh, Hkv * Dh, Hkv * Dh],
                                               dim=-1)
    else:
        q, k, v = (proj(x, a[n]) for n in ("q_proj", "k_proj", "v_proj"))
    q = q.reshape(B, S, H, Dh).transpose(1, 2)
    k = k.reshape(B, S, Hkv, Dh).transpose(1, 2)
    v = v.reshape(B, S, Hkv, Dh).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        out = attention(q, k, v, causal=True, q_positions=q_positions,
                        kv_positions=q_positions, kv_valid=kv_valid,
                        sliding_window=window, impl=cfg.attn_impl)
    else:
        w = cache.write_idx
        ck, cv = cache.k[layer_idx], cache.v[layer_idx]   # (B, S_max, Hkv, Dh)
        cks = cvs = None
        if cache.k_scale is not None:
            # int8 slots with per-(slot, head) scales
            cks, cvs = cache.k_scale[layer_idx], cache.v_scale[layer_idx]
            ck[:, w:w + S], cks[:, w:w + S] = _quantize_kv_slots(
                k.transpose(1, 2))
            cv[:, w:w + S], cvs[:, w:w + S] = _quantize_kv_slots(
                v.transpose(1, 2))
            if not (S == 1 and cfg.attn_impl == "auto"
                    and q.device.type == "cuda"):
                # prefill, and the CPU: this layer's cache dequantized to
                # the activation dtype first, as the JAX package does
                ck = (ck.float() * cks[..., None]).to(hidden.dtype)
                cv = (cv.float() * cvs[..., None]).to(hidden.dtype)
                cks = cvs = None
        else:
            ck[:, w:w + S] = k.transpose(1, 2)
            cv[:, w:w + S] = v.transpose(1, 2)
        if S == 1 and cfg.attn_impl == "auto":
            out = flash_decode_attention(
                q[:, :, 0], ck, cv, cache.valid, cache.positions,
                q_positions[:, 0], sliding_window=window, k_scale=cks,
                v_scale=cvs)[:, :, None]
        else:
            out = attention(q, ck.transpose(1, 2), cv.transpose(1, 2),
                            causal=True, q_positions=q_positions,
                            kv_positions=cache.positions,
                            kv_valid=cache.valid, sliding_window=window,
                            q_index_offset=q_index_offset,
                            impl=cfg.attn_impl)

    out = out.transpose(1, 2).reshape(B, S, H * Dh)
    hidden = hidden + proj(out, a["o_proj"])
    x = rms_norm(hidden, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    return hidden + _mlp(m, x)


def llama_forward(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,                  # (B, S, D)
    *,
    position_ids: torch.Tensor,                   # (B, S)
    attn_valid: Optional[torch.Tensor] = None,    # (B, S) bool
    cache: Optional[KVCache] = None,
    q_index_offset: int = 0,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack; returns ``(hidden_states, cache)``.

    Without a cache: causal self-attention over the S tokens.  With a
    cache: the S tokens are appended at ``cache.write_idx`` (in place) and
    attend over the whole cache; prefill (S > 1) and decode (S == 1) share
    this path."""
    if cfg.arch != "llama":
        raise NotImplementedError(
            f"arch={cfg.arch!r}: only 'llama' is ported (Mistral and MPT: "
            f"ROADMAP.md Queue 1, item 2)")
    B, S, _ = inputs_embeds.shape
    if attn_valid is None:
        attn_valid = torch.ones((B, S), dtype=torch.bool,
                                device=inputs_embeds.device)
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)

    if cache is not None:
        w = cache.write_idx
        if w + S > cache.valid.shape[1]:
            raise ValueError(f"KV cache full: {w} + {S} > "
                             f"{cache.valid.shape[1]}")
        cache.valid[:, w:w + S] = attn_valid
        cache.positions[:, w:w + S] = position_ids.to(torch.int32)
        kv_valid = None
    else:
        kv_valid = attn_valid

    hidden = inputs_embeds
    for i, lp in enumerate(params["layers"]):
        hidden = _layer_forward(
            lp, hidden, cfg=cfg, cos=cos, sin=sin, q_positions=position_ids,
            kv_valid=kv_valid, cache=cache, layer_idx=i,
            q_index_offset=q_index_offset)
    if cache is not None:
        cache.write_idx += S
    return rms_norm(hidden, params["norm"], cfg.rms_norm_eps), cache
