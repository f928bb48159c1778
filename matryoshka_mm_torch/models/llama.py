"""The decoder families of the reference's LLaVA wrappers, PyTorch port of
``matryoshka_mm_tpu/models/llama.py``: ``arch="llama"`` (Vicuna: RoPE,
SwiGLU), ``"mistral"`` (the same body with GQA and a sliding window) and
``"mpt"`` (bias-free LayerNorm, a fused ``Wqkv``, alibi, a GELU MLP and
the head tied to the embedding table).

Parameters are a plain dict whose names mirror the HF checkpoint keys (and
the JAX pytree): dense weights are ``(out, in)`` for ``F.linear``, and
``params["layers"]`` is a list with one dict per decoder layer (the JAX
package stacks them for ``lax.scan``; a Python loop needs no stacking).

Attention: prefill (S > 1) goes through ``ops.attention.attention``, which
reaches the flash kernel; with ``attn_impl="auto"`` every single-token
decode step goes through the decode kernel, reading ``cache.k[l]`` in place.
The TPU-only gates of the JAX ``_flash_decode_ok`` (the bf16 B=1 pin and the
cache-length divisibility rule) do not apply here.  Mistral's window is by
index in the flash kernel (as in the Pallas kernel; the prefill's layouts
are monotone) and by position in the decode kernel and the plain path.
MPT's alibi bias sends its attention to the plain path in prefill and
decode, as in the JAX package; its slopes and bias are made on the device
from ``positions``, so its decode step captures like LLaMA's.

The KV cache keeps the JAX layout ``(L, B, S_max, n_kv, Dh)`` with absolute
positions per slot, so left-padded prefill and decode share one path.
**Cache writes update the cache tensors in place**: ``llama_forward``
returns the same :class:`KVCache` object, advanced, and a caller that wants
the old state must copy it first.  The write slot is a device ``int32``
scalar, as the JAX ``write_idx``: the K/V, scale, ``valid`` and
``positions`` writes go through ``index_copy_`` at ``write_idx + arange(S)``,
so a decode step holds no host integer for its slot and can be captured in
a CUDA graph (``generate.py``).  The host keeps its own count of the same
slot (``host_idx``) for the "KV cache full" check; nothing reads the device
scalar back.  With ``kv_cache_dtype="int8"`` the slots
are stored int8 with f32 per-(slot, kv head) scales ``(L, B, S_max, n_kv)``
(the bytes of the JAX flat ``(L, B, S_max * n_kv)``, whose flat form exists
only for the TPU compiler).

Tensor parallelism (``cfg.tp_axis``, ``parallel/tp_decode.py``): each rank
holds its heads' rows of q/k/v, its columns of o_proj, its share of the
MLP width and of the vocabulary; the o_proj and MLP outputs are summed
over the ranks before their residual adds (``tp_decode.py`` gathers the
vocabulary-sharded logits of :func:`lm_head`), so every rank runs this
module's path, kernels included, on its shard.  Layers placed over a mesh
of ranks (``parallel/sharding.py``, DTensor leaves: training across ranks
and ``parallel/inference.py``) are gathered to what their products compute
with at use, inside the layer's remat, and the config's ``tp_axis`` then
names the mesh's ``model`` group: the normed input enters the q/k/v and
gate/up products through Megatron's ``f`` (its gradient summed over the
ranks) and the o and down outputs leave through ``g`` (summed, its
gradient unchanged), both carried by autograd, so the flash forward and
backward run on the rank's heads.

Quantized weights (``ops/quant.py``): every dense weight, ``lm_head``
included, goes through :func:`proj`, the port of the JAX ``proj`` +
``fused_int4_proj``.  A quantized leaf with bf16 rows <=
``MAX_FUSED_ROWS`` (``ops/int4_matmul.py``) on a CUDA tensor, outside
``disable_fused_proj()``, launches ``int4_matmul`` / ``int8_matmul``;
everything else (other dtypes, more rows, the CPU) dequantizes to bf16 and
multiplies, as the JAX package does off the TPU.
The MLP of the fused layout takes ``quant_mlp`` under the JAX rule (rows
<= 32, bf16, CUDA, fused kernels enabled).

Training (``cache=None``): the forward carries gradients and writes nothing
in place.  A LoRA leaf (``ops/lora.py``) multiplies as ``x W^T + ((x A^T)
B^T) * scale`` over a plain or a quantized base.  With ``cfg.remat`` each
decoder layer is recomputed in the backward (``torch.utils.checkpoint``);
``cfg.remat_policy`` says what the first forward keeps (the JAX policies):

* ``"dots"``: the output of every product with no batch dims (``aten.mm``
  / ``aten.addmm``, the JAX ``dots_with_no_batch_dims_saveable``): every
  projection, LoRA's included, so the recompute runs no projection;
* ``"names:<tag,...>"``: ``attn_q`` / ``attn_k`` / ``attn_v`` / ``attn_o``
  keep the products that make q, k, v (before rope, which recomputes on
  the elementwise path) and the o projection's output; ``flash_out`` with
  ``flash_lse`` keep the flash forward's ``out`` and ``lse`` so the
  recompute does not launch that kernel again; ``"names:attn"`` is all six.

The first two go through ``create_selective_checkpoint_contexts`` with a
policy over the dispatched ops; a product computed inside
:func:`checkpoint_name` carries its tags.  PyTorch's recompute re-runs
every op it has not kept (XLA drops the ones nothing needs), so a named
tensor is kept as the products that make it.  The quantized matmul
kernels and the flash kernel are launched outside the dispatcher and
recompute under every policy but the flash names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import sys
import threading
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..config import LlamaConfig, torch_dtype
from ..ops.attention import attention, attention_reference
from ..ops.decode_attention import flash_decode_attention
from ..ops.flash_attention import FlashResiduals
from ..ops.fused_mlp import MAX_ROWS as MLP_MAX_ROWS, quant_mlp
from ..ops.int4_matmul import MAX_FUSED_ROWS, leaf_matmul
from ..ops.quant import (Q4KEY, _quantize_kv_slots, dequantize_array,
                         fused_proj_enabled, is_quantized)
from ..parallel.collectives import tp_group


@dataclasses.dataclass
class KVCache:
    """Fixed-capacity KV buffers for all layers, updated in place.

    ``write_idx`` may be given as an int; it is kept as a () int32 tensor on
    the cache's device, and ``host_idx`` as the host's count of the same
    slot.  :meth:`set_write_idx` sets both."""

    k: torch.Tensor          # (n_layers, B, S_max, n_kv, Dh)
    v: torch.Tensor          # (n_layers, B, S_max, n_kv, Dh)
    valid: torch.Tensor      # (B, S_max) bool: filled and attendable slots
    positions: torch.Tensor  # (B, S_max) int32: absolute position per slot
    write_idx: Union[int, torch.Tensor] = 0   # () int32: next slot to fill
    k_scale: Optional[torch.Tensor] = None   # (n_layers, B, S_max, n_kv) f32
    v_scale: Optional[torch.Tensor] = None   # int8 caches only
    host_idx: Optional[int] = None           # the host's count of write_idx

    def __post_init__(self):
        if isinstance(self.write_idx, torch.Tensor):
            if self.host_idx is None:
                raise ValueError("KVCache: a device write_idx needs its "
                                 "host_idx")
            return
        self.host_idx = int(self.write_idx)
        self.write_idx = torch.full((), self.host_idx, dtype=torch.int32,
                                    device=self.k.device)

    def set_write_idx(self, n: int) -> None:
        """Point the next write at slot ``n``, on the device and the host."""
        self.write_idx.fill_(n)
        self.host_idx = int(n)


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


def layer_norm_nobias(x: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Bias-free LayerNorm (MPT's ``LPLayerNorm`` with ``no_bias``) in f32,
    cast back to the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


def alibi_slopes(num_heads: int, alibi_bias_max: float = 8.0,
                 device=None) -> torch.Tensor:
    """(H,) f32 alibi slopes, MPT's convention (for a head count that is not
    a power of two, the odd-indexed slopes of the next power first, then
    the even), made on ``device`` with no host copy."""
    n = 2 ** math.ceil(math.log2(num_heads))
    m = torch.arange(1, n + 1, dtype=torch.float32, device=device) \
        * (alibi_bias_max / n)
    slopes = 1.0 / torch.exp2(m)
    if n != num_heads:
        slopes = torch.cat([slopes[1::2], slopes[0::2]])[:num_heads]
    return slopes


def alibi_bias(num_heads: int, q_positions: torch.Tensor,
               kv_positions: torch.Tensor) -> torch.Tensor:
    """``-slope * max(q_pos - kv_pos, 0)`` as (B, H, Sq, Sk) f32; future
    slots are left to the causal mask."""
    slopes = alibi_slopes(num_heads, device=q_positions.device)
    rel = (q_positions[:, None, :, None]
           - kv_positions[:, None, None, :]).float()
    return -slopes[None, :, None, None] * torch.clamp(rel, min=0)


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
    """``x (..., in)`` times a weight leaf stored ``(out, in)`` (a tensor,
    a quantized dict or a LoRA wrapper of either) -> ``(..., out)``."""
    if isinstance(leaf, dict) and "lora_a" in leaf:
        # the base product (never differentiated in the weight) plus the
        # rank-r products in the activation dtype
        y = proj(x, leaf["w"])
        a = F.linear(x.to(y.dtype), leaf["lora_a"].to(y.dtype))
        return y + F.linear(a, leaf["lora_b"].to(y.dtype)) \
            * leaf["lora_scale"].to(y.dtype)
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


def _mpt_ffn(f: dict, x: torch.Tensor) -> torch.Tensor:
    """MPT's MLP: ``up_proj`` -> exact GELU -> ``down_proj``."""
    return proj(F.gelu(proj(x, f["up_proj"])), f["down_proj"])


def final_norm(params: dict, cfg: LlamaConfig,
               hidden: torch.Tensor) -> torch.Tensor:
    """The norm after the last layer: MPT's bias-free LayerNorm, else
    RMSNorm."""
    if cfg.arch == "mpt":
        return layer_norm_nobias(hidden, params["norm"])
    return rms_norm(hidden, params["norm"], cfg.rms_norm_eps)


def lm_head(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Vocabulary logits in float32 (MPT has no ``lm_head``: its head is the
    embedding table, ``(vocab, D)``, already ``(out, in)``)."""
    return proj(hidden, params.get("lm_head", params["embed_tokens"])).float()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _write_slots(cache: KVCache, layer_idx: int, slots: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor) -> None:
    """The new tokens' ``(B, Hkv, S, Dh)`` K/V into layer ``layer_idx`` of
    the cache at the device slots ``slots``; int8 caches quantize per
    (slot, head)."""
    ck, cv = cache.k[layer_idx], cache.v[layer_idx]
    if cache.k_scale is None:
        ck.index_copy_(1, slots, k.transpose(1, 2).to(ck.dtype))
        cv.index_copy_(1, slots, v.transpose(1, 2).to(cv.dtype))
        return
    for c, cs, x in ((ck, cache.k_scale[layer_idx], k),
                     (cv, cache.v_scale[layer_idx], v)):
        xq, xs = _quantize_kv_slots(x.transpose(1, 2))
        c.index_copy_(1, slots, xq)
        cs.index_copy_(1, slots, xs)


def _dequantized_layer(cache: KVCache, layer_idx: int, dtype: torch.dtype):
    """Layer ``layer_idx`` of the cache as ``(B, S_max, Hkv, Dh)`` K and V in
    ``dtype`` (an int8 cache times its scales)."""
    ck, cv = cache.k[layer_idx], cache.v[layer_idx]
    if cache.k_scale is None:
        return ck, cv
    return tuple((c.float() * cs[layer_idx][..., None]).to(dtype)
                 for c, cs in ((ck, cache.k_scale), (cv, cache.v_scale)))


def _mpt_layer_forward(lp: dict, hidden: torch.Tensor, *, cfg: LlamaConfig,
                       q_positions, kv_valid, cache: Optional[KVCache],
                       layer_idx: int,
                       slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One MPT block: bias-free LayerNorm, fused ``Wqkv`` split in three,
    attention with the alibi bias on the plain path (an int8 cache
    dequantized first, as the JAX package does), GELU MLP."""
    B, S, D = hidden.shape
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    a = lp["attn"]

    x = layer_norm_nobias(hidden, lp["norm_1"])
    q, k, v = (t.reshape(B, S, H, Dh).transpose(1, 2)
               for t in proj(x, a["Wqkv"]).chunk(3, dim=-1))
    if cache is None:
        kvp = q_positions
    else:
        _write_slots(cache, layer_idx, slots, k, v)
        ck, cv = _dequantized_layer(cache, layer_idx, hidden.dtype)
        k, v = ck.transpose(1, 2), cv.transpose(1, 2)
        kvp, kv_valid = cache.positions, cache.valid
    out = attention_reference(
        q, k, v, causal=True, q_positions=q_positions, kv_positions=kvp,
        kv_valid=kv_valid, bias=alibi_bias(H, q_positions, kvp))
    out = out.transpose(1, 2).reshape(B, S, D)
    hidden = hidden + proj(out, a["out_proj"])
    return hidden + _mpt_ffn(lp["ffn"], layer_norm_nobias(hidden,
                                                          lp["norm_2"]))


def _layer_forward(lp: dict, hidden: torch.Tensor, *, cfg: LlamaConfig,
                   cos, sin, q_positions, kv_valid,
                   cache: Optional[KVCache], layer_idx: int,
                   slots: Optional[torch.Tensor] = None,
                   q_index_offset: int = 0,
                   flash_residuals: Optional[FlashResiduals] = None
                   ) -> torch.Tensor:
    """One decoder layer.  With a cache, the S new K/V slots are written in
    place at the device indices ``slots`` (S,) of layer ``layer_idx`` and
    attention reads that layer's whole cache."""
    B, S, _ = hidden.shape
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    a, m = lp["self_attn"], lp["mlp"]
    window = cfg.sliding_window or None

    x = rms_norm(hidden, lp["input_layernorm"], cfg.rms_norm_eps)
    if cfg.tp_axis:
        x = tp_group(cfg.tp_axis).enter(x)
    if "qkv_proj" in a:
        with checkpoint_name("attn_q", "attn_k", "attn_v"):
            qkv = proj(x, a["qkv_proj"])
        q, k, v = qkv.split([H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    else:
        q, k, v = (_named_proj(x, a[n], "attn_" + n[0])
                   for n in ("q_proj", "k_proj", "v_proj"))
    q = q.reshape(B, S, H, Dh).transpose(1, 2)
    k = k.reshape(B, S, Hkv, Dh).transpose(1, 2)
    v = v.reshape(B, S, Hkv, Dh).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        out = attention(q, k, v, causal=True, q_positions=q_positions,
                        kv_positions=q_positions, kv_valid=kv_valid,
                        sliding_window=window, impl=cfg.attn_impl,
                        flash_residuals=flash_residuals)
    else:
        _write_slots(cache, layer_idx, slots, k, v)
        ck, cv = cache.k[layer_idx], cache.v[layer_idx]   # (B, S_max, Hkv, Dh)
        cks = cvs = None
        if cache.k_scale is not None:
            if S == 1 and cfg.attn_impl == "auto" \
                    and q.device.type == "cuda":
                # int8 slots read in place with their per-(slot, head) scales
                cks, cvs = cache.k_scale[layer_idx], cache.v_scale[layer_idx]
            else:
                # prefill, and the CPU: this layer's cache dequantized to
                # the activation dtype first, as the JAX package does
                ck, cv = _dequantized_layer(cache, layer_idx, hidden.dtype)
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
    o = _named_proj(out, a["o_proj"], "attn_o")
    if cfg.tp_axis:
        # this rank's heads feed its columns of o_proj: the partial
        # products of every rank add up before the residual (the JAX psum)
        o = tp_group(cfg.tp_axis).all_reduce(o)
    hidden = hidden + o
    x = rms_norm(hidden, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    if cfg.tp_axis:
        x = tp_group(cfg.tp_axis).enter(x)
    y = _mlp(m, x)
    if cfg.tp_axis:
        # down_proj's columns are this rank's share of the MLP width
        y = tp_group(cfg.tp_axis).all_reduce(y)
    return hidden + y


ATTN_NAMES = ("attn_q", "attn_k", "attn_v", "attn_o", "flash_out",
              "flash_lse")
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_tags = threading.local()


@contextlib.contextmanager
def checkpoint_name(*names: str):
    """The products dispatched inside carry ``names`` for a
    ``names:`` remat policy (the JAX ``checkpoint_name``); outside such a
    policy the tags are never read."""
    prev = getattr(_tags, "names", ())
    _tags.names = names
    try:
        yield
    finally:
        _tags.names = prev


def _named_proj(x: torch.Tensor, leaf, name: str) -> torch.Tensor:
    with checkpoint_name(name):
        return proj(x, leaf)


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_named(names: frozenset, ctx, op, *args, **kwargs
                ) -> CheckpointPolicy:
    keep = op in _PRODUCTS and not names.isdisjoint(
        getattr(_tags, "names", ()))
    return (CheckpointPolicy.MUST_SAVE if keep
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_plan(policy: str):
    """``(context_fn for checkpoint, whether the flash forward's out and
    lse are kept)`` of a remat policy; an unknown policy or tag raises
    ``ValueError``."""
    if not policy:
        return noop_context_fn, False
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_products), False
    if policy.startswith("names:"):
        spec = policy[len("names:"):]
        names = set(ATTN_NAMES if spec == "attn" else spec.split(","))
        unknown = names - set(ATTN_NAMES)
        if unknown:
            raise ValueError(f"remat_policy={policy!r}: unknown names "
                             f"{sorted(unknown)} (expected {ATTN_NAMES} or "
                             f"'attn')")
        keep_flash = {"flash_out", "flash_lse"} <= names
        layer = frozenset(names - {"flash_out", "flash_lse"})
        if not layer:
            return noop_context_fn, keep_flash
        return functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_save_named, layer)), keep_flash
    raise ValueError(f"unknown remat_policy={policy!r} (expected '', 'dots', "
                     f"or 'names:<tag,...>')")


def is_placed(tree) -> bool:
    """Whether ``tree``'s leaves are placed over a mesh of ranks (DTensors,
    ``parallel/sharding.py``).  No DTensor exists before
    ``torch.distributed.tensor`` is imported, so a one-card run never
    imports it."""
    if "torch.distributed.tensor" not in sys.modules:
        return False
    from ..parallel.sharding import is_sharded
    return is_sharded(tree)


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
    cache: the S tokens are appended at ``cache.write_idx`` (in place, a
    device index) and attend over the whole cache; prefill (S > 1) and
    decode (S == 1) share this path."""
    B, S, _ = inputs_embeds.shape
    if attn_valid is None:
        attn_valid = torch.ones((B, S), dtype=torch.bool,
                                device=inputs_embeds.device)
    cos = sin = None     # MPT has no RoPE: the alibi bias encodes position
    if cfg.arch != "mpt":
        cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)

    slots = None
    if cache is not None:
        w = cache.host_idx
        if w + S > cache.valid.shape[1]:
            raise ValueError(f"KV cache full: {w} + {S} > "
                             f"{cache.valid.shape[1]}")
        slots = cache.write_idx + torch.arange(S, device=cache.valid.device)
        cache.valid.index_copy_(1, slots, attn_valid.to(torch.bool))
        cache.positions.index_copy_(1, slots, position_ids.to(torch.int32))
        kv_valid = None
    else:
        kv_valid = attn_valid

    hidden = inputs_embeds
    # layers placed over a mesh of ranks: each is gathered to what its
    # products compute with at use, inside its remat
    placed = is_placed(params["layers"])
    if placed:
        from ..parallel.sharding import compute_tree
    remat = cache is None and cfg.remat and torch.is_grad_enabled()
    context_fn, keep_flash = _remat_plan(cfg.remat_policy) if remat \
        else (noop_context_fn, False)
    for i, lp in enumerate(params["layers"]):
        def layer(h, lp=lp, i=i, res=FlashResiduals() if keep_flash else None):
            if placed:
                lp = compute_tree(lp, f"llama/layers/{i}")
            if cfg.arch == "mpt":
                return _mpt_layer_forward(
                    lp, h, cfg=cfg, q_positions=position_ids,
                    kv_valid=kv_valid, cache=cache, layer_idx=i, slots=slots)
            return _layer_forward(
                lp, h, cfg=cfg, cos=cos, sin=sin, q_positions=position_ids,
                kv_valid=kv_valid, cache=cache, layer_idx=i, slots=slots,
                q_index_offset=q_index_offset, flash_residuals=res)

        # no random op in a layer, so the recompute needs no RNG state
        hidden = checkpoint(layer, hidden, use_reentrant=False,
                            preserve_rng_state=False,
                            context_fn=context_fn) if remat \
            else layer(hidden)
    if cache is not None:
        cache.write_idx.add_(S)
        cache.host_idx += S
    return final_norm(params, cfg, hidden), cache


def llama_logits(params: dict, cfg: LlamaConfig, input_ids: torch.Tensor,
                 position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Convenience text-only forward: ids -> float32 logits (B, S, V)."""
    if position_ids is None:
        B, S = input_ids.shape
        position_ids = torch.arange(S, device=input_ids.device).expand(B, S)
    h = embed_tokens(params, input_ids)
    h, _ = llama_forward(params, cfg, h, position_ids=position_ids)
    return lm_head(params, h)
