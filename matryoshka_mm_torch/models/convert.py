"""Parameters of the PyTorch port: the bridge from the JAX package's
parameter pytree, the port's own random initialisation, and the
conversion of HF / LLaVA state dicts (:func:`convert_llava_state`, the
JAX ``models/convert.py`` mapping, with :func:`merge_lora` for LoRA
adapters; :func:`convert_llama` and :func:`convert_mpt` for a bare HF
decoder).

Port layout (plain dicts of tensors):

* ``llama``: HF key names, dense weights ``(out, in)``; ``layers`` is a
  list of per-layer dicts (the JAX leaves are stacked ``(L, ...)`` and
  already ``(out, in)``, so they are only unstacked).  LLaMA and Mistral
  layers hold ``self_attn`` / ``mlp``; MPT's hold HF MPT's ``norm_1``,
  ``norm_2``, ``attn`` (``Wqkv``, ``out_proj``) and ``ffn`` (``up_proj``,
  ``down_proj``), and its tree has no ``lm_head``;
* ``vision_tower`` / ``mm_projector``: JAX dense leaves are
  ``{"kernel": (in, out), "bias"}`` and become ``{"weight": (out, in),
  "bias"}`` for ``F.linear``; ``patch_embedding`` stays the ``(3*P*P, D)``
  matrix (one matmul, not a conv);
* quantized leaves (from the JAX ``maybe_quantize``, any ``fuse``) become
  per-layer ``{"qint4" | "qint8", "scale"}`` dicts with their dtypes kept;
  the TPU tile padding recorded in ``orig_shape`` is cut off (for int4 the
  pad bytes sit after each half's ``K/2`` columns, so ``[:n, :k // 2]``);
* a LoRA leaf ``{"w", "lora_a", "lora_b", "lora_scale"}`` (over a plain
  or a quantized base) is unstacked with its layer and keeps its keys and
  orientations; ``router`` dense leaves are transposed like every other;
* serving state: :func:`paged_cache_from_jax` and
  :func:`page_allocator_from_jax` carry a paged KV pool and its allocator
  across.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config import LlavaConfig, torch_dtype
from ..kvconfig import parse_kv_from_string
from ..ops.quant import Q4KEY, QKEY, is_quantized
from .projector import projector_depth
from .router import init_dense_gating_params


class _Staging:
    """Pinned host buffers that a checkpoint reader's lazy arrays are read
    into on their way to the card, one per slot (a leaf and its scale or
    bias), reused leaf after leaf: no fresh pages to fault in, and the
    copies to the card are DMA transfers."""

    def __init__(self):
        self.bufs: Dict[int, torch.Tensor] = {}

    def take(self, slot: int, shape, dtype: torch.dtype) -> torch.Tensor:
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        buf = self.bufs.get(slot)
        if buf is None or buf.numel() < n:
            self.bufs[slot] = buf = None
            buf = self.bufs[slot] = torch.empty(n, dtype=torch.uint8,
                                                pin_memory=True)
        return buf[:n].view(dtype).view(shape)


def _host(a, staging: Optional[_Staging] = None, slot: int = 0):
    """A JAX leaf as a CPU tensor: a numpy array (ml_dtypes bfloat16
    included), a CPU tensor, or a checkpoint reader's lazy array, which is
    read here (into ``staging``'s buffer ``slot`` when given: valid until
    that slot is taken again)."""
    if hasattr(a, "load"):              # utils/orbax_io.LazyArray
        a = a.load(staging.take(slot, a.shape, a.dtype)
                   if staging is not None else None)
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))   # a writable copy


def _tensor(a, device, dtype: Optional[torch.dtype]):
    """A contiguous copy of ``a`` (a tensor or a JAX leaf, as
    :func:`_host` takes it) on ``device`` that shares no storage with it."""
    t = a if isinstance(a, torch.Tensor) else _host(a)
    return t.to(device=device, dtype=dtype or t.dtype,
                memory_format=torch.contiguous_format, copy=True)


def strip_padding(leaf: dict) -> dict:
    """A JAX quantized leaf (numpy) -> ``{key, "scale"}`` without the tile
    padding.  ``orig_shape`` is read by attribute (``.n``, ``.k``)."""
    key = Q4KEY if Q4KEY in leaf else QKEY
    q, scale = np.asarray(leaf[key]), np.asarray(leaf["scale"])
    shape = leaf.get("orig_shape")
    if shape is not None:
        k = shape.k // 2 if key == Q4KEY else shape.k
        q, scale = q[..., :shape.n, :k], scale[..., :shape.n, :]
    return {key: q, "scale": scale}


def _split(h: torch.Tensor, fn, n: Optional[int], keep_dtype=False):
    """One host leaf converted whole, or as its ``n`` stacked slices."""
    if n is None:
        return fn(h, keep_dtype=keep_dtype)
    if h.shape[0] != n:
        raise ValueError(f"stacked leaf has {h.shape[0]} entries, expected "
                         f"{n}")
    return [fn(h[i], keep_dtype=keep_dtype) for i in range(n)]


def _zip(tree: dict, n: Optional[int]):
    """``{k: [n per-layer values]}`` -> n per-layer dicts."""
    if n is None:
        return tree
    return [{k: v[i] for k, v in tree.items()} for i in range(n)]


def _map(tree, fn, n: Optional[int] = None,
         staging: Optional[_Staging] = None):
    """A JAX subtree -> the port's, each leaf read once and converted by
    ``fn``.  With ``n`` the subtree is stacked ``(n, ...)`` and a list of
    n per-layer subtrees comes back."""
    if is_quantized(tree):
        key = Q4KEY if Q4KEY in tree else QKEY
        q = _host(tree[key], staging, 0)
        scale = _host(tree["scale"], staging, 1)
        shape = tree.get("orig_shape")
        if shape is not None:
            k = shape.k // 2 if key == Q4KEY else shape.k
            q, scale = q[..., :shape.n, :k], scale[..., :shape.n, :]
        return _zip({key: _split(q, fn, n, keep_dtype=True),
                     "scale": _split(scale, fn, n, keep_dtype=True)}, n)
    if isinstance(tree, dict):
        if set(tree) == {"kernel", "bias"}:
            kernel = _host(tree["kernel"], staging, 0).mT
            bias = _host(tree["bias"], staging, 1)
            return _zip({"weight": _split(kernel, fn, n),
                         "bias": _split(bias, fn, n)}, n)
        return _zip({k: _map(v, fn, n, staging) for k, v in tree.items()}, n)
    if isinstance(tree, list):
        items = [_map(v, fn, n, staging) for v in tree]
        return items if n is None else [[v[i] for v in items]
                                        for i in range(n)]
    return _split(_host(tree, staging, 0), fn, n)


def _lora_from_jax(tree: dict, cfg: LlavaConfig, fn, staging) -> dict:
    """A JAX ``extract_lora`` tree: adapters of stacked layers unstacked."""
    out = {}
    for key, sub in tree.items():
        n = {"llama": cfg.llama.num_hidden_layers,
             "vision_tower": cfg.vision.num_hidden_layers}.get(key)
        if n is not None and "layers" in sub:
            out[key] = {k: _map(v, fn, n if k == "layers" else None, staging)
                        for k, v in sub.items()}
        else:
            out[key] = _map(sub, fn, staging=staging)
    return out


def params_from_jax(np_tree: dict, cfg: LlavaConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """JAX LLaVA parameters -> port params.  Leaves are numpy arrays, CPU
    tensors or a checkpoint reader's lazy arrays (each read once, as it is
    converted, so the host holds one leaf at a time).  The tree may be a
    subset a checkpoint saves: the projector-only one, or the LoRA one
    (``lora`` + the non-LoRA trainables).  ``dtype`` casts every float
    leaf; None keeps each leaf's dtype.  Quantized leaves keep theirs."""
    def fn(a, keep_dtype=False):
        return _tensor(a, device, None if keep_dtype else dtype)

    staging = _Staging() if torch.device(device).type == "cuda" else None
    out = {}
    for key, sub in np_tree.items():
        if key in ("llama", "vision_tower"):
            n = (cfg.llama if key == "llama" else cfg.vision
                 ).num_hidden_layers
            out[key] = {k: _map(v, fn, n if k == "layers" else None, staging)
                        for k, v in sub.items()}
        elif key == "lora":
            out[key] = _lora_from_jax(sub, cfg, fn, staging)
        else:
            out[key] = _map(sub, fn, staging=staging)
    return out


def bert_params_from_jax(np_tree: dict, cfg, device="cuda") -> dict:
    """The JAX text embedder's BERT parameters (every leaf a numpy array,
    ``layers`` stacked) -> the port's ``models/text_embedder.py`` layout,
    float32: layers unstacked, dense kernels ``(in, out)`` transposed to
    ``(out, in)``."""
    def fn(a, keep_dtype=False):
        return _tensor(a, device, torch.float32)

    return {k: _map(v, fn, cfg.num_hidden_layers if k == "layers" else None)
            for k, v in np_tree.items()}


def _stack(items: list, lazy: bool, staging: Optional[_Staging] = None):
    """Per-layer tensors -> one stacked leaf, built on the host layer by
    layer (no second copy on the card), in ``staging``'s buffer when
    given; with ``lazy`` a callable that builds it."""
    def build():
        first = items[0]
        shape = (len(items), *first.shape)
        out = staging.take(0, shape, first.dtype) if staging is not None \
            else torch.empty(shape, dtype=first.dtype)
        for i, t in enumerate(items):
            out[i].copy_(t.detach())
        return out
    return build if lazy else build()


def _to_jax(tree, stacked: bool, lazy: bool,
            staging: Optional[_Staging] = None):
    """A port subtree -> the JAX one: dense ``{"weight" (out, in), "bias"}``
    -> ``{"kernel" (in, out), "bias"}``.  With ``stacked``, ``tree`` is a
    list of per-layer subtrees of one structure, stacked leaf by leaf."""
    first = tree[0] if stacked else tree
    if isinstance(first, dict):
        dense = set(first) == {"weight", "bias"} and first["weight"].dim() == 2
        out = {}
        for k in first:
            sub = [t[k] for t in tree] if stacked else tree[k]
            if dense and k == "weight":
                sub = [t.mT for t in sub] if stacked else sub.mT
                k = "kernel"
            out[k] = _to_jax(sub, stacked, lazy, staging)
        return out
    if isinstance(first, list) and not stacked:
        return [_to_jax(v, False, lazy, staging) for v in tree]
    if isinstance(first, list):
        return [_to_jax([t[i] for t in tree], True, lazy, staging)
                for i in range(len(first))]
    if stacked:
        return _stack(tree, lazy, staging)
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree.detach()
    return (lambda: t.cpu().contiguous()) if lazy else t.contiguous()


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def params_to_jax(params: dict, cfg: LlavaConfig, lazy: bool = False) -> dict:
    """The inverse of :func:`params_from_jax`: the port's parameters (the
    full tree, or the projector-only or LoRA subset) -> the JAX package's
    tree, as torch tensors.  Per-layer lists are stacked ``(L, ...)``
    (``cfg`` gives L) and dense weights transposed to ``(in, out)``
    kernels; quantized leaves keep their unpadded ``q`` / ``q4`` and
    ``scale``.  With ``lazy`` every leaf is a callable that builds it on
    the host, so a writer holds one leaf at a time; parameters on the card
    stack into one pinned buffer, so a built leaf is valid until the next
    is built."""
    on_card = any(t.is_cuda for t in _leaves(params))
    staging = _Staging() if lazy and on_card else None

    def subtree(sub: dict, n: int) -> dict:
        out = {}
        for k, v in sub.items():
            if k == "layers":
                if len(v) != n:
                    raise ValueError(f"{len(v)} layers, expected {n}")
                out[k] = _to_jax(v, True, lazy, staging)
            else:
                out[k] = _to_jax(v, False, lazy)
        return out

    layers = {"llama": cfg.llama.num_hidden_layers,
              "vision_tower": cfg.vision.num_hidden_layers}
    out = {}
    for key, sub in params.items():
        if key in layers:
            out[key] = subtree(sub, layers[key])
        elif key == "lora":
            out[key] = {k: subtree(v, layers[k]) if k in layers
                        and "layers" in v else _to_jax(v, False, lazy)
                        for k, v in sub.items()}
        else:
            out[key] = _to_jax(sub, False, lazy)
    return out


def _llama_tree(lc, make) -> dict:
    """The decoder's parameter tree, each leaf ``make(kind, shape, dtype)``
    with ``kind`` one of ``"normal"``, ``"ones"``, ``"zeros"``.  MPT's
    (the JAX ``init_llama_params`` branch) has HF MPT's block names and no
    ``lm_head``: its head is the embedding table."""
    dt = torch_dtype(lc.dtype)
    D, I = lc.hidden_size, lc.intermediate_size
    H, Hkv, Dh = lc.num_attention_heads, lc.num_key_value_heads, lc.head_dim
    if lc.arch == "mpt":
        return {
            "embed_tokens": make("normal", (lc.vocab_size, D), dt),
            "layers": [{
                "norm_1": make("ones", (D,), dt),
                "norm_2": make("ones", (D,), dt),
                "attn": {"Wqkv": make("normal", (3 * D, D), dt),
                         "out_proj": make("normal", (D, D), dt)},
                "ffn": {"up_proj": make("normal", (I, D), dt),
                        "down_proj": make("normal", (D, I), dt)},
            } for _ in range(lc.num_hidden_layers)],
            "norm": make("ones", (D,), dt),
        }
    llama = {
        "embed_tokens": make("normal", (lc.vocab_size, D), dt),
        "layers": [{
            "input_layernorm": make("ones", (D,), dt),
            "post_attention_layernorm": make("ones", (D,), dt),
            "self_attn": {"q_proj": make("normal", (H * Dh, D), dt),
                          "k_proj": make("normal", (Hkv * Dh, D), dt),
                          "v_proj": make("normal", (Hkv * Dh, D), dt),
                          "o_proj": make("normal", (D, H * Dh), dt)},
            "mlp": {"gate_proj": make("normal", (I, D), dt),
                    "up_proj": make("normal", (I, D), dt),
                    "down_proj": make("normal", (D, I), dt)},
        } for _ in range(lc.num_hidden_layers)],
        "norm": make("ones", (D,), dt),
    }
    if not lc.tie_word_embeddings:
        llama["lm_head"] = make("normal", (lc.vocab_size, D), dt)
    return llama


def _dense(make, out_dim, in_dim, dtype) -> dict:
    return {"weight": make("normal", (out_dim, in_dim), dtype),
            "bias": make("zeros", (out_dim,), dtype)}


def _vision_tree(vc, make) -> dict:
    """The CLIP tower's parameter tree (``make`` as in :func:`_llama_tree`)."""
    dt = torch_dtype(vc.dtype)
    VD, VI, P = vc.hidden_size, vc.intermediate_size, vc.patch_size

    def ln():
        return {"weight": make("ones", (VD,), dt),
                "bias": make("zeros", (VD,), dt)}

    return {
        "class_embedding": make("normal", (VD,), dt),
        "patch_embedding": make("normal", (3 * P * P, VD), dt),
        "position_embedding": make("normal", (vc.num_positions, VD), dt),
        "pre_layrnorm": ln(),
        "layers": [{
            "layer_norm1": ln(),
            "self_attn": {n: _dense(make, VD, VD, dt)
                          for n in ("q_proj", "k_proj", "v_proj",
                                    "out_proj")},
            "layer_norm2": ln(),
            "mlp": {"fc1": _dense(make, VI, VD, dt),
                    "fc2": _dense(make, VD, VI, dt)},
        } for _ in range(vc.num_hidden_layers)],
        "post_layernorm": ln(),
    }


def _projector_tree(cfg: LlavaConfig, make) -> dict:
    D, dt = cfg.llama.hidden_size, torch_dtype(cfg.llama.dtype)
    depth = projector_depth(cfg.mm_projector_type)
    return {"layers": [_dense(make, D, cfg.mm_hidden_size if i == 0 else D,
                              dt)
                       for i in range(depth)]} if depth else {}


def _random_maker(gen: torch.Generator, device):
    """normal(0, 0.02), ones and zeros made on ``device`` from ``gen``."""
    def make(kind, shape, dtype):
        if kind == "normal":
            return torch.randn(shape, generator=gen, device=device,
                               dtype=dtype).mul_(0.02)
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(shape, dtype=dtype, device=device)
    return make


def init_params(cfg: LlavaConfig, device="cuda", seed: int = 0) -> dict:
    """Random parameters made on ``device`` (the card unless the caller
    names the CPU) with a seeded ``torch.Generator`` (normal(0, 0.02) dense
    weights, unit norms, zero biases), so a 7B model never crosses from the
    host.  An ``*unpad`` merge adds ``image_newline``, normal(0, D^-1/2)
    in the decoder's dtype, as the JAX ``init_llava_params``."""
    from .llava import router_embed_dim

    gen = torch.Generator(device=device).manual_seed(seed)
    make = _random_maker(gen, device)
    params = {"llama": _llama_tree(cfg.llama, make),
              "vision_tower": _vision_tree(cfg.vision, make),
              "mm_projector": _projector_tree(cfg, make)}
    if cfg.is_m3_moe and parse_kv_from_string(cfg.preset.moe).get("t") \
            == "dense":
        params["router"] = init_dense_gating_params(
            gen, router_embed_dim(cfg), len(cfg.tokscale_list), device=device)
    if "unpad" in cfg.mm_patch_merge_type:
        D = cfg.llama.hidden_size
        params["image_newline"] = (
            torch.randn((D,), generator=gen, device=device) * D ** -0.5
        ).to(torch_dtype(cfg.llama.dtype))
    return params


def random_vision_tower(cfg: LlavaConfig, device="cuda",
                        seed: int = 0) -> dict:
    """A random CLIP tower made on ``device`` from ``seed``, as
    :func:`init_params` makes one (for checkpoints that ship none)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return _vision_tree(cfg.vision, _random_maker(gen, device))


# ---------------------------------------------------------------------------
# HF / LLaVA state dicts (the JAX package's convert_clip_vision,
# convert_llama, convert_projector, convert_router and
# convert_llava_checkpoint, streamed one tensor at a time)
# ---------------------------------------------------------------------------

TOWER_PREFIX = "model.vision_tower.vision_tower.vision_model."

_HF_KEYS = [(re.compile(p), fn) for p, fn in (
    (r"model\.embed_tokens\.weight", lambda m: ("llama", "embed_tokens")),
    (r"model\.norm\.weight", lambda m: ("llama", "norm")),
    (r"lm_head\.weight", lambda m: ("llama", "lm_head")),
    (r"model\.layers\.(\d+)\.(input_layernorm|post_attention_layernorm)"
     r"\.weight", lambda m: ("llama", "layers", int(m[1]), m[2])),
    (r"model\.layers\.(\d+)\.(self_attn)\.([qkvo]_proj)\.weight",
     lambda m: ("llama", "layers", int(m[1]), m[2], m[3])),
    (r"model\.layers\.(\d+)\.(mlp)\.(gate_proj|up_proj|down_proj)"
     r"\.weight", lambda m: ("llama", "layers", int(m[1]), m[2], m[3])),
    (re.escape(TOWER_PREFIX) + r"embeddings\.class_embedding",
     lambda m: ("vision_tower", "class_embedding")),
    (re.escape(TOWER_PREFIX) + r"embeddings\.patch_embedding\.weight",
     lambda m: ("vision_tower", "patch_embedding")),
    (re.escape(TOWER_PREFIX) + r"embeddings\.position_embedding\.weight",
     lambda m: ("vision_tower", "position_embedding")),
    (re.escape(TOWER_PREFIX) + r"(pre_layrnorm|post_layernorm)\."
     r"(weight|bias)", lambda m: ("vision_tower", m[1], m[2])),
    (re.escape(TOWER_PREFIX) + r"encoder\.layers\.(\d+)\."
     r"(layer_norm1|layer_norm2)\.(weight|bias)",
     lambda m: ("vision_tower", "layers", int(m[1]), m[2], m[3])),
    (re.escape(TOWER_PREFIX) + r"encoder\.layers\.(\d+)\.(self_attn)\."
     r"(q_proj|k_proj|v_proj|out_proj)\.(weight|bias)",
     lambda m: ("vision_tower", "layers", int(m[1]), m[2], m[3], m[4])),
    (re.escape(TOWER_PREFIX) + r"encoder\.layers\.(\d+)\.(mlp)\."
     r"(fc1|fc2)\.(weight|bias)",
     lambda m: ("vision_tower", "layers", int(m[1]), m[2], m[3], m[4])),
    # a bare nn.Linear, or a Sequential with the Linears at even indices
    (r"model\.mm_projector\.(weight|bias)",
     lambda m: ("mm_projector", "layers", 0, m[1])),
    (r"model\.mm_projector\.(\d*[02468])\.(weight|bias)",
     lambda m: ("mm_projector", "layers", int(m[1]) // 2, m[2])),
    (r"model\.router\.(fc1|fc2)\.(weight|bias)",
     lambda m: ("router", m[1], m[2])),
    (r"model\.image_newline", lambda m: ("image_newline",)),
)]


def hf_param_path(key: str) -> Optional[tuple]:
    """The port's tree path of a HF / LLaVA state-dict key, or None for a
    key the JAX conversion does not read (``rotary_emb.inv_freq``,
    ``position_ids``, ...)."""
    for pat, fn in _HF_KEYS:
        m = pat.fullmatch(key)
        if m:
            return fn(m)
    return None


_MPT_KEYS = [(re.compile(p), fn) for p, fn in (
    (r"transformer\.wte\.weight", lambda m: ("embed_tokens",)),
    (r"transformer\.norm_f\.weight", lambda m: ("norm",)),
    (r"transformer\.blocks\.(\d+)\.(norm_1|norm_2)\.weight",
     lambda m: ("layers", int(m[1]), m[2])),
    (r"transformer\.blocks\.(\d+)\.(attn)\.(Wqkv|out_proj)\.weight",
     lambda m: ("layers", int(m[1]), m[2], m[3])),
    (r"transformer\.blocks\.(\d+)\.(ffn)\.(up_proj|down_proj)\.weight",
     lambda m: ("layers", int(m[1]), m[2], m[3])),
)]


def _llama_path(key: str) -> Optional[tuple]:
    path = hf_param_path(key)
    return path[1:] if path is not None and path[0] == "llama" else None


def _mpt_path(key: str) -> Optional[tuple]:
    for pat, fn in _MPT_KEYS:
        m = pat.fullmatch(key)
        if m:
            return fn(m)
    return None


def _meta(kind, shape, dtype) -> torch.Tensor:
    """A placeholder leaf (``make`` of :func:`_llama_tree`) that a state
    dict must fill."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _state_leaf(key: str, t: torch.Tensor, want, device, dtype,
                reshape=None) -> torch.Tensor:
    """A state dict's tensor as a port leaf: copied to ``device``, its float
    values cast to ``dtype``, reshaped, and held to the config's shape
    ``want`` (None: any)."""
    t = t.to(device, copy=True)      # never a view of the file
    if t.is_floating_point():
        t = t.to(dtype)
    if reshape is not None:
        t = reshape(t)
    if want is not None and tuple(t.shape) != tuple(want):
        raise ValueError(f"{key}: shape {tuple(t.shape)}, the config "
                         f"needs {tuple(want)}")
    return t


def _check_filled(tree: dict, what: str) -> None:
    from ..train.optimizer import named_leaves

    missing = [p for p, leaf in named_leaves(tree) if leaf.is_meta]
    if missing:
        raise ValueError(f"{what} lacks {len(missing)} parameters of the "
                         f"config, e.g. {missing[:4]}")


def _convert_decoder(items, lc, path_of, device) -> dict:
    """``(key, tensor)`` pairs of a decoder's HF state dict -> its port tree
    on ``device``, float leaves in ``lc.dtype``; every leaf of the config
    must come, ``lm_head`` may (else the head is the embedding table)."""
    tree = _llama_tree(lc, _meta)
    tree.pop("lm_head", None)
    for key, t in items:
        path = path_of(key)
        if path is None:
            continue
        if path == ("lm_head",):
            parent, want = tree, (lc.vocab_size, lc.hidden_size)
        else:
            parent = _parent(tree, path)
            if parent is None:
                continue        # a layer the config does not have
            want = parent[path[-1]].shape
        parent[path[-1]] = _state_leaf(key, t, want, device,
                                       torch_dtype(lc.dtype))
    _check_filled(tree, "the state dict")
    return tree


def convert_llama(state: Mapping[str, torch.Tensor], lc,
                  device="cuda") -> dict:
    """A HF ``LlamaForCausalLM`` / ``MistralForCausalLM`` state dict -> the
    port's decoder tree (the JAX ``convert_llama``: a rename, no
    transposes)."""
    return _convert_decoder(state.items(), lc, _llama_path, device)


def convert_mpt(state: Mapping[str, torch.Tensor], lc,
                device="cuda") -> dict:
    """A HF ``MptForCausalLM`` state dict -> the port's MPT decoder tree (the
    JAX ``convert_mpt``; ``transformer.wte`` is also the head)."""
    return _convert_decoder(state.items(), lc, _mpt_path, device)


def convert_llava_state(items, cfg: LlavaConfig, device="cuda") -> dict:
    """``(key, tensor)`` pairs of a LLaVA state dict (any device) -> port
    parameters on ``device``, each tensor moved there and its float leaves
    cast to bf16 one at a time (the JAX loader's ``cast_pytree``).  Keys keep their HF names and
    ``(out, in)`` orientation; the conv kernel of the patch embedding
    becomes the ``(3*P*P, D)`` matrix.  Every leaf of the config's
    decoder and projector must come; the CLIP tower is left out when no
    key of it comes (the caller then makes one), else it must be whole; a
    missing ``lm_head`` means tied embeddings; ``router`` and
    ``image_newline`` are kept when present.  Keys of layers the config
    does not have are skipped, as the JAX conversion skips them."""
    params = {"llama": _llama_tree(cfg.llama, _meta),
              "vision_tower": _vision_tree(cfg.vision, _meta),
              "mm_projector": _projector_tree(cfg, _meta)}
    params["llama"].pop("lm_head", None)
    for key, t in items:
        path = hf_param_path(key)
        if path is None:
            continue
        if path[0] in ("router", "image_newline") or path[-1] == "lm_head":
            parent, want = params, None
            for part in path[:-1]:
                parent = parent.setdefault(part, {})
            if path[-1] == "lm_head":
                want = (cfg.llama.vocab_size, cfg.llama.hidden_size)
        else:
            parent = _parent(params, path)
            if parent is None:
                continue        # a layer the config does not have
            want = parent[path[-1]].shape
        parent[path[-1]] = _state_leaf(
            key, t, want, device, torch.bfloat16,
            reshape=(lambda t: t.reshape(t.shape[0], -1).T.contiguous())
            if path[-1] == "patch_embedding" else None)
    from ..train.optimizer import named_leaves

    if all(leaf.is_meta for _, leaf in named_leaves(params["vision_tower"])):
        del params["vision_tower"]
    _check_filled(params, "the checkpoint")
    return params


def _parent(params: dict, path: tuple) -> Optional[dict]:
    """The dict that holds ``path``'s leaf in ``params``, or None when the
    tree has no such leaf."""
    node = params
    for part in path[:-1]:
        if isinstance(node, list):
            node = node[part] if part < len(node) else None
        else:
            node = node.get(part)
        if node is None:
            return None
    return node if path[-1] in node else None


def lora_pairs(adapter: Mapping[str, torch.Tensor]) -> Dict[str, tuple]:
    """A PEFT adapter state dict -> ``{base key: (lora_A, lora_B)}``, with
    ``base_model.model.`` and ``.default`` taken out of the keys (the JAX
    ``merge_lora``'s matching)."""
    out = {}
    for k, a in adapter.items():
        m = _LORA_A.fullmatch(k)
        if m:
            target = (m[1] + ".weight").replace("base_model.model.", "")
            out[target] = (a, adapter[k.replace("lora_A", "lora_B")])
    return out


_LORA_A = re.compile(r"(.*)\.lora_A(?:\.default)?\.weight")


def merge_lora(weight: torch.Tensor, lora_a: torch.Tensor,
               lora_b: torch.Tensor, scaling: float) -> torch.Tensor:
    """``W + scaling * B @ A`` in float32 on ``weight``'s device, whatever
    the operands' dtypes (the caller rounds the result once)."""
    dev = weight.device
    delta = lora_b.to(dev, torch.float32) @ lora_a.to(dev, torch.float32)
    return weight.to(torch.float32) + scaling * delta


def paged_cache_from_jax(k, v, k_scale=None, v_scale=None, device="cuda"):
    """The numpy arrays of a JAX ``PagedKVCache`` -> the port's
    ``serve.paged_cache.PagedKVCache`` with the same bytes.  The JAX scale
    pools are flat ``(L, n_pages, page * n_kv)`` (index ``slot * n_kv +
    head``); the port's ``(L, n_pages, page, n_kv)`` is a view of them."""
    from ..serve.paged_cache import PagedKVCache

    kt, vt = _tensor(k, device, None), _tensor(v, device, None)
    if k_scale is None:
        return PagedKVCache(kt, vt)
    return PagedKVCache(
        kt, vt, _tensor(k_scale, device, None).reshape(kt.shape[:4]),
        _tensor(v_scale, device, None).reshape(kt.shape[:4]))


def page_allocator_from_jax(tables, n_alloc, free, n_pages: int,
                            page_size: int):
    """The host state of a JAX ``PageAllocator`` (``tables``, ``n_alloc``,
    ``free``) -> the port's ``PageAllocator`` in the same state, so that both
    packages can decode from one pool state."""
    from ..serve.paged_cache import PageAllocator

    tables = np.asarray(tables, np.int32)
    alloc = PageAllocator(n_pages, page_size, tables.shape[0],
                          tables.shape[1])
    alloc.tables[:] = tables
    alloc.n_alloc[:] = np.asarray(n_alloc, np.int32)
    alloc.free = [int(p) for p in free]
    return alloc
