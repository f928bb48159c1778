"""``load_pretrained_model`` for the PyTorch port (port of
``matryoshka_mm_tpu/models/builder.py``), returning
``(tokenizer, model, image_processor, context_len)``.

Sources, in the JAX package's order:

* ``debug://tiny`` and ``debug://7b``: random weights made on the device
  from a seed (no checkpoint is downloaded); ``debug://tiny-moe`` is the
  tiny M3-MoE config with its dense router;
* the port's own checkpoint (``llava_config.json``, ``utils/checkpoint.py``;
  the counterpart of the JAX package's orbax branch), loaded as saved;
* a HF / LLaVA directory: ``config.json`` with ``*.safetensors`` (read by
  ``utils/safetensors_io.py``, any dtype, bf16 included) or
  ``pytorch_model*.bin``; a LoRA checkpoint (``adapter_config.json``,
  ``adapter_model.bin``, optional ``non_lora_trainables.bin``) over
  ``model_base``; a projector-only checkpoint (``mm_projector.bin``) over
  ``model_base``.  Tensors stream one at a time onto the device, where
  they are cast to bf16 (LoRA pairs merged first, in float32); a
  checkpoint without a CLIP tower gets a random one made on the device
  from ``seed``, with a warning (the reference downloads it).

``load_4bit`` / ``load_8bit`` then quantize ``params["llama"]`` on the
device leaf by leaf (``ops/quant.py`` ``quantize_llama_params``, the JAX
``maybe_quantize``; ``quant_fuse=False`` keeps the unfused q/k/v and
gate/up leaves), and ``kv_cache_dtype="int8"`` gives the int8 KV cache.
``tp_size > 1`` attaches a ``parallel/tp_decode.py`` ``TPEngine`` over
that many ranks (``tp_devices`` / ``tp_backend`` as its ``devices`` /
``backend``), through which ``LlavaModel.generate`` runs; quantized
weights then stay unfused (``quant_fuse=False``: each rank fuses its own
shard), as in the JAX package.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from typing import Iterator, Optional, Tuple

import torch

from matryoshka_mm_torch.image_processing import ClipImageProcessor

from ..config import (ClipVisionConfig, LlamaConfig, LlavaConfig, M3Preset,
                      router_features)
from ..ops.quant import is_quantized, quantize_llama_params
from .convert import (convert_llava_state, init_params, lora_pairs,
                      merge_lora, random_vision_tower)

log = logging.getLogger(__name__)


def is_mm_model(model_path: str) -> bool:
    """A multimodal model, by the reference's name convention."""
    name = model_path.lower()
    return "llava" in name or model_path.startswith("debug://")


class LlavaModel:
    """Facade over ``(params, cfg)`` with the reference model surface
    (``generate``, ``config``) that the eval code calls."""

    def __init__(self, params: dict, cfg: LlavaConfig):
        self.params = params
        self.cfg = cfg
        self.config = _ConfigView(cfg)
        self.tp_engine = None

    def generate(self, input_ids, images=None, image_sizes=None,
                 attention_mask=None, matryoshka_vis_token_scale=None,
                 max_new_tokens=128, temperature=0.0, top_p=1.0,
                 do_sample=False, eos_token_id=2, pad_token_id=0,
                 stopping_criteria=None, use_cache=True, num_beams=1,
                 speculative=False, generator=None, decode_chunk=32,
                 cuda_graph=True, **kw):
        from ..generate import (GenerationConfig, beam_generate, generate,
                                speculative_generate)

        scale = matryoshka_vis_token_scale or \
            self.config.matryoshka_vis_token_scale
        gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, do_sample=do_sample, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, decode_chunk=decode_chunk)
        if self.tp_engine is not None and num_beams == 1 and not speculative:
            # tensor parallel, the kernels kept on every rank's shard; the
            # engine raises on the modes it does not cover (v2 combine,
            # anyres, multi-image)
            return self.tp_engine.generate(
                input_ids, images, image_sizes=image_sizes,
                attention_mask=attention_mask,
                matryoshka_vis_token_scale=scale, gen_cfg=gen_cfg,
                stopping_criteria=stopping_criteria, generator=generator)
        if num_beams != 1:
            # the reference's HF generate(num_beams=N) behind --num-beams:
            # deterministic, the sampling knobs unused
            return beam_generate(
                self.params, self.cfg, input_ids, images,
                image_sizes=image_sizes, attention_mask=attention_mask,
                matryoshka_vis_token_scale=scale, num_beams=num_beams,
                gen_cfg=gen_cfg, stopping_criteria=stopping_criteria)
        if speculative:
            # prompt-lookup decoding: greedy, B=1, one image at most
            return speculative_generate(
                self.params, self.cfg, input_ids, images,
                matryoshka_vis_token_scale=scale, gen_cfg=gen_cfg)
        return generate(self.params, self.cfg, input_ids, images,
                        image_sizes=image_sizes,
                        attention_mask=attention_mask,
                        matryoshka_vis_token_scale=scale, gen_cfg=gen_cfg,
                        stopping_criteria=stopping_criteria,
                        generator=generator, cuda_graph=cuda_graph)

    def gating_probs(self, images):
        from ..generate import gating_probs

        return gating_probs(self.params, self.cfg, images)


class _ConfigView:
    """Attribute view mirroring the reference's HF config object."""

    def __init__(self, cfg: LlavaConfig):
        self.image_aspect_ratio = cfg.image_aspect_ratio
        self.image_grid_pinpoints = cfg.image_grid_pinpoints
        self.mm_patch_merge_type = cfg.mm_patch_merge_type
        self.tokenizer_model_max_length = cfg.tokenizer_model_max_length
        self.config = {
            "use_alternative": cfg.preset.use_alternative,
            "projection_type": cfg.preset.projection_type,
            "matryoshka_vis_token_scale": cfg.preset.matryoshka_vis_token_scale,
            "moe": cfg.preset.moe,
            "projector_loc": cfg.preset.projector_loc,
            "lm_loss_type": cfg.preset.lm_loss_type,
        }
        self.matryoshka_vis_token_scale = None  # runtime knob


class DebugTokenizer:
    """Deterministic whitespace tokenizer for offline tests and benches
    (a copy of the JAX package's, whose module imports jax)."""

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0
    unk_token_id = 3
    model_max_length = 2048
    legacy = True

    def __init__(self, vocab_size: int = 32000):
        self.vocab_size = vocab_size

    def __call__(self, text, **kw):
        span = self.vocab_size - 100
        ids = [self.bos_token_id] + [
            self.eos_token_id if w == "</s>" else (hash(w) % span) + 100
            for w in text.replace("</s>", " </s> ").split()
        ]

        class Out:
            pass

        o = Out()
        o.input_ids = ids
        return o

    def decode(self, ids, skip_special_tokens=True):
        pieces = self.convert_ids_to_tokens(
            [i for i in ids
             if not (skip_special_tokens and i in (0, 1, 2, 3))])
        return "".join(pieces)

    def batch_decode(self, batch, skip_special_tokens=True):
        return [self.decode(x, skip_special_tokens) for x in batch]

    def convert_ids_to_tokens(self, ids):
        pieces = ["yes", "no", "A", "B", "C", "D", "true", "false",
                  "0", "1", "2", "3", ".", ",", " ", '"', "{", "}", ":",
                  "x"]
        return ["<pad>" if i == 0 else "<s>" if i == 1 else "</s>"
                if i == 2 else "<unk>" if i == 3
                else pieces[(i - 4) % len(pieces)] for i in ids]


def _torch_load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)


def _load_torch_state_dict(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yields the ``(key, tensor)`` pairs of a checkpoint directory, one at
    a time, as views of the mapped files: ``*.safetensors`` if there are
    any, else ``pytorch_model*.bin``, each list in sorted order."""
    from ..utils.safetensors_io import SafetensorsFile

    safes = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not (safes or bins):
        raise FileNotFoundError(f"no torch weights found under {path}")
    for f in safes:
        yield from SafetensorsFile(f).items()
    if not safes:
        for f in bins:
            yield from _torch_load(f).items()


def _cfg_from_hf_config(d: dict) -> LlavaConfig:
    """A HF / LLaVA ``config.json`` -> ``LlavaConfig``, with the JAX
    package's defaults (``arch`` stays ``llama``: it reads none)."""
    llama = LlamaConfig(
        vocab_size=d.get("vocab_size", 32000),
        hidden_size=d.get("hidden_size", 4096),
        intermediate_size=d.get("intermediate_size", 11008),
        num_hidden_layers=d.get("num_hidden_layers", 32),
        num_attention_heads=d.get("num_attention_heads", 32),
        num_key_value_heads=d.get("num_key_value_heads",
                                  d.get("num_attention_heads", 32)),
        max_position_embeddings=d.get("max_position_embeddings", 4096),
        rms_norm_eps=d.get("rms_norm_eps", 1e-5),
        rope_theta=d.get("rope_theta", 10000.0),
        dtype="bfloat16")
    # non-standard tower widths (custom or test checkpoints); liuhaotian's
    # configs name the tower only, always ViT-L/14-336
    vision = ClipVisionConfig(
        **d.get("vision_tower_config", {}),
        select_layer=d.get("mm_vision_select_layer", -2),
        select_feature=d.get("mm_vision_select_feature", "patch"),
        dtype="bfloat16")
    preset = M3Preset.from_dict(d.get("config"))
    return LlavaConfig(
        llama=llama, vision=vision, preset=preset,
        mm_projector_type=d.get("mm_projector_type", "linear"),
        mm_patch_merge_type=d.get("mm_patch_merge_type", "flat"),
        image_aspect_ratio=d.get("image_aspect_ratio", "square"),
        image_grid_pinpoints=d.get("image_grid_pinpoints"),
        tokenizer_model_max_length=d.get("tokenizer_model_max_length", 2048),
        router_feature_types=router_features(preset))


def _hf_state(model_path: str, model_base: Optional[str],
              device) -> Iterator[Tuple[str, torch.Tensor]]:
    """The state dict a HF / LLaVA directory stands for, streamed: a LoRA
    adapter merged into ``model_base``'s weights (on ``device``, float32)
    and its non-LoRA trainables laid over them, a projector laid over
    ``model_base``, or the directory's own weights."""
    lora_cfg_path = os.path.join(model_path, "adapter_config.json")
    if os.path.exists(lora_cfg_path):
        if model_base is None:
            raise ValueError("LoRA checkpoints require model_base")
        with open(lora_cfg_path) as f:
            lora_cfg = json.load(f)
        pairs = lora_pairs(_torch_load(
            os.path.join(model_path, "adapter_model.bin")))
        scaling = lora_cfg.get("lora_alpha", 16) / lora_cfg.get("r", 64)
        non_lora = os.path.join(model_path, "non_lora_trainables.bin")
        extra = {k.replace("base_model.model.", ""): v for k, v in
                 _torch_load(non_lora).items()} \
            if os.path.exists(non_lora) else {}
        base = _merged(_load_torch_state_dict(model_base), pairs, scaling,
                       device)
    elif os.path.exists(os.path.join(model_path, "mm_projector.bin")):
        if model_base is None:
            raise ValueError("projector-only checkpoints require model_base")
        extra = _torch_load(os.path.join(model_path, "mm_projector.bin"))
        base = _load_torch_state_dict(model_base)
    else:
        return _load_torch_state_dict(model_path)
    return _laid_over(base, extra)


def _merged(items, pairs: dict, scaling: float, device):
    for key, t in items:
        if key in pairs:
            a, b = pairs.pop(key)
            t = merge_lora(t.to(device), a, b, scaling)
        yield key, t
    if pairs:
        raise ValueError(f"LoRA adapters of {len(pairs)} weights the base "
                         f"does not have, e.g. {sorted(pairs)[:3]}")


def _laid_over(items, extra: dict):
    for key, t in items:
        if key not in extra:
            yield key, t
    yield from extra.items()


def load_pretrained_model(
    model_path: str,
    model_base: Optional[str] = None,
    model_name: Optional[str] = None,
    load_8bit: bool = False,
    load_4bit: bool = False,
    device_map: str = "auto",
    device: str = "cuda",
    kv_cache_dtype: str = "",
    tp_size: int = 0,
    seed: int = 0,
    quant_fuse: bool = True,
    tp_devices=None,
    tp_backend: Optional[str] = None,
    **kwargs,
) -> Tuple[object, LlavaModel, ClipImageProcessor, int]:
    """Returns ``(tokenizer, model, image_processor, context_len)`` with the
    weights on ``device``."""
    if tp_size > 1 and (load_8bit or load_4bit):
        # the engine shards the unfused quantized layout exactly and fuses
        # each rank's shard (parallel/tp_decode.py)
        quant_fuse = False

    def finish(params, cfg):
        if kv_cache_dtype:
            cfg = cfg.with_kv_cache_dtype(kv_cache_dtype)
        model = LlavaModel(params, cfg)
        if tp_size > 1:
            from ..parallel.tp_decode import TPEngine

            model.tp_engine = TPEngine(params, cfg, tp_size,
                                       devices=tp_devices,
                                       backend=tp_backend)
        return model

    if model_path.startswith("debug://"):
        which = model_path.split("//", 1)[1]
        if which.startswith("tiny"):
            cfg = LlavaConfig.tiny_debug(
                moe="t=dense_ft=cls_obj=weightedlm" if "moe" in which
                else None)
        elif which == "7b":
            cfg = LlavaConfig.llava_v15_7b_m3()
        else:
            raise ValueError(f"unknown debug model {which!r}")
        s = cfg.vision.image_size
        image_processor = ClipImageProcessor(
            size={"shortest_edge": s}, crop_size={"height": s, "width": s})
        params = init_params(cfg, device=device, seed=seed)
        _quantize(params, load_8bit, load_4bit, quant_fuse)
        return DebugTokenizer(cfg.llama.vocab_size), finish(params, cfg), \
            image_processor, cfg.tokenizer_model_max_length

    image_processor = ClipImageProcessor()
    if os.path.exists(os.path.join(model_path, "llava_config.json")):
        from ..utils.checkpoint import load_checkpoint

        params, cfg = load_checkpoint(model_path, device=device)
        if "llama" in params and not _holds_quantized(params["llama"]):
            # the JAX builder ignores load_4bit / load_8bit here (ROADMAP.md
            # Queue 3); a checkpoint saved quantized stays as it is
            _quantize(params, load_8bit, load_4bit, quant_fuse)
        return _load_tokenizer(model_path, model_base,
                               cfg.llama.vocab_size), \
            finish(params, cfg), image_processor, \
            cfg.tokenizer_model_max_length

    with open(os.path.join(model_path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = _cfg_from_hf_config(hf_cfg)
    params = convert_llava_state(_hf_state(model_path, model_base, device),
                                 cfg, device=device)
    if "vision_tower" not in params:
        log.warning("%s holds no CLIP tower: using a random one made from "
                    "seed %d", model_path, seed)
        params["vision_tower"] = random_vision_tower(cfg, device=device,
                                                     seed=seed)
    _quantize(params, load_8bit, load_4bit, quant_fuse)
    context_len = hf_cfg.get("max_sequence_length",
                             cfg.tokenizer_model_max_length)
    return _load_tokenizer(model_path, model_base, cfg.llama.vocab_size), \
        finish(params, cfg), image_processor, context_len


def _holds_quantized(tree) -> bool:
    if is_quantized(tree):
        return True
    if isinstance(tree, dict):
        return any(_holds_quantized(v) for v in tree.values())
    if isinstance(tree, list):
        return any(_holds_quantized(v) for v in tree)
    return False


def _quantize(params: dict, load_8bit: bool, load_4bit: bool,
              fuse: bool) -> None:
    if load_4bit or load_8bit:   # load_4bit wins, as in the JAX package
        quantize_llama_params(params, bits=4 if load_4bit else 8, fuse=fuse)


def _load_tokenizer(model_path: str, model_base: Optional[str],
                    vocab_size: int = 32000):
    """``AutoTokenizer`` from the first of ``model_path`` and
    ``model_base`` that holds ``tokenizer.json`` or ``tokenizer.model``,
    when ``transformers`` imports and can read it; else ``DebugTokenizer``
    (as the JAX package)."""
    for p in (model_path, model_base):
        if p and (os.path.exists(os.path.join(p, "tokenizer.json"))
                  or os.path.exists(os.path.join(p, "tokenizer.model"))):
            try:
                from transformers import AutoTokenizer

                return AutoTokenizer.from_pretrained(p, use_fast=True)
            except (ImportError, OSError, ValueError) as e:
                log.warning("tokenizer of %s not loaded (%s): using "
                            "DebugTokenizer", p, e)
    return DebugTokenizer(vocab_size)
