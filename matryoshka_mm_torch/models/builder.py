"""``load_pretrained_model`` for the PyTorch port (port of
``matryoshka_mm_tpu/models/builder.py``), returning
``(tokenizer, model, image_processor, context_len)``.

Sources: ``debug://tiny`` and ``debug://7b`` (random weights made on the
device from a seed; no checkpoint is downloaded).  ``load_4bit`` /
``load_8bit`` quantize ``params["llama"]`` on the device leaf by leaf
(``ops/quant.py`` ``quantize_llama_params``, the JAX ``maybe_quantize``;
``quant_fuse=False`` keeps the unfused q/k/v and gate/up leaves), and
``kv_cache_dtype="int8"`` gives the int8 KV cache.  HF and orbax
checkpoints and ``tp_size > 1`` raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""

from __future__ import annotations

from typing import Optional, Tuple

from matryoshka_mm_torch.image_processing import ClipImageProcessor

from ..config import LlavaConfig
from ..ops.quant import quantize_llama_params
from .convert import init_params


class LlavaModel:
    """Facade over ``(params, cfg)`` with the reference model surface
    (``generate``, ``config``) that the eval code calls."""

    def __init__(self, params: dict, cfg: LlavaConfig):
        self.params = params
        self.cfg = cfg
        self.config = _ConfigView(cfg)

    def generate(self, input_ids, images=None, image_sizes=None,
                 attention_mask=None, matryoshka_vis_token_scale=None,
                 max_new_tokens=128, temperature=0.0, top_p=1.0,
                 do_sample=False, eos_token_id=2, pad_token_id=0,
                 stopping_criteria=None, use_cache=True, num_beams=1,
                 speculative=False, generator=None, decode_chunk=32, **kw):
        from ..generate import GenerationConfig, generate

        if num_beams != 1:
            raise NotImplementedError(
                "beam search is not ported yet (ROADMAP.md Queue 1, item 8)")
        if speculative:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP.md Queue 1, "
                "item 8)")
        scale = matryoshka_vis_token_scale or \
            self.config.matryoshka_vis_token_scale
        gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, do_sample=do_sample, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, decode_chunk=decode_chunk)
        return generate(self.params, self.cfg, input_ids, images,
                        image_sizes=image_sizes,
                        attention_mask=attention_mask,
                        matryoshka_vis_token_scale=scale, gen_cfg=gen_cfg,
                        stopping_criteria=stopping_criteria,
                        generator=generator)


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
    **kwargs,
) -> Tuple[object, LlavaModel, ClipImageProcessor, int]:
    """Returns ``(tokenizer, model, image_processor, context_len)`` with the
    weights on ``device``."""
    if tp_size > 1:
        raise NotImplementedError(
            "tensor parallelism is not ported yet (ROADMAP.md Queue 1, "
            "item 11)")
    if not model_path.startswith("debug://"):
        raise NotImplementedError(
            f"{model_path!r}: HF and orbax checkpoint loading is not ported "
            f"yet (ROADMAP.md Queue 1, item 5)")
    which = model_path.split("//", 1)[1]
    if which == "tiny":
        cfg = LlavaConfig.tiny_debug()
    elif which == "7b":
        cfg = LlavaConfig.llava_v15_7b_m3()
    else:
        raise NotImplementedError(
            f"debug model {which!r}: the port has debug://tiny and "
            f"debug://7b (router configs: ROADMAP.md Queue 1, item 4)")
    if kv_cache_dtype:
        cfg = cfg.with_kv_cache_dtype(kv_cache_dtype)
    s = cfg.vision.image_size
    image_processor = ClipImageProcessor(
        size={"shortest_edge": s}, crop_size={"height": s, "width": s})
    params = init_params(cfg, device=device, seed=seed)
    if load_4bit or load_8bit:   # load_4bit wins, as in the JAX package
        quantize_llama_params(params, bits=4 if load_4bit else 8,
                              fuse=quant_fuse)
    return DebugTokenizer(cfg.llama.vocab_size), LlavaModel(params, cfg), \
        image_processor, cfg.tokenizer_model_max_length
