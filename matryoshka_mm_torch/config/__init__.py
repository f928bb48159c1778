"""Model configurations of the PyTorch port.

Field names and presets mirror the JAX package's ``LlamaConfig``
(``matryoshka_mm_tpu/models/llama.py``), ``ClipVisionConfig``
(``models/clip.py``) and ``M3Preset`` / ``LlavaConfig`` (``models/llava.py``),
so a configuration reads the same on both sides.  ``LlamaConfig.tp_axis``
names a tensor-parallel group registered by ``parallel/collectives.py`` (a
name, not the group, so the config stays picklable and hashable): a
decoder run under it all-reduces its o_proj and MLP outputs
(``parallel/tp_decode.py`` sets it, with ``head_dim_override``, in
``local_llama_cfg``, and gathers the vocabulary-sharded logits itself).

``LlamaConfig.attn_impl`` keeps its JAX meaning:

* ``"auto"``: attention runs through the hand-written kernels when its
  tensors lie on a CUDA device, and through their plain PyTorch versions
  when they lie on the CPU;
* ``"reference"``: the plain masked-softmax attention, chosen explicitly
  (parity tests and the kernel-off comparison of ``chip_smoke.py``).

``ModelConfig`` is the named model-behaviour preset registry of the JAX
package's ``config/__init__.py``: every dict of ``model_config.py`` under
``pretune_`` and ``finetune_`` names.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

import torch

from ..kvconfig import parse_kv_from_string, parse_list
from .model_config import MODEL_CONFIG_DICTS

ModelConfig = {}
for _name, _cfg in MODEL_CONFIG_DICTS.items():
    for _finetune_type in ("pretune", "finetune"):
        _d = copy.deepcopy(_cfg)
        _d["use_alternative"] = _d.get("use_alternative", True)
        ModelConfig[f"{_finetune_type}_{_name}"] = _d

ATTN_IMPLS = ("auto", "reference")
# the decoder families of the reference's wrappers (llava_llama.py,
# llava_mistral.py, llava_mpt.py)
ARCHS = ("llama", "mistral", "mpt")


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` / ``"float16"`` -> ``torch.dtype``."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    # training-mode forward (no cache): recompute each decoder layer in the
    # backward instead of keeping its activations
    remat: bool = False
    # what a recomputed layer keeps.  "" = nothing but the layer's input
    # (least memory); "dots" = the outputs of the products with no batch
    # dims (the JAX dots_with_no_batch_dims_saveable: every projection);
    # "names:<tag,...>" = the named tensors: attn_q / attn_k / attn_v
    # (after rope), attn_o (the o projection's output), flash_out /
    # flash_lse (the flash forward's out and lse, so the recompute does not
    # launch that kernel again); "names:attn" = all six
    remat_policy: str = ""
    attn_impl: str = "auto"
    arch: str = "llama"
    sliding_window: int = 0          # 0 = disabled
    tie_word_embeddings: bool = False
    # "" follows `dtype`; "int8" stores KV slots int8 with a per-(slot,
    # kv head) absmax scale (load_pretrained_model(kv_cache_dtype="int8"))
    kv_cache_dtype: str = ""
    # tensor parallelism: the name of a registered group of ranks, each
    # holding 1/tp of the heads, the MLP width and the vocabulary (the JAX
    # shard_map axis); "" = one device
    tp_axis: str = ""
    head_dim_override: int = 0

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={self.attn_impl!r}; expected one of "
                             f"{ATTN_IMPLS}")
        if self.arch not in ARCHS:
            raise ValueError(f"arch={self.arch!r}; expected one of {ARCHS}")
        if self.kv_cache_dtype not in ("", self.dtype, "int8"):
            raise ValueError(f"kv_cache_dtype={self.kv_cache_dtype!r}; "
                             f"expected '', {self.dtype!r} or 'int8'")

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or \
            self.hidden_size // self.num_attention_heads

    @classmethod
    def vicuna_7b(cls, **kw):
        return cls(**kw)

    @classmethod
    def mistral_7b(cls, **kw):
        """The JAX preset as it stands: v0.1's 4,096-slot window with
        v0.2's ``rope_theta`` of 1e6."""
        return cls(arch="mistral", intermediate_size=14336,
                   num_key_value_heads=8, sliding_window=4096,
                   rms_norm_eps=1e-6, rope_theta=1e6,
                   max_position_embeddings=32768, **kw)

    @classmethod
    def mpt_7b(cls, **kw):
        return cls(arch="mpt", vocab_size=50432, intermediate_size=16384,
                   max_position_embeddings=2048, tie_word_embeddings=True,
                   **kw)

    @classmethod
    def tiny_debug(cls, **kw):
        """4-layer toy config for tests."""
        defaults = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=4, num_attention_heads=4,
                        num_key_value_heads=4, max_position_embeddings=512,
                        dtype="float32")
        defaults.update(kw)
        return cls(**defaults)


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    select_layer: int = -2         # reference default mm_vision_select_layer
    select_feature: str = "patch"  # 'patch' | 'cls_patch'
    dtype: str = "float32"

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def vit_l_14_336(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny_debug(cls, **kw):
        defaults = dict(hidden_size=32, intermediate_size=64,
                        num_hidden_layers=4, num_attention_heads=4,
                        image_size=56, patch_size=14)
        defaults.update(kw)
        return cls(**defaults)


@dataclasses.dataclass(frozen=True)
class M3Preset:
    """The M3 behaviour knobs (the reference's ``model.config.config``)."""

    use_alternative: bool = True
    projection_type: str = "v4"
    matryoshka_vis_token_scale: Optional[str] = None
    moe: Optional[str] = None
    projector_loc: str = "after_vision_tower"
    lm_loss_type: str = "micro"

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "M3Preset":
        if d is None:
            return cls(use_alternative=False)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def router_features(preset: M3Preset) -> Tuple[str, ...]:
    """The router's feature taps: the ``ft=`` key of the ``moe`` string
    (the reference reads them there, not from a config field)."""
    if not preset.moe:
        return ()
    ft = parse_kv_from_string(preset.moe).get("ft")
    return tuple(str(ft).split(",")) if ft else ()


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    llama: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: ClipVisionConfig = dataclasses.field(
        default_factory=ClipVisionConfig)
    preset: M3Preset = dataclasses.field(default_factory=M3Preset)
    mm_projector_type: str = "mlp2x_gelu"
    mm_patch_merge_type: str = "flat"
    image_aspect_ratio: str = "pad"
    image_grid_pinpoints: Optional[str] = None
    tokenizer_model_max_length: int = 2048
    tokenizer_padding_side: str = "right"
    router_feature_types: Tuple[str, ...] = ()
    text_embed_dim: int = 384  # bge-small-en-v1.5

    @property
    def is_m3(self) -> bool:
        return (self.preset.use_alternative
                and self.preset.projection_type == "v4"
                and self.preset.matryoshka_vis_token_scale is not None)

    @property
    def is_m3_moe(self) -> bool:
        return self.is_m3 and self.preset.moe is not None

    @property
    def tokscale_list(self) -> List[int]:
        if not self.is_m3:
            return []
        kvs = parse_kv_from_string(self.preset.matryoshka_vis_token_scale)
        return [int(x) for x in parse_list(kvs["numtoks"])]

    @property
    def mm_hidden_size(self) -> int:
        return self.vision.hidden_size

    def with_attn_impl(self, impl: str) -> "LlavaConfig":
        """The same configuration with ``llama.attn_impl`` replaced."""
        return dataclasses.replace(
            self, llama=dataclasses.replace(self.llama, attn_impl=impl))

    def with_kv_cache_dtype(self, kv_cache_dtype: str) -> "LlavaConfig":
        """The same configuration with ``llama.kv_cache_dtype`` replaced."""
        return dataclasses.replace(
            self, llama=dataclasses.replace(self.llama,
                                            kv_cache_dtype=kv_cache_dtype))

    @classmethod
    def tiny_debug(cls, moe: Optional[str] = None,
                   scales: Tuple[int, ...] = (1, 4, 16)) -> "LlavaConfig":
        """Small random-init config: 16-patch grid, 4-layer LLM."""
        scale_str = "[" + ",".join(str(s) for s in scales) + "]"
        return cls(
            llama=LlamaConfig.tiny_debug(),
            vision=ClipVisionConfig.tiny_debug(),
            preset=M3Preset(
                matryoshka_vis_token_scale=f"ver=v0_numtoks={scale_str}",
                moe=moe),
            mm_projector_type="mlp2x_gelu",
            tokenizer_model_max_length=128,
            router_feature_types=("cls",) if moe else (),
        )

    @classmethod
    def llava_v15_7b_m3(cls, moe: Optional[str] = None,
                        **kw) -> "LlavaConfig":
        scales = "[1,9,36,144,576]"
        return cls(
            llama=LlamaConfig.vicuna_7b(),
            vision=ClipVisionConfig.vit_l_14_336(dtype="bfloat16"),
            preset=M3Preset(
                matryoshka_vis_token_scale=f"ver=v0_numtoks={scales}",
                moe=moe),
            tokenizer_model_max_length=2048,
            router_feature_types=("cls",) if moe else (),
            **kw,
        )
