"""A configuration file's sizes as the reference reads them.

The decoder block of a configuration keeps the key names of its source's
``config.json``; this module maps each family's names onto one plain
record.  Keys the reference cannot honour raise, so a configuration never
runs under a reference that ignores part of it.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..work import DecoderShape, VisionShape


@dataclasses.dataclass(frozen=True)
class DecoderSpec:
    family: str               # "llama" | "mistral" | "mpt"
    layers: int
    hidden: int
    intermediate: int
    heads: int
    kv_heads: int
    vocab: int
    norm_eps: float
    rope_theta: float         # unused by MPT
    window: int               # 0 = no sliding window
    tied: bool
    alibi_bias_max: float     # MPT only

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    def shape(self) -> DecoderShape:
        return DecoderShape(self.layers, self.hidden, self.intermediate,
                            self.heads, self.kv_heads, self.vocab,
                            glu=self.family != "mpt")


@dataclasses.dataclass(frozen=True)
class VisionSpec:
    layers: int
    hidden: int
    intermediate: int
    heads: int
    image: int
    patch: int
    norm_eps: float
    select_layer: int

    @property
    def layers_run(self) -> int:
        return self.select_layer + 1 + self.layers if self.select_layer < 0 \
            else self.select_layer


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    decoder: DecoderSpec
    vision: VisionSpec
    projector: str
    scales: List[int]
    dtype: str

    def vision_shape(self) -> VisionShape:
        v = self.vision
        depth = int(self.projector[len("mlp"):].split("x")[0]) \
            if self.projector.startswith("mlp") else 1
        return VisionShape(v.layers_run, v.hidden, v.intermediate, v.image,
                           v.patch, self.decoder.hidden, depth)


def _decoder(family: str, d: dict) -> DecoderSpec:
    if family in ("llama", "mistral"):
        if d.get("hidden_act", "silu") != "silu":
            raise ValueError(f"hidden_act {d['hidden_act']!r}")
        return DecoderSpec(
            family, d["num_hidden_layers"], d["hidden_size"],
            d["intermediate_size"], d["num_attention_heads"],
            d.get("num_key_value_heads", d["num_attention_heads"]),
            d["vocab_size"], float(d["rms_norm_eps"]),
            float(d.get("rope_theta", 10000.0)),
            int(d.get("sliding_window") or 0),
            bool(d.get("tie_word_embeddings", False)), 0.0)
    if family == "mpt":
        a = d["attn_config"]
        if not a.get("alibi") or a.get("qk_ln") or a.get("clip_qkv") \
                or a.get("softmax_scale") or not d.get("no_bias") \
                or d.get("logit_scale"):
            raise ValueError("the MPT reference runs alibi attention with "
                             "no bias, no qk norm, no clipping and the "
                             "default softmax and logit scales")
        return DecoderSpec(
            family, d["n_layers"], d["d_model"],
            d["expansion_ratio"] * d["d_model"], d["n_heads"], d["n_heads"],
            d["vocab_size"], float(d.get("layer_norm_epsilon", 1e-5)), 0.0,
            0, True, float(a["alibi_bias_max"]))
    raise ValueError(f"unknown decoder family {family!r}")


def model_spec(cfg: dict) -> ModelSpec:
    """The reference's record of a configuration file (its parsed JSON)."""
    v = cfg["vision"]
    if v.get("hidden_act", "quick_gelu") != "quick_gelu" \
            or v.get("mm_vision_select_feature", "patch") != "patch":
        raise ValueError("the CLIP reference runs quick_gelu and the patch "
                         "features")
    vision = VisionSpec(v["num_hidden_layers"], v["hidden_size"],
                        v["intermediate_size"], v["num_attention_heads"],
                        v["image_size"], v["patch_size"],
                        float(v["layer_norm_eps"]),
                        int(v["mm_vision_select_layer"]))
    return ModelSpec(_decoder(cfg["family"], cfg["decoder"]), vision,
                     cfg["mm_projector_type"], list(cfg["m3"]["scales"]),
                     cfg["dtype"])
