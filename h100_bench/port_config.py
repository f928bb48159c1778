"""A configuration file as the program's ``LlavaConfig``.

Built from the file's own numbers, never from the program's presets (the
``mistral_7b`` preset carries v0.1's 4,096-slot window and an eps of 1e-6
that v0.2 does not have).  Settings the program cannot honour raise.
"""

from __future__ import annotations

from matryoshka_mm_torch.config import (ClipVisionConfig, LlamaConfig,
                                        LlavaConfig, M3Preset)

from .reference.spec import ModelSpec


def llava_config(spec: ModelSpec, cfg: dict) -> LlavaConfig:
    d, v = spec.decoder, spec.vision
    if d.family == "mpt":
        if d.alibi_bias_max != 8.0 or d.norm_eps != 1e-5:
            raise ValueError("the program's MPT block fixes alibi_bias_max "
                             "at 8 and the LayerNorm eps at 1e-5")
        max_pos = cfg["decoder"]["max_seq_len"]
    else:
        max_pos = cfg["decoder"]["max_position_embeddings"]
    llama = LlamaConfig(
        arch=d.family, vocab_size=d.vocab, hidden_size=d.hidden,
        intermediate_size=d.intermediate, num_hidden_layers=d.layers,
        num_attention_heads=d.heads, num_key_value_heads=d.kv_heads,
        max_position_embeddings=max_pos, rms_norm_eps=d.norm_eps,
        rope_theta=d.rope_theta or 10000.0, dtype=spec.dtype,
        sliding_window=d.window, tie_word_embeddings=d.tied)
    vision = ClipVisionConfig(
        hidden_size=v.hidden, intermediate_size=v.intermediate,
        num_hidden_layers=v.layers, num_attention_heads=v.heads,
        image_size=v.image, patch_size=v.patch, layer_norm_eps=v.norm_eps,
        select_layer=v.select_layer, select_feature="patch",
        dtype=spec.dtype)
    scales = "[" + ",".join(str(s) for s in spec.scales) + "]"
    return LlavaConfig(
        llama=llama, vision=vision,
        preset=M3Preset(matryoshka_vis_token_scale=f"ver=v0_numtoks={scales}"),
        mm_projector_type=spec.projector,
        image_aspect_ratio=cfg["image_aspect_ratio"],
        tokenizer_model_max_length=max_pos)
