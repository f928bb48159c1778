"""Model-behavior preset dicts (a copy of the JAX package's
``config/model_config.py``; reference: llava/config/model_config.py:5-20).

``v0``: vanilla LLaVA training.  ``v4``: matryoshka (M3) training; the
``matryoshka_vis_token_scale`` / ``moe`` entries are kv-strings filled in by
the training CLI.
"""

# vanilla training
model_config_v0 = {
    "use_alternative": False,
    "projection_type": "v0",
    "projector_loc": "after_vision_tower",
}

# matryoshka training
model_config_v4 = {
    "use_alternative": True,
    "projection_type": "v4",
    "matryoshka_vis_token_scale": None,
    "moe": None,
    "projector_loc": "after_vision_tower",
    "lm_loss_type": "micro",
}

MODEL_CONFIG_DICTS = {
    "v0": model_config_v0,
    "v4": model_config_v4,
}
