"""Checkpoint config upgrade (reference: llava/model/utils.py:1-20
``auto_upgrade``; the port's own copy of
``matryoshka_mm_tpu/models/utils.py``): old checkpoints carry ``model_type: llava``; newer code
expects ``llava_llama``.  Upgrades config.json in place (with confirmation
unless ``assume_yes``)."""

from __future__ import annotations

import json
import os


def auto_upgrade(config_path: str, assume_yes: bool = False) -> bool:
    """Returns True if the config was (already) current or upgraded."""
    cfg_file = os.path.join(config_path, "config.json") \
        if os.path.isdir(config_path) else config_path
    with open(cfg_file) as f:
        cfg = json.load(f)
    if cfg.get("model_type") != "llava":
        return True
    if "llava" not in cfg.get("_name_or_path", "") and \
            "llava" not in cfg_file.lower():
        raise ValueError(
            "You are using a newer code base with an older (deprecated) "
            "checkpoint layout; please re-export the checkpoint.")
    if not assume_yes:
        confirm = input("Upgrade deprecated config.json to llava_llama? [Y/N] ")
        if confirm.lower() not in ("y", "yes"):
            print("aborted")
            return False
    cfg["model_type"] = "llava_llama"
    with open(cfg_file, "w") as f:
        json.dump(cfg, f, indent=2)
    print(f"upgraded {cfg_file}")
    return True
