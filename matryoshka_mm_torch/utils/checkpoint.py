"""Checkpointing in the JAX package's layout (port of
``matryoshka_mm_tpu/utils/checkpoint.py``, which saves with orbax): each
package reads what the other writes.

Layout of a checkpoint directory:
  llava_config.json   model / arch config (JSON, the JAX ``_cfg_to_json``)
  params/             orbax ``StandardCheckpointer`` tree of the JAX
                      package's parameters (layers stacked, dense kernels
                      ``(in, out)``), written and read by ``orbax_io.py``
  opt_state/          (when given) the optimizer state, the same format
  meta.json           step, EMA buffers

:func:`load_checkpoint` also reads an older directory of the port, which
held ``params.pt`` (``torch.save``) in place of ``params/``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from .orbax_io import read_tree, write_tree


def _cfg_to_json(cfg) -> dict:
    def enc(x):
        if dataclasses.is_dataclass(x):
            return {"__dc__": type(x).__name__,
                    **{f.name: enc(getattr(x, f.name))
                       for f in dataclasses.fields(x)}}
        if isinstance(x, tuple):
            return list(x)
        return x

    return enc(cfg)


def _cfg_from_json(d: dict):
    from ..config import ClipVisionConfig, LlamaConfig, LlavaConfig, M3Preset

    classes = {"LlavaConfig": LlavaConfig, "LlamaConfig": LlamaConfig,
               "ClipVisionConfig": ClipVisionConfig, "M3Preset": M3Preset}

    def dec(x):
        if isinstance(x, dict) and "__dc__" in x:
            cls = classes[x["__dc__"]]
            kwargs = {k: dec(v) for k, v in x.items() if k != "__dc__"}
            fields = {f.name for f in dataclasses.fields(cls)}
            kwargs = {k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in kwargs.items() if k in fields}
            return cls(**kwargs)
        return x

    return dec(d)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(path: str, params, cfg, step: int = 0,
                    opt_state=None, extra: Optional[dict] = None) -> None:
    """Write ``params`` (the port's tree, or a subset of it) as the JAX
    package's ``save_checkpoint`` writes its own: the tree as JAX holds
    it (``models/convert.py`` ``params_to_jax``), one leaf at a time."""
    from ..models.convert import params_to_jax

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "llava_config.json"), "w") as f:
        json.dump(_cfg_to_json(cfg), f, indent=2)
    write_tree(os.path.join(path, "params"),
               params_to_jax(params, cfg, lazy=True))
    if opt_state is not None:
        write_tree(os.path.join(path, "opt_state"), _detached(opt_state))
    for old in ("params.pt", "opt_state.pt"):
        if os.path.exists(os.path.join(path, old)):
            os.remove(os.path.join(path, old))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": int(step), **(extra or {})}, f)


def load_checkpoint(path: str, device="cuda") -> Tuple[dict, object]:
    """Returns ``(params, cfg)`` with the tensors on ``device``, from a
    directory either package wrote (each leaf read, converted to the
    port's layout and moved to ``device`` before the next is read), or
    from an older port directory's ``params.pt``."""
    from ..models.convert import params_from_jax

    path = os.path.abspath(path)
    with open(os.path.join(path, "llava_config.json")) as f:
        cfg = _cfg_from_json(json.load(f))
    if os.path.isdir(os.path.join(path, "params")):
        tree = read_tree(os.path.join(path, "params"), lazy=True)
        return params_from_jax(tree, cfg, device=device), cfg
    params = torch.load(os.path.join(path, "params.pt"),
                        map_location=device, weights_only=True)
    return params, cfg


def load_meta(path: str) -> dict:
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def save_projector_only(path: str, params, cfg, step: int = 0) -> None:
    """Adapter-only checkpoint: the projector (+ image_newline) leaves."""
    subset = {"mm_projector": params["mm_projector"]}
    if "image_newline" in params:
        subset["image_newline"] = params["image_newline"]
    save_checkpoint(path, subset, cfg, step=step,
                    extra={"projector_only": True})


def save_lora_checkpoint(path: str, params, cfg, step: int = 0) -> None:
    """LoRA save split: the adapter tree plus the non-LoRA trainables
    (projector / router) in one checkpoint.  Load with
    :func:`load_checkpoint` and re-attach through ``ops.lora.load_lora``."""
    from ..ops.lora import extract_lora

    subset = {"lora": extract_lora(params)}
    for key in ("mm_projector", "router", "image_newline"):
        if key in params:
            subset[key] = params[key]
    save_checkpoint(path, subset, cfg, step=step, extra={"lora_only": True})


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """Auto-resume discovery: the ``checkpoint-*`` directory with the
    highest step."""
    if not os.path.isdir(output_dir):
        return None
    cands = [d for d in os.listdir(output_dir) if d.startswith("checkpoint-")]
    if not cands:
        return None
    cands.sort(key=lambda d: int(d.split("-")[-1]))
    return os.path.join(output_dir, cands[-1])
