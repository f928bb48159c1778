"""Training orchestrator: ``train()`` (port of
``matryoshka_mm_tpu/train/train.py``).

    python -m matryoshka_mm_torch.train.train --model_name_or_path \\
        debug://tiny --data_path data.json --image_folder images \\
        --output_dir out [--lora_enable True] [--device cpu]

Argument dataclasses (Model / Data / Training) parsed from ``--flag value``
pairs (booleans as ``True`` / ``False``), the named behaviour preset merged
with the overrides, an ``args.json`` snapshot, model construction with the
freeze / LoRA / quantized-base wiring, the data module, auto-resume from
``checkpoint-*``, gradient accumulation, the length-grouped samplers and
the three save shapes (full / projector-only / LoRA).  A router with the
``textcls`` feature gets each batch's prompt embedding from a frozen BERT
(``models/text_embedder.py``, random from seed 0: the tiny one for
``debug://`` paths, ``bge_small`` widths otherwise), run on the device
under ``torch.no_grad``.

``--model_name_or_path`` is ``debug://tiny`` (random weights) or any
directory ``load_pretrained_model`` reads (a HF / LLaVA checkpoint, or
one of the port's own); the weights and widths come from it, the preset,
remat and dtypes from the arguments.

Runs on the card unless ``--device cpu`` is given.  Across ranks:

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m matryoshka_mm_torch.train.train ... --tp_size 2 [--dp_size 2]

lays the ranks out as a ``(data, model)`` mesh of ``(world // tp_size,
tp_size)`` (``--dp_size``, if given, must equal ``world // tp_size``),
places the parameters by ``parallel/sharding.py``'s rules (a ``--bits``
4 / 8 base too: its packed values and scales are placed like the weights
they stand for) and gives each
data rank its ``per_device_train_batch_size`` rows of every global batch
(``put_batch``).  Rank 0 alone writes ``args.json``, ``metrics.jsonl`` and
the checkpoints, each leaf gathered whole first, so a sharded run's save
is a one-process save.  Gloo is the backend on the CPU and wherever
several ranks share a card; NCCL (one card a rank) is written but not yet
run.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import shutil
import time
import typing
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import conversation as conversation_lib
from ..config import (ClipVisionConfig, LlamaConfig, LlavaConfig, M3Preset,
                      router_features, torch_dtype)
from ..kvconfig import parse_kv_from_string
from ..utils.checkpoint import (latest_checkpoint, load_checkpoint, load_meta,
                                save_checkpoint, save_lora_checkpoint,
                                save_projector_only)
from .data import DataArguments as _DataArgs
from .data import make_supervised_data_module
from .optimizer import MultiSteps, OptimizerConfig
from .sampler import LengthGroupedSampler
from .train_step import M3Batch
from .trainer import (TrainState, create_train_state, host_metrics,
                      make_train_step)

# vanilla (v0) and matryoshka (v4) training presets, under the names
# `pretune_<v>` and `finetune_<v>`
_PRESETS = {
    "v0": {"use_alternative": False, "projection_type": "v0",
           "projector_loc": "after_vision_tower"},
    "v4": {"use_alternative": True, "projection_type": "v4",
           "matryoshka_vis_token_scale": None, "moe": None,
           "projector_loc": "after_vision_tower", "lm_loss_type": "micro"},
}
ModelConfig = {f"{kind}_{name}": copy.deepcopy(d)
               for name, d in _PRESETS.items()
               for kind in ("pretune", "finetune")}


@dataclass
class ModelArguments:
    model_name_or_path: Optional[str] = field(default="debug://tiny")
    version: Optional[str] = field(default="v1")
    freeze_backbone: bool = field(default=False)
    tune_mm_mlp_adapter: bool = field(default=False)
    vision_tower: Optional[str] = field(
        default="openai/clip-vit-large-patch14-336")
    mm_vision_select_layer: Optional[int] = field(default=-2)
    pretrain_mm_mlp_adapter: Optional[str] = field(default=None)
    mm_projector_type: Optional[str] = field(default="mlp2x_gelu")
    mm_use_im_start_end: bool = field(default=False)
    mm_use_im_patch_token: bool = field(default=False)
    mm_patch_merge_type: Optional[str] = field(default="flat")
    mm_vision_select_feature: Optional[str] = field(default="patch")
    unfreeze_mm_vision_tower: bool = field(default=False)
    tune_router: bool = field(default=False)
    model_use: Optional[str] = field(default=None)
    projector_loc: Optional[str] = field(default=None)
    use_alternative: Optional[bool] = field(default=None)
    matryoshka_vis_token_scale: Optional[str] = field(default=None)
    moe: Optional[str] = field(default=None)
    lm_loss_type: Optional[str] = field(default=None)


@dataclass
class DataArguments(_DataArgs):
    pass


@dataclass
class TrainingArguments:
    """The subset of the HF TrainingArguments that the reference drives."""

    output_dir: str = "./output"
    num_train_epochs: float = 1.0
    max_steps: int = -1
    per_device_train_batch_size: int = 4
    gradient_accumulation_steps: int = 1
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_scheduler_type: str = "cosine"
    logging_steps: int = 1
    save_steps: int = 500
    save_total_limit: int = 2
    model_max_length: int = 2048
    bf16: bool = True
    seed: int = 42
    freeze_mm_mlp_adapter: bool = False
    mm_projector_lr: Optional[float] = None
    mm_vision_tower_lr: Optional[float] = None
    router_lr: Optional[float] = None
    group_by_length: bool = False
    group_by_modality_length: bool = False
    group_by_modality_length_auto: bool = False
    group_by_varlen: bool = False
    dp_size: Optional[int] = None
    tp_size: int = 1
    report_to: str = "jsonl"
    # LoRA / quantized base (the reference's scripts use r=128 alpha=256)
    bits: int = 16                  # 8 / 4 quantize the LM base (QLoRA)
    lora_enable: bool = False
    lora_r: int = 64
    lora_alpha: int = 16
    lora_dropout: float = 0.05      # accepted for CLI parity, not applied
    lora_bias: str = "none"
    device: str = "cuda"            # "cpu" runs the plain versions


def _scalar_type(tp):
    """The value type of a field annotation (``Optional[int]`` -> int)."""
    args = [a for a in typing.get_args(tp) if a is not type(None)]
    return args[0] if args else tp


def _parse_bool(text: str) -> bool:
    if text.lower() in ("true", "1", "yes"):
        return True
    if text.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected True or False, got {text!r}")


def parse_args_into_dataclasses(classes, argv=None) -> tuple:
    """``--flag value`` pairs -> one instance of each dataclass (a flag
    belongs to the class that has a field of its name)."""
    parser = argparse.ArgumentParser()
    hints = {cls: typing.get_type_hints(cls) for cls in classes}
    for cls in classes:
        for f in dataclasses.fields(cls):
            tp = _scalar_type(hints[cls][f.name])
            if not f.init or tp not in (str, int, float, bool):
                continue
            parser.add_argument(f"--{f.name}", dest=f.name,
                                type=_parse_bool if tp is bool else tp,
                                default=argparse.SUPPRESS)
    given = vars(parser.parse_args(argv))
    return tuple(cls(**{k: v for k, v in given.items()
                        if k in {f.name for f in dataclasses.fields(cls)}})
                 for cls in classes)


def build_llava_config(model_args: ModelArguments,
                       training_args: TrainingArguments,
                       data_args: DataArguments,
                       tiny: bool = False) -> LlavaConfig:
    """Merge the named preset with the CLI overrides."""
    if model_args.model_use:
        preset_dict = dict(ModelConfig[model_args.model_use])
    else:
        preset_dict = dict(_PRESETS["v4"])
    for k in ("projector_loc", "use_alternative",
              "matryoshka_vis_token_scale", "moe", "lm_loss_type"):
        v = getattr(model_args, k)
        if v is not None:
            preset_dict[k] = v
    preset = M3Preset.from_dict(preset_dict)

    if tiny or model_args.model_name_or_path.startswith("debug://"):
        llama = LlamaConfig.tiny_debug(remat=True)
        vision = ClipVisionConfig.tiny_debug(
            select_layer=model_args.mm_vision_select_layer)
    else:
        llama = dataclasses.replace(LlamaConfig.vicuna_7b(), remat=True)
        vision = ClipVisionConfig.vit_l_14_336(
            select_layer=model_args.mm_vision_select_layer,
            select_feature=model_args.mm_vision_select_feature,
            dtype="bfloat16" if training_args.bf16 else "float32")

    return LlavaConfig(
        llama=llama, vision=vision, preset=preset,
        mm_projector_type=model_args.mm_projector_type,
        mm_patch_merge_type=model_args.mm_patch_merge_type,
        image_aspect_ratio=data_args.image_aspect_ratio,
        tokenizer_model_max_length=training_args.model_max_length,
        router_feature_types=router_features(preset))


def _batches(dataset, collator, sampler_indices, batch_size):
    batch = []
    for idx in sampler_indices:
        batch.append(dataset[idx])
        if len(batch) == batch_size:
            yield collator(batch)
            batch = []
    if batch:
        yield collator(batch)


LLAMA_WIDTHS = ("vocab_size", "hidden_size", "intermediate_size",
                "num_hidden_layers", "num_attention_heads",
                "num_key_value_heads", "max_position_embeddings",
                "rms_norm_eps", "rope_theta")
VISION_WIDTHS = ("hidden_size", "intermediate_size", "num_hidden_layers",
                 "num_attention_heads", "image_size", "patch_size",
                 "layer_norm_eps")


def _with_checkpoint_widths(cfg: LlavaConfig,
                            ckpt: LlavaConfig) -> LlavaConfig:
    """``cfg`` (from the arguments) with the widths of a checkpoint's
    config: the preset, remat and dtypes stay the arguments'.  (The JAX
    ``train()`` takes the checkpoint's config whole, and so drops the
    arguments' preset and remat.)"""
    def take(mine, theirs, fields):
        return dataclasses.replace(
            mine, **{f: getattr(theirs, f) for f in fields})

    return dataclasses.replace(
        cfg, llama=take(cfg.llama, ckpt.llama, LLAMA_WIDTHS),
        vision=take(cfg.vision, ckpt.vision, VISION_WIDTHS),
        mm_projector_type=ckpt.mm_projector_type)


def _build_params(model_args, training_args, cfg, device):
    """The parameters and the config to train: random ones for
    ``debug://`` paths, else the checkpoint that ``load_pretrained_model``
    reads (with the widths it gives, :func:`_with_checkpoint_widths`), with
    the quantized base and the adapters the arguments ask for."""
    from ..models.convert import init_params

    path = model_args.model_name_or_path
    if path.startswith("debug://"):
        params = init_params(cfg, device=device, seed=training_args.seed)
    else:
        from ..models.builder import load_pretrained_model
        from ..models.llava import router_embed_dim
        from ..models.router import init_dense_gating_params

        _, model, _, _ = load_pretrained_model(path, device=str(device),
                                               seed=training_args.seed)
        params = model.params
        cfg = _with_checkpoint_widths(cfg, model.cfg)
        vdt = torch_dtype(cfg.vision.dtype)
        params["vision_tower"] = _cast_floats(params["vision_tower"], vdt)
        if cfg.is_m3_moe and "router" not in params and \
                parse_kv_from_string(cfg.preset.moe).get("t") == "dense":
            # a router to train over a checkpoint that has none
            gen = torch.Generator(device=device).manual_seed(
                training_args.seed)
            params["router"] = init_dense_gating_params(
                gen, router_embed_dim(cfg), len(cfg.tokscale_list),
                device=device)
    if training_args.bits in (4, 8):
        # quantize the LM base before (optionally) adding adapters: QLoRA.
        # fuse=False keeps the per-projection leaves LoRA wraps
        from ..ops.quant import quantize_llama_params

        if not (training_args.lora_enable or model_args.tune_mm_mlp_adapter
                or model_args.tune_router):
            raise ValueError("--bits 4/8 freezes the LM base; combine with "
                             "--lora_enable (QLoRA) or an adapter-only mode")
        quantize_llama_params(params, bits=training_args.bits,
                              min_size=1 << 16, fuse=False)
    if training_args.lora_enable:
        from ..ops.lora import add_lora

        gen = torch.Generator(device=device).manual_seed(
            training_args.seed + 1)
        params = add_lora(params, gen, r=training_args.lora_r,
                          alpha=float(training_args.lora_alpha))
    return params, cfg


def _cast_floats(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def train(attn_implementation: str = "flash", argv=None) -> TrainState:
    """Parse the arguments (``argv``, or ``sys.argv``), train, save; returns
    the final ``TrainState``."""
    model_args, data_args, training_args = parse_args_into_dataclasses(
        (ModelArguments, DataArguments, TrainingArguments), argv)
    mesh, device = _ranks(training_args)
    dp = 1 if mesh is None else mesh.size(0)
    lead = mesh is None or dist.get_rank() == 0
    np.random.seed(training_args.seed)

    # ---- conversation template ----
    conversation_lib.default_conversation = conversation_lib.conv_templates[
        model_args.version
        if model_args.version in conversation_lib.conv_templates
        else "vicuna_v1"]

    # ---- config + params ----
    cfg = build_llava_config(model_args, training_args, data_args)
    bert_cfg = None
    if "textcls" in cfg.router_feature_types:
        # the frozen BERT prompt embedder of the router's textcls feature:
        # random from seed 0 (no BGE weights here), tiny for debug:// paths;
        # the router's input takes its width (the JAX train() keeps 384 and
        # so cannot build a debug:// router)
        from ..models.text_embedder import BertConfig

        bert_cfg = (BertConfig.tiny_debug()
                    if model_args.model_name_or_path.startswith("debug://")
                    else BertConfig.bge_small())
        cfg = dataclasses.replace(cfg, text_embed_dim=bert_cfg.hidden_size)
    if lead:
        os.makedirs(training_args.output_dir, exist_ok=True)
        with open(os.path.join(training_args.output_dir, "args.json"),
                  "w") as f:
            json.dump({
                "model_args": dataclasses.asdict(model_args),
                "data_args": {k: v for k, v in
                              dataclasses.asdict(data_args).items()
                              if k != "image_processor"},
                "training_args": dataclasses.asdict(training_args),
            }, f, indent=2)

    from ..image_processing import ClipImageProcessor
    from ..models.builder import _load_tokenizer

    params, cfg = _build_params(model_args, training_args, cfg, device)
    tokenizer = _load_tokenizer(model_args.model_name_or_path, None,
                                cfg.llama.vocab_size)
    tokenizer.model_max_length = training_args.model_max_length

    # ---- data ----
    s = cfg.vision.image_size
    data_args.image_processor = ClipImageProcessor(
        size={"shortest_edge": s}, crop_size={"height": s, "width": s})
    data_args.is_multimodal = True
    data_args.mm_use_im_start_end = model_args.mm_use_im_start_end
    module = make_supervised_data_module(tokenizer, data_args)
    dataset, collator = module["train_dataset"], module["data_collator"]

    # ---- optimizer / state ----
    # the global batch: every data rank's rows
    micro_bsz = training_args.per_device_train_batch_size * dp
    steps_per_epoch = max(len(dataset) // micro_bsz, 1)
    total_steps = (training_args.max_steps if training_args.max_steps > 0
                   else int(steps_per_epoch * training_args.num_train_epochs))
    opt_cfg = OptimizerConfig(
        learning_rate=training_args.learning_rate,
        weight_decay=training_args.weight_decay,
        warmup_ratio=training_args.warmup_ratio,
        total_steps=total_steps,
        lr_schedule={"cosine": "cosine", "linear": "linear"}.get(
            training_args.lr_scheduler_type, "constant"),
        mm_projector_lr=training_args.mm_projector_lr,
        mm_vision_tower_lr=training_args.mm_vision_tower_lr,
        router_lr=training_args.router_lr,
        freeze_backbone=model_args.freeze_backbone,
        tune_mm_mlp_adapter=model_args.tune_mm_mlp_adapter,
        freeze_mm_mlp_adapter=training_args.freeze_mm_mlp_adapter,
        unfreeze_mm_vision_tower=model_args.unfreeze_mm_vision_tower,
        tune_router=model_args.tune_router,
        lora_enable=training_args.lora_enable)

    # auto-resume: the newest `checkpoint-*` replaces the parameters
    start_step = 0
    resume = latest_checkpoint(training_args.output_dir)
    if resume:
        print(f"Resuming from {resume}")
        restored, _ = load_checkpoint(resume, device=device)
        if training_args.lora_enable and "lora" in restored:
            # adapter-subset checkpoint: re-attach onto the base tree
            from ..ops.lora import load_lora, strip_lora

            merged = load_lora(strip_lora(params), restored["lora"])
            for key in ("mm_projector", "router", "image_newline"):
                if key in restored:
                    merged[key] = restored[key]
            restored = merged
        elif "llama" not in restored:
            # projector-only checkpoint: onto the full tree
            restored = {**params, **restored}
        params = restored
        start_step = load_meta(resume).get("step", 0)
    if mesh is not None:
        from ..parallel.sharding import shard_params

        params = shard_params(mesh, params)
    state, tx = create_train_state(params, opt_cfg)
    state = state._replace(step=start_step)
    if training_args.gradient_accumulation_steps > 1:
        tx = MultiSteps(tx, training_args.gradient_accumulation_steps)
        state = state._replace(opt_state=tx.init(state.params))
    # frozen CLIP (every recipe except unfreeze_mm_vision_tower): no
    # backward through it at all
    step_fn = make_train_step(
        cfg, tx, frozen_vision=not model_args.unfreeze_mm_vision_tower)

    # ---- sampler ----
    def make_sampler(lengths, **kw):
        return LengthGroupedSampler(
            training_args.per_device_train_batch_size,
            dp * training_args.gradient_accumulation_steps, lengths=lengths,
            generator=np.random.default_rng(training_args.seed), **kw)

    if training_args.group_by_modality_length or \
            training_args.group_by_modality_length_auto:
        sampler = make_sampler(dataset.modality_lengths,
                               group_by_modality=True)
    elif training_args.group_by_length:
        sampler = make_sampler(dataset.lengths)
    else:
        sampler = None

    def tensor(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def rows(batch: M3Batch) -> M3Batch:
        if mesh is None:
            return batch
        from ..parallel import put_batch

        return M3Batch(*put_batch(mesh, tuple(batch), device=device))

    text_embedder = None
    if bert_cfg is not None:
        from ..models.text_embedder import TextEmbedder

        text_embedder = TextEmbedder(tokenizer, cfg=bert_cfg, device=device)

    global_step = start_step
    t_start = time.time()
    done = False
    metrics_path = os.path.join(training_args.output_dir, "metrics.jsonl")
    with (open(metrics_path, "a") if lead
          else contextlib.nullcontext()) as metrics_file:
        for epoch in range(int(np.ceil(training_args.num_train_epochs))):
            indices = (list(iter(sampler)) if sampler is not None
                       else np.random.default_rng(
                           training_args.seed + epoch).permutation(
                           len(dataset)).tolist())
            for raw in _batches(dataset, collator, indices, micro_bsz):
                if len(raw["input_ids"]) < micro_bsz:
                    continue  # drop the ragged tail
                if mesh is not None:
                    # every rank trains on rank 0's global batch, whatever
                    # its own tokenizer made of it (the debug tokenizer
                    # hashes words with the process's hash seed)
                    box = [raw]
                    dist.broadcast_object_list(box, src=0)
                    raw = box[0]
                batch = M3Batch(
                    input_ids=tensor(raw["input_ids"], torch.int64),
                    pixel_values=tensor(raw["images"], torch.float32),
                    labels=tensor(raw["labels"], torch.int64),
                    attn_mask=tensor(raw["attention_mask"], torch.bool),
                    text_embed=None if text_embedder is None
                    else text_embedder(raw["input_ids"]))
                state, metrics = step_fn(state, rows(batch))
                global_step += 1

                if lead and global_step % training_args.logging_steps == 0:
                    m = host_metrics(metrics)
                    m.update(step=global_step,
                             time=round(time.time() - t_start, 1))
                    metrics_file.write(json.dumps(m) + "\n")
                    metrics_file.flush()
                    print(f"step {global_step}: loss={m['loss']:.4f}")

                if global_step % training_args.save_steps == 0:
                    _save(training_args, model_args, state, cfg, global_step)
                if global_step >= total_steps:
                    done = True
                    break
            if done:
                break
        _save(training_args, model_args, state, cfg, global_step, final=True)
    return state


def _ranks(training_args):
    """``(mesh or None, this rank's device)``: the ranks of a
    ``torch.distributed`` run laid out as ``(world // tp_size, tp_size)``;
    one process without one (where ``tp_size`` / ``dp_size`` above 1
    raise)."""
    from ..parallel import initialize_distributed, make_mesh

    tp, dp = training_args.tp_size, training_args.dp_size
    on_cpu = training_args.device == "cpu"
    if not initialize_distributed(backend="gloo" if on_cpu else None):
        if tp > 1 or (dp or 1) > 1:
            raise ValueError(f"tp_size={tp} / dp_size={dp} need as many "
                             f"ranks: run under torch.distributed.run")
        return None, torch.device(training_args.device)
    world = dist.get_world_size()
    if tp < 1 or world % tp:
        raise ValueError(f"tp_size={tp} does not divide {world} ranks")
    if dp is not None and dp != world // tp:
        raise ValueError(f"dp_size={dp} != {world} ranks // tp_size={tp}")
    mesh = make_mesh((world // tp, tp),
                     device_type="cpu" if on_cpu else None)
    device = torch.device("cpu") if on_cpu else \
        torch.device("cuda", torch.cuda.current_device())
    return mesh, device


def _save(training_args, model_args, state: TrainState, cfg, step: int,
          final: bool = False):
    """One of the three save shapes, into ``output_dir`` itself (final) or
    ``checkpoint-<step>``; then old checkpoints are pruned.  Placed
    parameters: every rank gathers the saved leaves whole, rank 0
    writes."""
    from ..ops.lora import extract_lora
    from ..parallel.sharding import full_tree, is_sharded

    out = training_args.output_dir if final else os.path.join(
        training_args.output_dir, f"checkpoint-{step}")
    params = state.params
    lora = getattr(training_args, "lora_enable", False)
    if is_sharded(params):
        if lora or model_args.tune_mm_mlp_adapter:
            keys = ("mm_projector", "router", "image_newline") if lora \
                else ("mm_projector", "image_newline")
            part = {k: params[k] for k in keys if k in params}
            params = full_tree({**(extract_lora(params) if lora else {}),
                                **part})
        else:
            params = full_tree(params)
        if dist.get_rank() != 0:
            return
    if lora:
        # adapters + the non-LoRA trainables
        save_lora_checkpoint(out, params, cfg, step=step)
    elif model_args.tune_mm_mlp_adapter:
        save_projector_only(out, params, cfg, step=step)
    else:
        save_checkpoint(out, params, cfg, step=step,
                        extra={"argmaxcost_ema": float(state.argmaxcost_ema)})
    if not final and training_args.save_total_limit:
        cands = sorted(
            (d for d in os.listdir(training_args.output_dir)
             if d.startswith("checkpoint-")),
            key=lambda d: int(d.split("-")[-1]))
        for stale in cands[: -training_args.save_total_limit]:
            shutil.rmtree(os.path.join(training_args.output_dir, stale),
                          ignore_errors=True)


if __name__ == "__main__":
    train()
