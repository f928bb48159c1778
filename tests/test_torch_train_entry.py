"""PyTorch port: ``train()`` end to end on ``debug://tiny`` on the CPU, as
``tests/test_pretrain_smoke.py`` drives the JAX entry point: a four-sample
JSON with a generated image; stage 1 (``--tune_mm_mlp_adapter``), resume
from ``checkpoint-*``, the saved projector dropped into
``load_pretrained_model``; then ``--lora_enable`` with gradient
accumulation and a length-grouped sampler."""

import json
import os

import numpy as np
import pytest
import torch

from matryoshka_mm_torch.models.builder import load_pretrained_model
from matryoshka_mm_torch.train import train as ttrain
from matryoshka_mm_torch.train.optimizer import named_leaves
from matryoshka_mm_torch.utils.checkpoint import load_checkpoint, load_meta

SCALES = "ver=v0_numtoks=[1,4,16]"


@pytest.fixture
def data(tmp_path):
    from PIL import Image

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    Image.new("RGB", (48, 48), (180, 40, 40)).save(img_dir / "r.jpg")
    rows = [{"id": str(i), "image": "r.jpg", "conversations": [
        {"from": "human", "value": "<image>\nWrite a caption."},
        {"from": "gpt", "value": f"a red square number {i} " + "very " * i},
    ]} for i in range(4)]
    path = tmp_path / "train.json"
    path.write_text(json.dumps(rows))
    return ["--model_name_or_path", "debug://tiny", "--data_path", str(path),
            "--image_folder", str(img_dir), "--device", "cpu",
            "--per_device_train_batch_size", "2", "--learning_rate", "1e-3",
            "--model_max_length", "128", "--report_to", "none",
            "--matryoshka_vis_token_scale", SCALES]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_projector_only_training_saves_resumes_and_loads_back(tmp_path, data):
    out = str(tmp_path / "stage1")
    args = data + ["--version", "plain", "--tune_mm_mlp_adapter", "True",
                   "--output_dir", out, "--save_steps", "1"]
    state = ttrain.train(argv=args + ["--num_train_epochs", "1"])
    assert state.step == 2
    trained = {p for p, t in named_leaves(state.params) if t.requires_grad}
    assert trained and all(p.startswith("mm_projector") for p in trained)
    rows = _metrics(out)
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in rows)
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint-")) \
        == ["checkpoint-1", "checkpoint-2"]
    with open(os.path.join(out, "args.json")) as f:
        assert json.load(f)["model_args"]["tune_mm_mlp_adapter"] is True

    # the final save lands in output_dir itself and holds the projector only
    restored, cfg = load_checkpoint(out, device="cpu")
    assert set(restored) == {"mm_projector"} and cfg.llama.remat
    assert load_meta(out) == {"step": 2, "projector_only": True}
    w_final = restored["mm_projector"]["layers"][0]["weight"]
    assert torch.equal(w_final,
                       state.params["mm_projector"]["layers"][0]["weight"])

    # resume: a second run of two epochs starts from checkpoint-2
    state = ttrain.train(argv=args + ["--num_train_epochs", "2"])
    assert state.step == 4
    assert [r["step"] for r in _metrics(out)] == [1, 2, 3, 4]
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint-")) \
        == ["checkpoint-3", "checkpoint-4"]       # save_total_limit = 2
    resumed, _ = load_checkpoint(out, device="cpu")
    assert not torch.equal(resumed["mm_projector"]["layers"][0]["weight"],
                           w_final)

    # the saved projector drops into a base model (the stage-2 handoff)
    _, model, _, _ = load_pretrained_model("debug://tiny", device="cpu")
    assert model.params["mm_projector"]["layers"][0]["weight"].shape == \
        w_final.shape
    model.params["mm_projector"] = resumed["mm_projector"]
    ids = np.array([[1, 5, -200, 6, 7]], np.int32)
    px = np.zeros((1, 3, 56, 56), np.float32)
    tokens = model.generate(ids, images=px,
                            matryoshka_vis_token_scale="ver=v0_numtoks=4",
                            max_new_tokens=3, eos_token_id=-1)
    assert tokens.shape == (1, 3)


def test_lora_training_with_accumulation_saves_adapters(tmp_path, data):
    from matryoshka_mm_torch.ops.lora import load_lora

    out = str(tmp_path / "lora")
    args = data + ["--version", "v1", "--lora_enable", "True", "--lora_r", "4",
                   "--lora_alpha", "8", "--output_dir", out,
                   "--gradient_accumulation_steps", "2",
                   "--group_by_modality_length", "True", "--save_steps", "2",
                   "--moe", "t=dense_ft=cls_obj=weightedlm_loadb=switch"
                            "_alpha=0.01"]
    state = ttrain.train(argv=args)
    assert state.step == 2 and state.opt_state["inner"]["count"] == 1
    restored, cfg = load_checkpoint(out, device="cpu")
    assert set(restored) == {"lora", "mm_projector", "router"}
    assert cfg.router_feature_types == ("cls",) and cfg.is_m3_moe
    assert load_meta(out)["lora_only"] is True
    _, base, _, _ = load_pretrained_model("debug://tiny-moe", device="cpu",
                                          seed=42)
    assert set(base.params["router"]) == set(restored["router"])
    attached = load_lora(base.params, restored["lora"])
    leaf = attached["llama"]["layers"][0]["self_attn"]["q_proj"]
    assert leaf["lora_a"].shape == (4, 64) and bool(leaf["lora_b"].any())
    assert torch.equal(leaf["w"],
                       state.params["llama"]["layers"][0]["self_attn"]
                       ["q_proj"]["w"])
    assert os.path.isdir(os.path.join(out, "checkpoint-2"))
    # a resumed run re-attaches the adapters of checkpoint-2
    again = ttrain.train(argv=args + ["--num_train_epochs", "2"])
    assert again.step == 4


def test_argument_parsing_and_refusals(tmp_path, data):
    m, d, t = ttrain.parse_args_into_dataclasses(
        (ttrain.ModelArguments, ttrain.DataArguments,
         ttrain.TrainingArguments),
        ["--tune_router", "True", "--mm_vision_select_layer", "-1",
         "--data_path", "x.json", "--bf16", "False", "--router_lr", "0.5",
         "--bits", "4"])
    assert m.tune_router is True and m.mm_vision_select_layer == -1
    assert d.data_path == "x.json" and t.bf16 is False and t.bits == 4
    assert t.router_lr == 0.5 and t.device == "cuda" and t.lora_enable is False
    cfg = ttrain.build_llava_config(
        ttrain.ModelArguments(model_use="finetune_v4",
                              moe="t=dense_ft=cls,attnqk_obj=weightedlm",
                              matryoshka_vis_token_scale=SCALES), t, d)
    assert cfg.router_feature_types == ("cls", "attnqk") and cfg.llama.remat
    assert set(ttrain.ModelConfig) == {"pretune_v0", "finetune_v0",
                                      "pretune_v4", "finetune_v4"}
    with pytest.raises(SystemExit):
        ttrain.parse_args_into_dataclasses((ttrain.ModelArguments,),
                                           ["--tune_router", "maybe"])
    out = ["--output_dir", str(tmp_path / "o")]
    # one process: tp_size / dp_size above 1 need as many ranks
    # (tests/test_torch_sharded_train.py runs them on gloo ranks)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        ttrain.train(argv=data + out + ["--tp_size", "2"])
    with pytest.raises(ValueError, match="torch.distributed.run"):
        ttrain.train(argv=data + out + ["--dp_size", "4"])
    # textcls trains (tests/test_torch_text_embedder.py holds its losses
    # against the JAX train()); here one step, on the tiny BERT's width
    state = ttrain.train(argv=data + ["--output_dir", str(tmp_path / "tc"),
                                      "--moe", "t=dense_ft=textcls",
                                      "--max_steps", "1"])
    assert state.step == 1
    assert state.params["router"]["fc1"]["weight"].shape[1] == 32
    with pytest.raises(ValueError, match="--bits 4/8"):
        ttrain.train(argv=data + out + ["--bits", "8"])
    with pytest.raises(FileNotFoundError):      # no such checkpoint here
        ttrain.train(argv=data[2:] + out + ["--model_name_or_path",
                                            "liuhaotian/llava-v1.5-7b"])
