"""PyTorch port: ``utils/checkpoint.py``: the three save shapes (full,
projector-only, LoRA) round-trip bit for bit through the JAX package's
orbax layout, with the configuration, the optimizer state, the meta data
and the auto-resume discovery."""

import dataclasses
import os

import pytest
import torch

from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.models import builder, convert
from matryoshka_mm_torch.models.convert import init_params
from matryoshka_mm_torch.ops.lora import add_lora, load_lora, strip_lora
from matryoshka_mm_torch.ops.quant import quantize_llama_params
from matryoshka_mm_torch.train.optimizer import named_leaves
from matryoshka_mm_torch.utils import checkpoint as ck
from matryoshka_mm_torch.utils.orbax_io import read_tree

MOE = "t=dense_ft=cls_obj=weightedlm"


def _model(moe=None, bits=0, lora=False):
    cfg = LlavaConfig.tiny_debug(moe=moe)
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_hidden_layers=2, remat=True,
        remat_policy="names:flash_out,flash_lse"))
    params = init_params(cfg, device="cpu", seed=3)
    if bits:
        quantize_llama_params(params, bits=bits, fuse=False)
    if lora:
        params = add_lora(params, torch.Generator().manual_seed(1), r=2)
        for p, t in named_leaves(params):
            if p.endswith("lora_b"):
                t.add_(0.5)
    return cfg, params


def _assert_same_tree(got, want):
    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    assert set(got) == set(want)
    for p in want:
        assert got[p].dtype == want[p].dtype and torch.equal(got[p], want[p])


@pytest.mark.parametrize("moe,bits", [(None, 0), (MOE, 0), (None, 4)])
def test_full_checkpoint_round_trip(tmp_path, moe, bits):
    cfg, params = _model(moe=moe, bits=bits)
    for _, t in named_leaves(params):
        if t.is_floating_point():
            t.requires_grad_()          # a live train state saves as it is
    out = str(tmp_path / "full")
    ck.save_checkpoint(out, params, cfg, step=7,
                       opt_state={"count": 3, "mu": {"a": torch.ones(2)}},
                       extra={"argmaxcost_ema": 0.25})
    restored, rcfg = ck.load_checkpoint(out, device="cpu")
    assert rcfg == cfg and rcfg.router_feature_types == \
        cfg.router_feature_types
    _assert_same_tree(restored, params)
    assert not any(t.requires_grad for _, t in named_leaves(restored))
    assert ck.load_meta(out) == {"step": 7, "argmaxcost_ema": 0.25}
    assert os.path.isdir(os.path.join(out, "params"))
    opt = read_tree(os.path.join(out, "opt_state"))
    assert opt["count"] == 3 and torch.equal(opt["mu"]["a"], torch.ones(2))
    assert ck.load_meta(str(tmp_path)) == {}


def test_projector_only_round_trip(tmp_path):
    cfg, params = _model()
    params["image_newline"] = torch.arange(4.0)
    out = str(tmp_path / "proj")
    ck.save_projector_only(out, params, cfg, step=2)
    restored, rcfg = ck.load_checkpoint(out, device="cpu")
    assert set(restored) == {"mm_projector", "image_newline"} and rcfg == cfg
    _assert_same_tree(restored["mm_projector"], params["mm_projector"])
    assert ck.load_meta(out) == {"step": 2, "projector_only": True}


@pytest.mark.parametrize("bits", [0, 8])
def test_lora_checkpoint_round_trip(tmp_path, bits):
    cfg, params = _model(moe=MOE, bits=bits, lora=True)
    out = str(tmp_path / "lora")
    ck.save_lora_checkpoint(out, params, cfg, step=5)
    restored, _ = ck.load_checkpoint(out, device="cpu")
    assert set(restored) == {"lora", "mm_projector", "router"}
    assert not [p for p, _ in named_leaves(restored["lora"])
                if "/w" in p or "qint" in p]
    again = load_lora(strip_lora(params), restored["lora"])
    _assert_same_tree(again["llama"], params["llama"])
    assert ck.load_meta(out) == {"step": 5, "lora_only": True}


def test_latest_checkpoint(tmp_path):
    assert ck.latest_checkpoint(str(tmp_path / "none")) is None
    assert ck.latest_checkpoint(str(tmp_path)) is None
    for n in (9, 10, 2):
        (tmp_path / f"checkpoint-{n}").mkdir()
    (tmp_path / "other").mkdir()
    assert ck.latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / "checkpoint-10")


@pytest.mark.parametrize("fn", [convert.params_from_jax,
                                convert.paged_cache_from_jax,
                                ck.load_checkpoint,
                                convert.convert_llava_state,
                                convert.random_vision_tower,
                                builder.load_pretrained_model],
                         ids=lambda f: f.__name__)
def test_weight_bridges_and_loader_build_on_the_card_unless_told_otherwise(
        fn):
    """Like ``init_params``, the weight bridge, the paged-cache bridge, the
    checkpoint loaders and the HF state-dict conversion put their tensors
    on the card by default; the CPU has to be named."""
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"
