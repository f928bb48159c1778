"""PyTorch port: a LLaVA-Mistral checkpoint directory through both
packages' ``load_pretrained_model`` and ``eval_model``.

The directory is written here from ``transformers`` random-init models at a
tiny width, with the fields of ``liuhaotian/llava-v1.6-mistral-7b``'s
``config.json`` that the loaders read: GQA (2 KV heads of 4),
``rope_theta`` 1e6, ``rms_norm_eps`` 1e-5 and ``sliding_window: null``.
Neither loader reads ``arch`` or ``sliding_window`` (the JAX
``_cfg_from_hf_config``), so both load a ``"llama"`` decoder with the
directory's GQA, theta and eps; the configs must be equal, the decoder's
leaves bit-identical, and the greedy answers of ``eval_model`` the same
(float leaves in bf16 on both sides).  Both packages' ``DebugTokenizer``
number a word by Python's ``hash``, which changes with ``PYTHONHASHSEED``:
the answer test gives both the same CRC-32 numbering, so that its prompt is
the same in every run."""

import dataclasses
import json
import os
import types
import zlib

import jax
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import save_file

from matryoshka_mm_tpu.models import builder as jax_builder
from matryoshka_mm_torch.models import builder
from matryoshka_mm_torch.models.convert import params_from_jax
from matryoshka_mm_torch.train.optimizer import named_leaves
from tests.test_torch_anyres_loader import _eval_both, _images

H_LM, V, H_VIS, IMG = 32, 32000, 48, 336
TOWER = "model.vision_tower.vision_tower."
CONFIG = {
    # llava-v1.6-mistral-7b's own fields, at a tiny width
    "architectures": ["LlavaMistralForCausalLM"],
    "model_type": "llava_mistral", "vocab_size": V, "hidden_size": H_LM,
    "intermediate_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "rms_norm_eps": 1e-5, "rope_theta": 1000000.0, "sliding_window": None,
    "max_position_embeddings": 32768, "tie_word_embeddings": False,
    "mm_projector_type": "mlp2x_gelu", "mm_hidden_size": H_VIS,
    "mm_vision_select_layer": -2, "mm_vision_select_feature": "patch",
    "image_aspect_ratio": "pad", "mm_patch_merge_type": "flat",
    "vision_tower_config": {
        "hidden_size": H_VIS, "intermediate_size": 96,
        "num_hidden_layers": 3, "num_attention_heads": 4,
        "image_size": IMG, "patch_size": 14},
    "config": {"use_alternative": True, "projection_type": "v4",
               "matryoshka_vis_token_scale":
                   "ver=v0_numtoks=[1,4,16,144,576]",
               "moe": None, "projector_loc": "after_vision_tower",
               "lm_loss_type": "micro"},
}


@pytest.fixture(scope="module")
def mistral_dir(tmp_path_factory):
    torch.manual_seed(0)
    lm = transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=V, hidden_size=H_LM, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rms_norm_eps=1e-5, rope_theta=1e6, sliding_window=None))
    vis = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=H_VIS, intermediate_size=96, num_hidden_layers=3,
        num_attention_heads=4, image_size=IMG, patch_size=14,
        layer_norm_eps=1e-5))
    g = torch.Generator().manual_seed(1)
    sd = dict(lm.state_dict())
    sd.update({TOWER + k: v for k, v in vis.state_dict().items()})
    for name, shape in (("0.weight", (H_LM, H_VIS)), ("0.bias", (H_LM,)),
                        ("2.weight", (H_LM, H_LM)), ("2.bias", (H_LM,))):
        sd[f"model.mm_projector.{name}"] = torch.randn(shape, generator=g) / 4
    path = tmp_path_factory.mktemp("llava-mistral")
    save_file({k: v.to(torch.bfloat16).contiguous() for k, v in sd.items()},
              str(path / "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(CONFIG, f)
    return str(path)


def test_both_loaders_read_the_same_config(mistral_dir):
    _, jmodel, _, jctx = jax_builder.load_pretrained_model(mistral_dir, None,
                                                           None)
    _, model, _, ctx = builder.load_pretrained_model(mistral_dir,
                                                     device="cpu")
    assert ctx == jctx
    got, want = model.cfg.llama, jmodel.cfg.llama
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.arch, got.sliding_window) == ("llama", 0)
    assert (got.num_key_value_heads, got.rope_theta, got.rms_norm_eps) == \
        (2, 1e6, 1e-5)
    k = model.params["llama"]["layers"][0]["self_attn"]["k_proj"]
    assert k.shape == (2 * H_LM // 4, H_LM) and k.dtype == torch.bfloat16
    want = dict(named_leaves(params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), model.cfg,
        device="cpu")["llama"]))
    have = dict(named_leaves(model.params["llama"]))
    assert set(have) == set(want)
    for path, t in have.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path


def _crc_words(self, text, **kw):
    """The debug tokenizer's word numbering with CRC-32 in place of
    ``hash``."""
    span = self.vocab_size - 100
    return types.SimpleNamespace(input_ids=[self.bos_token_id] + [
        self.eos_token_id if w == "</s>"
        else zlib.crc32(w.encode()) % span + 100
        for w in text.replace("</s>", " </s> ").split()])


def test_eval_model_answers_as_jax(mistral_dir, tmp_path, monkeypatch):
    for cls in (builder.DebugTokenizer, jax_builder.DebugTokenizer):
        monkeypatch.setattr(cls, "__call__", _crc_words)
    got, want, seen = _eval_both(monkeypatch, mistral_dir,
                                 _images(tmp_path, [(400, 300)]),
                                 "What is shown?")
    assert got == want
    assert seen["images"].shape == (1, 3, IMG, IMG)
    assert seen["out"].shape[0] == 1 and seen["out"].shape[1] >= 1
