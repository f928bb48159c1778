"""PyTorch port: a LLaVA-NeXT checkpoint directory through both packages'
``load_pretrained_model`` and ``eval_model``.

The directory is written here from ``transformers`` random-init models at
a tiny width with the published tile of 336 pixels (so both packages'
``ClipImageProcessor`` defaults fit it): bf16 safetensors shards holding
``model.image_newline``, and a ``config.json`` with ``image_aspect_ratio:
"anyres"``, ``mm_patch_merge_type: "spatial_unpad"`` and pinpoints in the
published form.  Both loads must give the same ``image_newline`` and the
same greedy tokens; ``eval_model`` must print the JAX package's answer for
an anyres image and for a two-image prompt under ``pad``."""

import json
import os

import numpy as np
import jax
import pytest
import torch
import transformers
from PIL import Image
from safetensors.torch import save_file

from matryoshka_mm_tpu.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_tpu.eval import run_llava as jax_run
from matryoshka_mm_tpu.generate import GenerationConfig as JaxGenConfig
from matryoshka_mm_tpu.generate import generate as jax_generate
from matryoshka_mm_tpu.models import builder as jax_builder
from matryoshka_mm_torch.eval import run_llava
from matryoshka_mm_torch.generate import GenerationConfig, generate
from matryoshka_mm_torch.models import builder
from matryoshka_mm_torch.models.convert import params_from_jax

# V: the vocabulary the JAX loader's DebugTokenizer assumes for a directory
# without tokenizer files, so that both packages' prompts are the same ids
H_LM, V, H_VIS = 32, 32000, 48
IMG, PATCH = 336, 14
# LLaVA-1.6's published pinpoints, cut to grids of one and two tiles a side
PINPOINTS = [[672, 336], [336, 672], [672, 672]]
TOWER = "model.vision_tower.vision_tower."
SPEC = "ver=v0_numtoks=16"
GEN = dict(max_new_tokens=6, decode_chunk=3, eos_token_id=-1)


def _config(aspect, merge, pinpoints):
    return {"vocab_size": V, "hidden_size": H_LM, "intermediate_size": 64,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 4, "rms_norm_eps": 1e-5,
            "mm_projector_type": "mlp2x_gelu", "mm_hidden_size": H_VIS,
            "mm_vision_select_layer": -2, "mm_vision_select_feature": "patch",
            "image_aspect_ratio": aspect, "mm_patch_merge_type": merge,
            "image_grid_pinpoints": pinpoints,
            "vision_tower_config": {
                "hidden_size": H_VIS, "intermediate_size": 96,
                "num_hidden_layers": 3, "num_attention_heads": 4,
                "image_size": IMG, "patch_size": PATCH},
            "config": {"use_alternative": True, "projection_type": "v4",
                       "matryoshka_vis_token_scale":
                           "ver=v0_numtoks=[1,4,16,144,576]",
                       "moe": None, "projector_loc": "after_vision_tower",
                       "lm_loss_type": "micro"}}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """``next``: the LLaVA-NeXT directory (pinpoints as a string, which the
    JAX config needs to stay hashable); ``next_list``: the same with the
    pinpoints as the published JSON list; ``pad``: the same weights under
    ``image_aspect_ratio: "pad"`` and the flat merge."""
    torch.manual_seed(0)
    lm = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=V, hidden_size=H_LM, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        rms_norm_eps=1e-5, rope_theta=10000.0))
    vis = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=H_VIS, intermediate_size=96, num_hidden_layers=3,
        num_attention_heads=4, image_size=IMG, patch_size=PATCH,
        layer_norm_eps=1e-5))
    g = torch.Generator().manual_seed(1)
    sd = dict(lm.state_dict())
    sd.update({TOWER + k: v for k, v in vis.state_dict().items()})
    for name, shape in (("0.weight", (H_LM, H_VIS)), ("0.bias", (H_LM,)),
                        ("2.weight", (H_LM, H_LM)), ("2.bias", (H_LM,))):
        sd[f"model.mm_projector.{name}"] = torch.randn(shape, generator=g) / 4
    sd["model.image_newline"] = torch.randn(H_LM, generator=g) * H_LM ** -0.5
    sd = {k: v.to(torch.bfloat16).contiguous() for k, v in sd.items()}
    root = tmp_path_factory.mktemp("next")
    out = {}
    for name, cfg in (
            ("next", _config("anyres", "spatial_unpad",
                             str([tuple(p) for p in PINPOINTS]))),
            ("next_list", _config("anyres", "spatial_unpad", PINPOINTS)),
            ("pad", _config("pad", "flat", None))):
        path = root / name
        os.makedirs(path)
        keys = sorted(sd)
        for i, part in enumerate((keys[::2], keys[1::2])):
            save_file({k: sd[k] for k in part}, str(
                path / f"model-0000{i + 1}-of-00002.safetensors"))
        with open(path / "config.json", "w") as f:
            json.dump(cfg, f)
        out[name] = str(path)
    return out


@pytest.fixture(scope="module")
def loads(dirs):
    _, jmodel, _, _ = jax_builder.load_pretrained_model(dirs["next"], None,
                                                        None)
    _, model, _, _ = builder.load_pretrained_model(dirs["next"], device="cpu")
    return jmodel, model


def _tile_prompt(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, V - 5, (1, 9)).astype(np.int32)
    ids[0, 3] = IMAGE_TOKEN_INDEX
    # a 500 x 300 image: the (672, 336) grid, base + 2 tiles
    px = (rng.standard_normal((1, 3, 3, IMG, IMG)) * 0.5).astype(np.float32)
    return ids, px, [(500, 300)]


def test_the_directory_loads_the_newline_as_jax(loads):
    jmodel, model = loads
    cfg = model.cfg
    assert (cfg.image_aspect_ratio, cfg.mm_patch_merge_type) == \
        ("anyres", "spatial_unpad")
    assert cfg.image_grid_pinpoints == jmodel.cfg.image_grid_pinpoints
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg,
                           device="cpu")["image_newline"]
    got = model.params["image_newline"]
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == (H_LM,) and torch.equal(got, want)


def test_the_directory_generates_jax_tokens(loads, dirs):
    jmodel, model = loads
    ids, px, sizes = _tile_prompt()
    want = jax_generate(jmodel.params, jmodel.cfg, ids, px, image_sizes=sizes,
                        matryoshka_vis_token_scale=SPEC,
                        gen_cfg=JaxGenConfig(**GEN))
    got = generate(model.params, model.cfg, ids, px, image_sizes=sizes,
                   matryoshka_vis_token_scale=SPEC,
                   gen_cfg=GenerationConfig(**GEN))
    np.testing.assert_array_equal(got, np.asarray(want))
    # the published list form of the pinpoints gives the same model
    _, listed, _, _ = builder.load_pretrained_model(dirs["next_list"],
                                                    device="cpu")
    np.testing.assert_array_equal(
        generate(listed.params, listed.cfg, ids, px, image_sizes=sizes,
                 matryoshka_vis_token_scale=SPEC,
                 gen_cfg=GenerationConfig(**GEN)), got)


def _images(tmp_path, sizes):
    rng = np.random.default_rng(3)
    paths = []
    for i, (w, h) in enumerate(sizes):
        path = tmp_path / f"img{i}.png"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(path)
        paths.append(str(path))
    return ",".join(paths)


def _eval_both(monkeypatch, path, image_file, query):
    """The port's and the JAX package's ``eval_model`` answers, and what
    the port's ``generate`` was given and gave back."""
    seen = {}
    real = builder.LlavaModel.generate

    def spy(self, input_ids, images=None, **kw):
        out = real(self, input_ids, images, **kw)
        seen.update(ids=input_ids, images=images, out=out, **kw)
        return out

    monkeypatch.setattr(builder.LlavaModel, "generate", spy)
    common = ["--model-path", path, "--image-file", image_file,
              "--query", query, "--temperature", "0",
              "--max_new_tokens", "6", "--matryoshka_vis_token_scale", SPEC]
    got = run_llava.eval_model(run_llava.build_parser().parse_args(
        common + ["--device", "cpu"]))
    want = jax_run.eval_model(jax_run.build_parser().parse_args(common))
    return got, want, seen


def _crc_tokenizers(monkeypatch):
    """Both debug tokenizers number words by CRC-32 instead of ``hash``,
    so the prompt is the same in every process whatever PYTHONHASHSEED."""
    from tests.test_torch_families_loader import _crc_words

    for cls in (builder.DebugTokenizer, jax_builder.DebugTokenizer):
        monkeypatch.setattr(cls, "__call__", _crc_words)


def test_eval_model_answers_an_anyres_image_as_jax(dirs, tmp_path,
                                                   monkeypatch):
    _crc_tokenizers(monkeypatch)
    got, want, seen = _eval_both(monkeypatch, dirs["next"],
                                 _images(tmp_path, [(500, 300)]),
                                 "What is shown?")
    assert got == want
    assert seen["images"].shape == (1, 3, 3, IMG, IMG)
    assert seen["image_sizes"] == [(500, 300)]
    assert seen["out"].shape[0] == 1 and seen["out"].shape[1] >= 1


def test_eval_model_answers_two_images_under_pad_as_jax(dirs, tmp_path,
                                                        monkeypatch):
    _crc_tokenizers(monkeypatch)
    got, want, seen = _eval_both(
        monkeypatch, dirs["pad"], _images(tmp_path, [(400, 300), (200, 260)]),
        "<image-placeholder> and <image-placeholder>: what differs?")
    assert got == want
    assert seen["images"].shape == (2, 3, IMG, IMG)
    assert int((seen["ids"] == IMAGE_TOKEN_INDEX).sum()) == 2
    assert seen["out"].shape[0] == 1 and seen["out"].shape[1] >= 1
