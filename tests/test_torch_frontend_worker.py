"""PyTorch port: both packages' ``ModelWorker(no_register=True)`` over one
tiny HF / LLaVA checkpoint directory give the same stream of chunks.

The directory is written as ``tests/test_e2e_checkpoint_parity.py:42-87``
writes one (``transformers`` random-init LLaMA and CLIP, a seeded
projector, ``pytorch_model.bin``), with 336-pixel images (both loaders give
a HF directory the default 336-pixel processor) and a 32,000-token
vocabulary (the JAX loader's ``DebugTokenizer`` spans 32,000).  Both
``DebugTokenizer`` number words by CRC-32 here, so the prompt ids do not
depend on ``PYTHONHASHSEED``.  Both loaders cast the weights to bf16.

Held equal: the chunk texts of a greedy one-image request at scale 9 on
the solo stream and on the paged batcher; the error chunks of an
image-count mismatch, an unknown LoRA adapter and an over-long prompt;
``resolve_auto_kv_dtype`` for 16 and 80 GiB of device memory."""

import base64
import io
import json
import os

import numpy as np
import pytest
import torch
import transformers

from matryoshka_mm_tpu.models import builder as jax_builder
from matryoshka_mm_tpu.serve import model_worker as jmw
from matryoshka_mm_torch.models import builder
from matryoshka_mm_torch.serve import model_worker as tmw
from tests.test_torch_families_loader import _crc_words

H_LM, V, H_VIS, IMG, PATCH = 32, 32000, 48, 336, 14


def write_hf_dir(path) -> str:
    """A tiny liuhaotian-layout checkpoint directory at ``path``."""
    path = str(path)
    os.makedirs(path, exist_ok=True)
    torch.manual_seed(0)
    lm = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=V, hidden_size=H_LM, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        rms_norm_eps=1e-5, rope_theta=10000.0)).eval()
    vis = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=H_VIS, intermediate_size=96, num_hidden_layers=3,
        num_attention_heads=4, image_size=IMG, patch_size=PATCH,
        layer_norm_eps=1e-5)).eval()
    sd = dict(lm.state_dict())
    for k, v in vis.state_dict().items():
        sd[f"model.vision_tower.vision_tower.{k}"] = v
    g = torch.Generator().manual_seed(1)
    for name, shape in (("0.weight", (H_LM, H_VIS)), ("0.bias", (H_LM,)),
                        ("2.weight", (H_LM, H_LM)), ("2.bias", (H_LM,))):
        sd[f"model.mm_projector.{name}"] = torch.randn(shape,
                                                       generator=g) * 0.1
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "vocab_size": V, "hidden_size": H_LM, "intermediate_size": 64,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 4, "rms_norm_eps": 1e-5,
            "max_position_embeddings": 2048,
            "mm_projector_type": "mlp2x_gelu", "mm_hidden_size": H_VIS,
            "mm_vision_select_layer": -2, "mm_vision_select_feature": "patch",
            "image_aspect_ratio": "pad",
            "vision_tower_config": {
                "hidden_size": H_VIS, "intermediate_size": 96,
                "num_hidden_layers": 3, "num_attention_heads": 4,
                "image_size": IMG, "patch_size": PATCH,
            },
            "config": {"use_alternative": True, "projection_type": "v4",
                       "matryoshka_vis_token_scale":
                           "ver=v0_numtoks=[1,9,36,144,576]",
                       "moe": None, "projector_loc": "after_vision_tower",
                       "lm_loss_type": "micro"},
        }, f)
    return path


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return write_hf_dir(tmp_path_factory.mktemp("llava-frontend"))


@pytest.fixture
def crc_words(monkeypatch):
    for cls in (builder.DebugTokenizer, jax_builder.DebugTokenizer):
        monkeypatch.setattr(cls, "__call__", _crc_words)


def _image_b64(seed=0, size=(300, 240)) -> str:
    from PIL import Image

    rgb = np.random.default_rng(seed).integers(
        0, 256, (size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _workers(path, **kw):
    jw = jmw.ModelWorker("http://c", "http://w", "j", True, path, None,
                         "llava-frontend", **kw)
    tw = tmw.ModelWorker("http://c", "http://w", "t", True, path, None,
                         "llava-frontend", device="cpu", **kw)
    return jw, tw


def _chunks(worker, params) -> list:
    raw = b"".join(worker.generate_stream_gate(params))
    return [json.loads(c) for c in raw.split(b"\0") if c]


def _request(**kw) -> dict:
    return {"prompt": "USER: <image>\nwhat is in the picture today "
                      "ASSISTANT:",
            "images": [_image_b64()], "temperature": 0.0,
            "max_new_tokens": 20,
            "matryoshka_vis_token_scale": "ver=v0_numtoks=9", **kw}


ERRORS = {
    "image count": _request(prompt="USER: <image> and <image> ASSISTANT:"),
    "unknown lora": _request(lora="nope"),
    "over-long prompt": _request(prompt="USER: <image>\n"
                                 + "word " * 1500 + "ASSISTANT:"),
}


@pytest.mark.parametrize("batching", [False, True],
                         ids=["solo", "paged-batcher"])
def test_workers_stream_the_same_chunks(hf_dir, crc_words, batching):
    kw = dict(continuous_batching=True, kv_backend="paged", max_batch=2,
              pool_prefill_len=256, pool_max_new=64) if batching else {}
    jw, tw = _workers(hf_dir, **kw)
    try:
        got, want = _chunks(tw, _request()), _chunks(jw, _request())
        assert got == want
        assert [c["error_code"] for c in got] == [0] * len(got)
        assert len(got) >= 3 and got[-1]["text"] != got[0]["text"]
        for name, params in ERRORS.items():
            assert _chunks(tw, params) == _chunks(jw, params), name
        assert tw.get_status() == jw.get_status()
    finally:
        for w in (jw, tw):
            if w.batcher is not None:
                w.batcher.shutdown()


def test_error_chunks_are_the_wire_protocol(hf_dir, crc_words):
    (_, tw) = _workers(hf_dir)
    for name, params in ERRORS.items():
        (chunk,) = _chunks(tw, params)
        if name == "over-long prompt":
            assert chunk["error_code"] == 0
            assert chunk["text"].endswith("Exceeds max token length. Please "
                                          "start a new conversation, "
                                          "thanks.")
        else:
            assert chunk == {"text": tmw.server_error_msg, "error_code": 1}


@pytest.mark.parametrize("gib", [16, 80])
def test_resolve_auto_kv_dtype_equal(gib):
    from matryoshka_mm_tpu.models.llava import LlavaConfig as JaxLlavaConfig
    from matryoshka_mm_torch.config import LlavaConfig

    # llava-v1.5-7b-m3 behind the worker's default batcher: 8 rows of
    # 1,600 + 1,024 slots, ~13.5 GB of bf16 weights
    args = (13_476_839_424, 8, 1024 + 576 + 1024)
    want = jmw.resolve_auto_kv_dtype(JaxLlavaConfig.llava_v15_7b_m3(), *args,
                                     hbm_bytes=gib << 30)
    got = tmw.resolve_auto_kv_dtype(LlavaConfig.llava_v15_7b_m3(), *args,
                                    hbm_bytes=gib << 30)
    assert got == want == ("int8" if gib == 16 else "")
    with pytest.raises(ValueError, match="hbm_bytes"):
        tmw.resolve_auto_kv_dtype(LlavaConfig.llava_v15_7b_m3(), *args,
                                  device="cpu")


def test_tree_nbytes_counts_leaves_as_stored():
    import jax

    from matryoshka_mm_tpu.ops.quant import tree_nbytes as jax_nbytes
    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.ops.quant import (quantize_llama_params,
                                               tree_nbytes)

    params = init_params(LlavaConfig.tiny_debug(), device="cpu", seed=0)
    arrays = jax.tree.map(lambda t: t.numpy(), params)
    assert tree_nbytes(params) == jax_nbytes(arrays) > 0
    before = tree_nbytes(params["llama"])
    quantize_llama_params(params, bits=4, min_size=1)
    packed = [leaf["qint4"] for layer in params["llama"]["layers"]
              for group in layer.values() if isinstance(group, dict)
              for leaf in group.values()
              if isinstance(leaf, dict) and "qint4" in leaf]
    assert packed and tree_nbytes(params["llama"]) < before
    assert tree_nbytes(packed) == sum(p.numel() for p in packed)
