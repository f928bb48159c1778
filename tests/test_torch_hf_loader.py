"""PyTorch port: checkpoint loading against the JAX ``load_pretrained_model``.

Every checkpoint here is random-init and written by the test, at the size
of ``tests/test_e2e_checkpoint_parity.py``: a ``transformers``
``LlamaForCausalLM`` and ``CLIPVisionModel`` in the liuhaotian layout,
with a ``config.json`` of the test's own.  The port's safetensors reader is
held against ``safetensors.safe_open``; each source the JAX loader accepts
(a full directory as ``.bin`` or safetensors shards, no tower, a router,
LoRA over a base, projector-only over a base, the port's own checkpoint)
gives the JAX leaves bit for bit after ``params_from_jax``, or the
tolerance stated, and the same greedy tokens.
"""

import dataclasses
import json
import logging
import os
import struct
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import transformers
from safetensors import safe_open
from safetensors.torch import save_file

from matryoshka_mm_tpu.generate import GenerationConfig as JaxGenConfig
from matryoshka_mm_tpu.generate import gating_probs as jax_gating_probs
from matryoshka_mm_tpu.generate import generate as jax_generate
from matryoshka_mm_tpu.models import builder as jax_builder
from matryoshka_mm_tpu.models.convert import merge_lora as jax_merge_lora
from matryoshka_mm_tpu.models.llava import forward_spliced as jax_forward
from matryoshka_mm_tpu.models.llava import prepare_multimodal as jax_prepare
from matryoshka_mm_torch.generate import GenerationConfig, gating_probs
from matryoshka_mm_torch.generate import generate
from matryoshka_mm_torch.models import builder
from matryoshka_mm_torch.models.convert import (lora_pairs, merge_lora,
                                                params_from_jax)
from matryoshka_mm_torch.models.llava import forward_spliced, prepare_multimodal
from matryoshka_mm_torch.train import train as ttrain
from matryoshka_mm_torch.train.optimizer import named_leaves
from matryoshka_mm_torch.utils.checkpoint import save_checkpoint
from matryoshka_mm_torch.utils.safetensors_io import SafetensorsFile

H_LM, V, H_VIS = 32, 128, 48
IMG, PATCH = 56, 14                    # 4 x 4 patches: scales 1 / 4 / 16
SCALES = "ver=v0_numtoks=[1,4,16]"
TOWER = "model.vision_tower.vision_tower."
MOE = "t=dense_ft=cls_obj=weightedlm_loadb=switch_alpha=0.01"
LORA_R, LORA_ALPHA = 4, 8
PROJS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
         "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
LOGIT_TOL = 1e-2                       # bf16 weights, bf16 activations
GATE_TOL = 1e-5                        # float32 weights
MERGE_RTOL = 1e-6                      # float32 sums in another order


def _config(moe=None, m3=True) -> dict:
    d = {"vocab_size": V, "hidden_size": H_LM, "intermediate_size": 64,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 4, "rms_norm_eps": 1e-5,
         "mm_projector_type": "mlp2x_gelu", "mm_hidden_size": H_VIS,
         "mm_vision_select_layer": -2, "mm_vision_select_feature": "patch",
         "image_aspect_ratio": "pad", "max_sequence_length": 96,
         "vision_tower_config": {
             "hidden_size": H_VIS, "intermediate_size": 96,
             "num_hidden_layers": 3, "num_attention_heads": 4,
             "image_size": IMG, "patch_size": PATCH}}
    if m3:
        d["config"] = {"use_alternative": True, "projection_type": "v4",
                       "matryoshka_vis_token_scale": SCALES, "moe": moe,
                       "projector_loc": "after_vision_tower",
                       "lm_loss_type": "micro"}
    return d


@pytest.fixture(scope="module")
def hf():
    """The float32 state dicts of the tiny LLaVA: ``lm``, ``tower``,
    ``projector``, ``router``."""
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

    def rand(*shape, s=0.1):
        return torch.randn(*shape, generator=g) * s

    return {
        "lm": dict(lm.state_dict()),
        "tower": {TOWER + k: v for k, v in vis.state_dict().items()},
        "projector": {"model.mm_projector.0.weight": rand(H_LM, H_VIS),
                      "model.mm_projector.0.bias": rand(H_LM),
                      "model.mm_projector.2.weight": rand(H_LM, H_LM),
                      "model.mm_projector.2.bias": rand(H_LM)},
        "router": {"model.router.fc1.weight": rand(24, H_VIS, s=0.2),
                   "model.router.fc1.bias": rand(24, s=0.2),
                   "model.router.fc2.weight": rand(3, 24, s=0.2),
                   "model.router.fc2.bias": rand(3, s=0.2)},
    }


def _write(path, sd: dict, cfg: dict, fmt="bin", dtype=torch.float32):
    """A checkpoint directory: ``config.json`` and ``sd`` cast to ``dtype``
    as ``pytorch_model.bin`` or as two safetensors shards."""
    os.makedirs(path, exist_ok=True)
    sd = {k: v.to(dtype) for k, v in sd.items()}
    if fmt == "bin":
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    else:
        keys = sorted(sd)
        for i, part in enumerate((keys[::2], keys[1::2])):
            save_file({k: sd[k].contiguous() for k in part}, os.path.join(
                path, f"model-0000{i + 1}-of-00002.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    return str(path)


def _full(hf, *extra):
    sd = {**hf["lm"], **hf["tower"], **hf["projector"]}
    for name in extra:
        sd.update(hf[name])
    return sd


@pytest.fixture(scope="module")
def dirs(hf, tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    full = _full(hf)
    return {
        "f32_bin": _write(root / "f32_bin", full, _config()),
        "f16_safetensors": _write(root / "f16_st", full, _config(),
                                  "safetensors", torch.float16),
        "bf16_bin": _write(root / "bf16_bin", full, _config(), "bin",
                           torch.bfloat16),
        "bf16_safetensors": _write(root / "bf16_st", full, _config(),
                                   "safetensors", torch.bfloat16),
        "moe": _write(root / "moe", _full(hf, "router"), _config(MOE)),
    }


@pytest.fixture(scope="module")
def jax_loads():
    """One JAX load per directory, shared by the tests."""
    cache = {}

    def load(path, base=None):
        if (path, base) not in cache:
            cache[path, base] = jax_builder.load_pretrained_model(
                path, base, None)
        return cache[path, base]
    return load


def _port(path, base=None, **kw):
    return builder.load_pretrained_model(path, base, device="cpu", **kw)


def _bridged(jmodel, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg,
                           device="cpu")


def _assert_same_leaves(got, want, only=None):
    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    if only is not None:
        got = {k: v for k, v in got.items() if k.split("/")[0] in only}
        want = {k: v for k, v in want.items() if k.split("/")[0] in only}
    assert want and set(got) == set(want)
    bad = [k for k in want if not (got[k].dtype == want[k].dtype
                                   and torch.equal(got[k], want[k]))]
    assert not bad, bad[:8]


def _prompt(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, V - 5, (1, 9)).astype(np.int32)
    ids[0, 3] = -200
    px = (rng.standard_normal((1, 3, IMG, IMG)) * 0.5).astype(np.float32)
    return ids, px


def _tokens(jmodel, tmodel, spec, seed=0):
    ids, px = _prompt(seed)
    kw = dict(max_new_tokens=8, decode_chunk=3, eos_token_id=-1)
    want = np.asarray(jax_generate(jmodel.params, jmodel.cfg, ids, px,
                                   matryoshka_vis_token_scale=spec,
                                   gen_cfg=JaxGenConfig(**kw)))
    got = generate(tmodel.params, tmodel.cfg, ids, px,
                   matryoshka_vis_token_scale=spec,
                   gen_cfg=GenerationConfig(**kw))
    return got, want


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

def _every_dtype():
    g = torch.Generator().manual_seed(3)
    out = {}
    for name in ("bfloat16", "float16", "float32", "float64"):
        out[name] = torch.randn(3, 5, generator=g).to(getattr(torch, name))
    for name in ("int8", "uint8", "int16", "int32", "int64"):
        dt = getattr(torch, name)
        lo = 0 if dt == torch.uint8 else -100
        out[name] = torch.randint(lo, 100, (4, 2, 3), generator=g, dtype=dt)
    out["bool"] = torch.rand(7, generator=g) > 0.5
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros(0, 4, dtype=torch.bfloat16)
    out["odd"] = torch.arange(3, dtype=torch.int8)    # the next entry
    return out                                        # starts unaligned


def test_reader_gives_safe_open_bits_for_every_dtype(tmp_path):
    tensors = _every_dtype()
    names = sorted(tensors)
    files = []
    for i, part in enumerate((names[::2], names[1::2])):
        f = str(tmp_path / f"s{i}.safetensors")
        save_file({k: tensors[k] for k in part}, f,
                  metadata={"format": "pt", "shard": str(i)})
        files.append(f)
    seen = set()
    for i, f in enumerate(files):
        mine = SafetensorsFile(f)
        assert mine.metadata == {"format": "pt", "shard": str(i)}
        with safe_open(f, framework="pt") as ref:
            assert mine.keys() == sorted(ref.keys())
            for k in ref.keys():
                got, want = mine.get_tensor(k), ref.get_tensor(k)
                assert got.dtype == want.dtype and got.shape == want.shape
                assert torch.equal(got, want), k
                seen.add(k)
    assert seen == set(names)


def test_reader_views_do_not_write_the_file(tmp_path):
    f = str(tmp_path / "w.safetensors")
    save_file({"a": torch.ones(8)}, f)
    with open(f, "rb") as fh:
        before = fh.read()
    t = SafetensorsFile(f).get_tensor("a")
    t.add_(1)                        # a private mapping: the file keeps
    with open(f, "rb") as fh:        # its bytes
        assert fh.read() == before
    assert torch.equal(SafetensorsFile(f).get_tensor("a"), torch.ones(8))


def _raw(header: dict, data: bytes, n=None) -> bytes:
    h = json.dumps(header).encode()
    return struct.pack("<Q", len(h) if n is None else n) + h + data


_F32 = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
MALFORMED = {
    "short file": b"\x01\x00",
    "header longer than the file": _raw({"a": _F32}, bytes(8), n=1 << 20),
    "header not JSON": struct.pack("<Q", 4) + b"{{{{" + bytes(8),
    "header not an object": _raw([1, 2], b""),
    "unknown dtype": _raw({"a": {**_F32, "dtype": "F8_E4M3"}}, bytes(8)),
    "bytes past the data": _raw({"a": {**_F32,
                                       "data_offsets": [0, 16]}}, bytes(8)),
    "bytes and shape disagree": _raw({"a": {**_F32, "shape": [3]}},
                                     bytes(8)),
    "overlapping tensors": _raw({"a": _F32, "b": {
        **_F32, "shape": [1], "data_offsets": [4, 8]}}, bytes(8)),
    "bad metadata": _raw({"__metadata__": {"k": 1}, "a": _F32}, bytes(8)),
    "negative offset": _raw({"a": {**_F32, "data_offsets": [-4, 4]}},
                            bytes(8)),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_reader_refuses_a_malformed_file(tmp_path, case):
    f = tmp_path / "bad.safetensors"
    f.write_bytes(MALFORMED[case])
    with pytest.raises(ValueError):
        SafetensorsFile(str(f))


def test_a_malformed_shard_fails_the_load(dirs, tmp_path):
    import shutil

    path = tmp_path / "broken"
    shutil.copytree(dirs["f16_safetensors"], path)
    shard = path / "model-00002-of-00002.safetensors"
    shard.write_bytes(shard.read_bytes()[:-2])       # data cut short
    with pytest.raises(ValueError, match="data section"):
        _port(str(path))


# ---------------------------------------------------------------------------
# full checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["f32_bin", "f16_safetensors"])
def test_full_checkpoint_leaves_equal_jax(dirs, jax_loads, fmt):
    jtok, jmodel, _, jctx = jax_loads(dirs[fmt])
    tok, model, proc, ctx = _port(dirs[fmt])
    assert model.cfg.tokscale_list == [1, 4, 16] and ctx == jctx == 96
    assert proc.crop_size == jax_builder.ClipImageProcessor().crop_size
    assert type(tok).__name__ == type(jtok).__name__ == "DebugTokenizer"
    _assert_same_leaves(model.params, _bridged(jmodel, model.cfg))
    for _, t in named_leaves(model.params):
        assert t.dtype == torch.bfloat16 and t.device.type == "cpu"


@pytest.mark.parametrize("numtoks", [1, 4, 16])
def test_full_checkpoint_generates_jax_tokens(dirs, jax_loads, numtoks):
    _, jmodel, _, _ = jax_loads(dirs["f16_safetensors"])
    _, model, _, _ = _port(dirs["f16_safetensors"])
    got, want = _tokens(jmodel, model, f"ver=v0_numtoks={numtoks}")
    np.testing.assert_array_equal(got, want)

    ids, px = _prompt()
    js, _ = jax_prepare(jmodel.params, jmodel.cfg, jnp.asarray(ids),
                        jnp.asarray(px), numtoks=numtoks)
    ts, _ = prepare_multimodal(model.params, model.cfg,
                               torch.as_tensor(ids, dtype=torch.int64),
                               torch.as_tensor(px), numtoks=numtoks)
    n = int(ts.attn_mask.sum())
    assert n == int(np.asarray(js.attn_mask).sum())
    np.testing.assert_allclose(
        forward_spliced(model.params, model.cfg, ts)[0, n - 1].numpy(),
        np.asarray(jax_forward(jmodel.params, jmodel.cfg, js),
                   np.float32)[0, n - 1], atol=LOGIT_TOL)


def test_bf16_safetensors_equal_the_jax_load_of_the_same_bin(dirs,
                                                             jax_loads):
    """The JAX loader cannot read bf16 safetensors (numpy has no bfloat16);
    the same tensors saved as ``.bin`` are its reference."""
    _, jmodel, _, _ = jax_loads(dirs["bf16_bin"])
    _, model, _, _ = _port(dirs["bf16_safetensors"])
    _assert_same_leaves(model.params, _bridged(jmodel, model.cfg))
    _, from_bin, _, _ = _port(dirs["bf16_bin"])
    _assert_same_leaves(model.params, from_bin.params)


def test_checkpoint_without_a_tower_gets_a_random_one(hf, jax_loads,
                                                      tmp_path, caplog):
    path = _write(tmp_path / "notower", {**hf["lm"], **hf["projector"]},
                  _config())
    _, jmodel, _, _ = jax_loads(path)
    with caplog.at_level(logging.WARNING, logger=builder.log.name):
        _, model, _, _ = _port(path, seed=5)
    assert [r.getMessage() for r in caplog.records
            if "CLIP tower" in r.getMessage()]
    want = _bridged(jmodel, model.cfg)
    _assert_same_leaves(model.params, want, only=("llama", "mm_projector"))
    got_t = dict(named_leaves(model.params["vision_tower"]))
    want_t = dict(named_leaves(want["vision_tower"]))
    assert {k: (v.shape, v.dtype) for k, v in got_t.items()} == \
        {k: (v.shape, v.dtype) for k, v in want_t.items()}
    _, again, _, _ = _port(path, seed=5)
    _assert_same_leaves(again.params, model.params)


def test_missing_lm_head_means_tied_embeddings(hf, jax_loads, tmp_path):
    lm = {k: v for k, v in hf["lm"].items() if k != "lm_head.weight"}
    path = _write(tmp_path / "tied", {**lm, **hf["tower"],
                                      **hf["projector"]}, _config())
    _, jmodel, _, _ = jax_loads(path)
    _, model, _, _ = _port(path)
    assert "lm_head" not in model.params["llama"]
    got, want = _tokens(jmodel, model, "ver=v0_numtoks=4")
    np.testing.assert_array_equal(got, want)


def test_a_checkpoint_missing_a_decoder_weight_raises(hf, tmp_path):
    sd = _full(hf)
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(ValueError, match="lacks 1 parameters"):
        _port(_write(tmp_path / "holed", sd, _config()))


# ---------------------------------------------------------------------------
# the router and gateprobargmax
# ---------------------------------------------------------------------------

def _as_f32(cfg):
    return dataclasses.replace(
        cfg, llama=dataclasses.replace(cfg.llama, dtype="float32"),
        vision=dataclasses.replace(cfg.vision, dtype="float32"))


def test_router_checkpoint_gating_probs_equal_jax(dirs, jax_loads):
    _, jmodel, _, _ = jax_loads(dirs["moe"])
    _, model, _, _ = _port(dirs["moe"])
    assert model.cfg.is_m3_moe and model.cfg.router_feature_types == ("cls",)
    _assert_same_leaves(model.params, _bridged(jmodel, model.cfg),
                        only=("router",))
    _, px = _prompt(5)
    px = np.concatenate([px, -px])
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a,
                        jmodel.params)
    want = np.asarray(jax_gating_probs(jp32, _as_f32(jmodel.cfg), px))
    got = gating_probs(ttrain._cast_floats(model.params, torch.float32),
                       _as_f32(model.cfg), px)
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=GATE_TOL)
    np.testing.assert_allclose(model.gating_probs(px).numpy(),
                               np.asarray(jax_gating_probs(
                                   jmodel.params, jmodel.cfg, px)),
                               atol=LOGIT_TOL)


def test_gateprobargmax_picks_the_jax_scale_and_tokens(dirs, jax_loads):
    _, jmodel, _, _ = jax_loads(dirs["moe"])
    _, model, _, _ = _port(dirs["moe"])
    for seed in (0, 1, 2):
        _, px = _prompt(seed)
        pick = model.cfg.tokscale_list[int(model.gating_probs(px)[0]
                                           .argmax())]
        assert pick == jmodel.cfg.tokscale_list[int(np.asarray(
            jax_gating_probs(jmodel.params, jmodel.cfg, px))[0].argmax())]
        got, want = _tokens(jmodel, model, "ver=v0_numtoks=gateprobargmax",
                            seed)
        np.testing.assert_array_equal(got, want)
        fixed, _ = _tokens(jmodel, model, f"ver=v0_numtoks={pick}", seed)
        np.testing.assert_array_equal(got, fixed)


def test_gateprobargmax_refuses_a_batch_and_a_model_without_router(
        dirs, jax_loads):
    _, model, _, _ = _port(dirs["moe"])
    ids, px = _prompt()
    spec = "ver=v0_numtoks=gateprobargmax"
    with pytest.raises(ValueError, match="batch_size=1"):
        generate(model.params, model.cfg, np.repeat(ids, 2, 0),
                 np.repeat(px, 2, 0), matryoshka_vis_token_scale=spec)
    _, jmodel, _, _ = jax_loads(dirs["moe"])
    with pytest.raises(ValueError, match="batch_size=1"):
        jax_generate(jmodel.params, jmodel.cfg, np.repeat(ids, 2, 0),
                     np.repeat(px, 2, 0), matryoshka_vis_token_scale=spec)
    _, plain, _, _ = _port(dirs["f32_bin"])
    assert plain.gating_probs(px) is None
    with pytest.raises(ValueError, match="M3-MoE"):
        generate(plain.params, plain.cfg, ids, px,
                 matryoshka_vis_token_scale=spec)


# ---------------------------------------------------------------------------
# LoRA and projector-only checkpoints over a base
# ---------------------------------------------------------------------------

def _adapter(seed=7) -> dict:
    """PEFT keys: ``base_model.model.`` prefixes, ``.default`` on half."""
    g = torch.Generator().manual_seed(seed)
    dims = {"self_attn.q_proj": (H_LM, H_LM), "self_attn.k_proj": (H_LM, H_LM),
            "self_attn.v_proj": (H_LM, H_LM), "self_attn.o_proj": (H_LM, H_LM),
            "mlp.gate_proj": (64, H_LM), "mlp.up_proj": (64, H_LM),
            "mlp.down_proj": (H_LM, 64)}
    out = {}
    for i in range(2):
        for j, name in enumerate(PROJS):
            n_out, n_in = dims[name]
            d = ".default" if (i + j) % 2 else ""
            stem = f"base_model.model.model.layers.{i}.{name}"
            out[f"{stem}.lora_A{d}.weight"] = torch.randn(
                LORA_R, n_in, generator=g) * 0.1
            out[f"{stem}.lora_B{d}.weight"] = torch.randn(
                n_out, LORA_R, generator=g) * 0.1
    return out


def _lora_dir(hf, root, base_dtype):
    base = _write(root / "base", hf["lm"], {
        k: v for k, v in _config().items()
        if k not in ("config", "vision_tower_config")}, "bin", base_dtype)
    path = root / "lora"
    os.makedirs(path)
    with open(path / "adapter_config.json", "w") as f:
        json.dump({"r": LORA_R, "lora_alpha": LORA_ALPHA,
                   "target_modules": [p.split(".")[1] for p in PROJS]}, f)
    torch.save(_adapter(), path / "adapter_model.bin")
    torch.save({"base_model.model." + k: v for k, v in
                {**hf["tower"], **hf["projector"]}.items()},
               path / "non_lora_trainables.bin")
    with open(path / "config.json", "w") as f:
        json.dump(_config(), f)
    return str(path), base


def _merge_targets():
    return [f"model.layers.{i}.{p}.weight" for i in range(2) for p in PROJS]


def test_lora_over_an_f32_base_merges_as_jax(hf, jax_loads, tmp_path):
    path, base = _lora_dir(hf, tmp_path, torch.float32)
    scaling = LORA_ALPHA / LORA_R
    adapter = _adapter()
    want = jax_merge_lora(dict(hf["lm"]), adapter, scaling)
    pairs = lora_pairs(adapter)
    assert sorted(pairs) == sorted(_merge_targets())
    for k in _merge_targets():
        got = merge_lora(hf["lm"][k], *pairs[k], scaling)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want[k]),
                                   rtol=MERGE_RTOL)
    _, jmodel, _, _ = jax_loads(path, base)
    _, model, _, _ = _port(path, base)
    _assert_same_leaves(model.params, _bridged(jmodel, model.cfg),
                        only=("vision_tower", "mm_projector"))
    for numtoks in (1, 16):
        got, want_t = _tokens(jmodel, model, f"ver=v0_numtoks={numtoks}")
        np.testing.assert_array_equal(got, want_t)


def test_lora_over_a_bf16_base_merges_in_float32(hf, tmp_path):
    """The JAX ``merge_lora`` refuses a bf16 base; the port merges in
    float32 and rounds once, as this numpy merge does."""
    path, base = _lora_dir(hf, tmp_path, torch.bfloat16)
    _, model, _, _ = _port(path, base)
    pairs = {k: (a.numpy(), b.numpy())
             for k, (a, b) in lora_pairs(_adapter()).items()}
    leaves = dict(named_leaves(model.params["llama"]))
    for k in _merge_targets():
        w = hf["lm"][k].to(torch.bfloat16).float().numpy()
        a, b = pairs[k]
        merged = w + np.float32(LORA_ALPHA / LORA_R) * (b @ a)
        want = torch.from_numpy(merged).to(torch.bfloat16)
        leaf = k[len("model."):-len(".weight")].replace(".", "/")
        assert torch.equal(leaves[leaf], want), k
    untouched = leaves["layers/0/input_layernorm"]
    assert torch.equal(untouched, hf["lm"][
        "model.layers.0.input_layernorm.weight"].to(torch.bfloat16))


def test_projector_only_checkpoint_over_a_base(hf, jax_loads, tmp_path):
    base = _write(tmp_path / "base", {**hf["lm"], **hf["tower"]}, _config())
    path = tmp_path / "proj"
    os.makedirs(path)
    torch.save(hf["projector"], path / "mm_projector.bin")
    with open(path / "config.json", "w") as f:
        json.dump(_config(), f)
    _, jmodel, _, _ = jax_loads(str(path), base)
    _, model, _, _ = _port(str(path), base)
    _assert_same_leaves(model.params, _bridged(jmodel, model.cfg))


@pytest.mark.parametrize("kind", ["lora", "projector"])
def test_lora_and_projector_checkpoints_need_a_base(tmp_path, kind):
    path = tmp_path / kind
    os.makedirs(path)
    name = "adapter_config.json" if kind == "lora" else "mm_projector.bin"
    (path / name).write_text("{}")
    with open(path / "config.json", "w") as f:
        json.dump(_config(), f)
    with pytest.raises(ValueError, match="require model_base"):
        jax_builder.load_pretrained_model(str(path), None, None)
    with pytest.raises(ValueError, match="require model_base"):
        _port(str(path))


# ---------------------------------------------------------------------------
# the port's own checkpoint, tokenizers, options
# ---------------------------------------------------------------------------

def test_the_ports_own_checkpoint_loads_as_saved(dirs, tmp_path):
    _, model, _, _ = _port(dirs["moe"])
    out = str(tmp_path / "own")
    save_checkpoint(out, model.params, model.cfg, step=3)
    tok, again, proc, ctx = _port(out, kv_cache_dtype="int8")
    _assert_same_leaves(again.params, model.params)
    assert again.cfg == model.cfg.with_kv_cache_dtype("int8")
    assert ctx == model.cfg.tokenizer_model_max_length
    assert type(tok).__name__ == "DebugTokenizer" and tok.vocab_size == V
    assert proc.crop_size == {"height": 336, "width": 336}


def test_load_4bit_from_a_directory_quantizes_as_debug_loads(dirs):
    from matryoshka_mm_torch.ops.quant import quantize_llama_params

    _, model, _, _ = _port(dirs["f32_bin"], load_4bit=True)
    _, plain, _, _ = _port(dirs["f32_bin"])
    quantize_llama_params(plain.params, bits=4)
    _assert_same_leaves(model.params, plain.params)
    assert "qint4" in model.params["llama"]["layers"][0]["mlp"]["down_proj"]


def test_no_tokenizer_files_give_the_debug_tokenizer_in_both(dirs,
                                                             jax_loads):
    jtok = jax_loads(dirs["f32_bin"])[0]
    tok = _port(dirs["f32_bin"])[0]
    assert isinstance(tok, builder.DebugTokenizer)
    assert type(jtok).__name__ == "DebugTokenizer"
    assert tok.vocab_size == V and max(tok("a b c d").input_ids) < V


def test_a_tokenizer_file_gives_the_auto_tokenizer_in_both(dirs, tmp_path):
    import shutil

    from tokenizers import Tokenizer, models, pre_tokenizers

    path = tmp_path / "with_tok"
    shutil.copytree(dirs["f32_bin"], path)
    vocab = {w: i for i, w in enumerate(
        ["<unk>", "<s>", "</s>", "a", "red", "square"])}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tk, unk_token="<unk>", bos_token="<s>",
        eos_token="</s>").save_pretrained(path)
    jtok = jax_builder.load_pretrained_model(str(path), None, None)[0]
    tok = _port(str(path))[0]
    assert type(tok) is type(jtok) and not isinstance(
        tok, builder.DebugTokenizer)
    assert tok("a red square").input_ids == jtok("a red square").input_ids


def test_is_mm_model_by_name():
    assert builder.is_mm_model("liuhaotian/llava-v1.5-7b")
    assert builder.is_mm_model("debug://tiny")
    assert not builder.is_mm_model("lmsys/vicuna-7b-v1.5")
    assert builder.is_mm_model("/x/LLaVA-m3") == \
        jax_builder.is_mm_model("/x/LLaVA-m3")


# ---------------------------------------------------------------------------
# training from a checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture
def train_data(tmp_path):
    from PIL import Image

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    Image.new("RGB", (48, 48), (180, 40, 40)).save(img_dir / "r.jpg")
    rows = [{"id": str(i), "image": "r.jpg", "conversations": [
        {"from": "human", "value": "<image>\nWrite a caption."},
        {"from": "gpt", "value": f"a red square number {i}"},
    ]} for i in range(4)]
    (tmp_path / "train.json").write_text(json.dumps(rows))
    return ["--data_path", str(tmp_path / "train.json"),
            "--image_folder", str(img_dir),
            "--per_device_train_batch_size", "2", "--model_max_length", "96",
            "--report_to", "none", "--matryoshka_vis_token_scale", SCALES,
            "--output_dir", str(tmp_path / "out")]


class _Stop(Exception):
    pass


def test_build_params_from_a_directory_equals_jax_train(hf, tmp_path,
                                                        train_data,
                                                        monkeypatch):
    """Both ``train()``s load the same leaves.  The JAX ``train()`` then
    takes the checkpoint's config whole, so over a base whose config.json
    has no M3 ``config`` (liuhaotian's layout) it drops the arguments'
    scales and remat; the port keeps them and takes only the widths."""
    from matryoshka_mm_tpu.train import train as jtrain

    path = _write(tmp_path / "plain", _full(hf), _config(m3=False))
    seen = {}
    real_state = jtrain.create_train_state

    def record_state(params, *a, **k):
        seen["params"] = jax.tree.map(np.asarray, params)
        return real_state(params, *a, **k)

    def stop(cfg, *a, **k):
        seen["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(jtrain, "create_train_state", record_state)
    monkeypatch.setattr(jtrain, "make_train_step", stop)
    monkeypatch.setattr(sys, "argv", ["train", "--model_name_or_path", path]
                        + train_data)
    with pytest.raises(_Stop):
        jtrain.train()
    assert seen["cfg"].tokscale_list == [] and not seen["cfg"].llama.remat

    margs, dargs, targs = ttrain.parse_args_into_dataclasses(
        (ttrain.ModelArguments, ttrain.DataArguments,
         ttrain.TrainingArguments),
        ["--model_name_or_path", path, "--device", "cpu"] + train_data)
    cfg = ttrain.build_llava_config(margs, targs, dargs)
    params, cfg = ttrain._build_params(margs, targs, cfg, torch.device("cpu"))
    assert cfg.tokscale_list == [1, 4, 16] and cfg.llama.remat
    assert (cfg.llama.hidden_size, cfg.vision.hidden_size,
            cfg.vision.image_size) == (H_LM, H_VIS, IMG)
    _assert_same_leaves(params, params_from_jax(seen["params"], cfg,
                                                device="cpu"))


def test_train_takes_lora_steps_from_a_checkpoint_directory(dirs,
                                                            train_data):
    out = train_data[-1]
    state = ttrain.train(argv=["--model_name_or_path", dirs["f32_bin"],
                               "--device", "cpu", "--lora_enable", "True",
                               "--lora_r", "4", "--max_steps", "2",
                               "--learning_rate", "1e-3"] + train_data)
    assert state.step == 2
    rows = [json.loads(line) for line in
            open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    trained = {p for p, t in named_leaves(state.params) if t.requires_grad}
    assert trained and all("lora_" in p or p.startswith("mm_projector")
                           for p in trained)


def test_build_params_adds_a_router_the_checkpoint_lacks(dirs, train_data):
    margs, dargs, targs = ttrain.parse_args_into_dataclasses(
        (ttrain.ModelArguments, ttrain.DataArguments,
         ttrain.TrainingArguments),
        ["--model_name_or_path", dirs["f32_bin"], "--device", "cpu",
         "--moe", "t=dense_ft=cls_obj=weightedlm"] + train_data)
    cfg = ttrain.build_llava_config(margs, targs, dargs)
    params, cfg = ttrain._build_params(margs, targs, cfg, torch.device("cpu"))
    assert cfg.is_m3_moe
    assert params["router"]["fc1"]["weight"].shape == (H_VIS, H_VIS)
    assert params["router"]["fc2"]["weight"].shape == (3, H_VIS)
