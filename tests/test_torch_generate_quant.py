"""PyTorch port, the quantized slice as a whole on the tiny config: JAX
``maybe_quantize`` weights bridged with ``params_from_jax`` give the same
greedy tokens through the port's ``generate`` as through the JAX
``generate`` under ``load_4bit``, ``load_8bit`` and ``load_4bit`` with the
int8 KV cache.  Both sides dequantize on the CPU, so the tokens must be
equal."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest

from matryoshka_mm_tpu.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGenConfig,
                                        generate as jax_generate)
from matryoshka_mm_tpu.models.builder import maybe_quantize
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.generate import GenerationConfig, generate
from matryoshka_mm_torch.models.convert import params_from_jax
from matryoshka_mm_torch.ops.quant import quantize_llama_params

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxLlavaConfig.tiny_debug()
    return jcfg, init_llava_params(jax.random.PRNGKey(0), jcfg), \
        LlavaConfig.tiny_debug()


@pytest.fixture(scope="module")
def quantized(tiny):
    """bits -> (JAX quantized params, the same bridged to the port)."""
    jcfg, jparams, tcfg = tiny
    out = {}
    for bits in (4, 8):
        jq = maybe_quantize(jax.tree.map(lambda a: a, jparams),
                            load_8bit=bits == 8, load_4bit=bits == 4)
        out[bits] = jq, params_from_jax(jax.tree.map(np.asarray, jq), tcfg,
                                       device="cpu")
    return out


def _prompt(batch):
    rng = np.random.default_rng(batch)
    px = rng.standard_normal((batch, 3, 56, 56)).astype(np.float32)
    if batch == 1:
        ids = np.array([[1, 23, 57, IMAGE_TOKEN_INDEX, 88, 91, 14]], np.int32)
        return ids, px, None
    ids = np.array([[1, 23, 57, IMAGE_TOKEN_INDEX, 88, 91, 14],
                    [0, 0, 1, IMAGE_TOKEN_INDEX, 301, 77, 5]], np.int32)
    return ids, px, ids != 0


def _with_kv(jcfg, tcfg, kv):
    if not kv:
        return jcfg, tcfg
    return (dataclasses.replace(jcfg, llama=dataclasses.replace(
        jcfg.llama, kv_cache_dtype=kv)), tcfg.with_kv_cache_dtype(kv))


@pytest.mark.parametrize("bits,kv,numtoks,batch", [
    (4, "", 4, 1), (4, "", 4, 2), (4, "", 16, 1), (4, "", 16, 2),
    (8, "", 16, 2), (4, "int8", 16, 2)])
def test_quantized_greedy_tokens_equal_jax(tiny, quantized, bits, kv,
                                           numtoks, batch):
    jcfg, tcfg = _with_kv(tiny[0], tiny[2], kv)
    jp, tp = quantized[bits]
    ids, px, mask = _prompt(batch)
    spec = f"ver=v0_numtoks={numtoks}"
    kw = dict(max_new_tokens=8, decode_chunk=3, eos_token_id=-1)
    want = jax_generate(jp, jcfg, ids, px, attention_mask=mask,
                        matryoshka_vis_token_scale=spec,
                        gen_cfg=JaxGenConfig(**kw))
    got = generate(tp, tcfg, ids, px, attention_mask=mask,
                   matryoshka_vis_token_scale=spec,
                   gen_cfg=GenerationConfig(**kw))
    assert got.shape == (batch, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_port_quantized_weights_give_the_jax_tokens(tiny, quantized):
    """The port's own ``quantize_llama_params`` on the bridged float
    weights: the same tokens as the JAX-quantized run."""
    jcfg, jparams, tcfg = tiny
    tp = quantize_llama_params(
        params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                        device="cpu"), bits=4)
    ids, px, mask = _prompt(2)
    kw = dict(max_new_tokens=6, decode_chunk=4, eos_token_id=-1)
    want = jax_generate(quantized[4][0], jcfg, ids, px, attention_mask=mask,
                        matryoshka_vis_token_scale="ver=v0_numtoks=16",
                        gen_cfg=JaxGenConfig(**kw))
    got = generate(tp, tcfg, ids, px, attention_mask=mask,
                   matryoshka_vis_token_scale="ver=v0_numtoks=16",
                   gen_cfg=GenerationConfig(**kw))
    np.testing.assert_array_equal(got, np.asarray(want))


_DRIVE = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import numpy as np
from matryoshka_mm_torch.models.builder import load_pretrained_model
from matryoshka_mm_torch.ops.quant import is_quantized
for kw in ({"load_4bit": True}, {"load_8bit": True},
           {"load_4bit": True, "kv_cache_dtype": "int8"}):
    _, model, _, _ = load_pretrained_model("debug://tiny", device="cpu", **kw)
    llama = model.params["llama"]
    assert is_quantized(llama["lm_head"])
    assert is_quantized(llama["layers"][0]["self_attn"]["qkv_proj"])
    ids = np.array([[1, 5, -200, 17, 42]], np.int32)
    px = np.random.default_rng(0).standard_normal((1, 3, 56, 56)).astype(
        np.float32)
    out = model.generate(ids, images=px,
                         matryoshka_vis_token_scale="ver=v0_numtoks=4",
                         max_new_tokens=4, decode_chunk=2, eos_token_id=-1)
    assert out.shape == (1, 4), out.shape
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            if sys.modules[m] is not None]
print("OK")
"""


def test_quantized_tiny_generate_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _DRIVE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_eval_model_takes_the_quantized_options(tmp_path, capsys):
    from PIL import Image

    from matryoshka_mm_torch.eval.run_llava import build_parser, eval_model

    img = np.random.default_rng(0).integers(0, 255, (64, 64, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / "img.png")
    args = build_parser().parse_args([
        "--model-path", "debug://tiny", "--device", "cpu", "--load-4bit",
        "--kv-cache-dtype", "int8", "--image-file", str(tmp_path / "img.png"),
        "--query", "What is shown?", "--temperature", "0",
        "--max_new_tokens", "4",
        "--matryoshka_vis_token_scale", "ver=v0_numtoks=4"])
    assert args.load_4bit and args.kv_cache_dtype == "int8"
    out = eval_model(args)
    assert capsys.readouterr().out.strip() == out
