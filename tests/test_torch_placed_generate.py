"""PyTorch port: the entry points on weights placed at (1, 2) over two gloo
ranks by ``shard_model_for_inference``, each against the JAX package on
weights its own ``shard_model_for_inference`` places on its 8-device CPU
mesh (two decoder layers of the tiny model, float32):

* ``beam_generate``, ``speculative_generate`` and
  ``LlavaModel.generate(num_beams=3)``: the tokens, exactly;
* ``chunked_prefill``: the last-position logits, ``1e-5`` absolute;
* ``gating_probs`` (the tiny MoE model): the router probabilities,
  ``1e-5`` absolute;
* the lmms-eval ``llava`` adapter's ``loglikelihood`` on a request with an
  image and a text-only one: each request's logits (``request_logits``)
  ``1e-5`` absolute against the JAX adapter's forward, the log-probability
  ``1e-5`` relative and the greedy flag exactly against the JAX adapter's
  ``loglikelihood``.

Both sides number words by CRC-32 (``_CRC``, one source run in both), so
that the ranks and the test's process tokenize alike.  The ranks get the
bridged parameters in a file, block ``jax`` and hand back their results;
the JAX side runs while they work.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGenConfig,
                                        beam_generate as jax_beam,
                                        chunked_prefill as jax_chunked,
                                        gating_probs as jax_gating,
                                        speculative_generate as jax_spec)
from matryoshka_mm_tpu.lmms_eval.api.instance import Instance as JaxInstance
from matryoshka_mm_tpu.lmms_eval.models import llava as jllava
from matryoshka_mm_tpu.models import builder as jax_builder
from matryoshka_mm_tpu.models.llama import (embed_tokens as jax_embed,
                                            llama_logits as jax_logits)
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            forward_spliced, init_llava_params,
                                            prepare_multimodal)
from matryoshka_mm_tpu.parallel import make_mesh, shard_model_for_inference
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from tests.test_torch_sharding import start_ranks, wait_ranks
from tests.test_torch_train_step import bridge

SCALE = "ver=v0_numtoks=4"
BEAM_IDS = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42, 9]], np.int32)
SPEC_IDS = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42, 9, 17, 42, 9, 17, 42]],
                    np.int32)
CHUNK_B, CHUNK_S, CHUNK_CAP = 2, 128, 144
GATE_MOE = "t=dense_ft=cls_obj=weightedlm"
# loglikelihood requests: (context, continuation, with the image)
LL_ROWS = (("Is there a dog in the image?", " yes", True),
           ("Name one animal.", " a small cat", False))

_CRC = r'''
import zlib


class CrcTokenizer:
    """The debug tokenizer's word numbering with CRC-32 in place of
    ``hash`` (which differs between processes)."""

    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def __call__(self, text, **kw):
        import types

        span = self.vocab_size - 100
        return types.SimpleNamespace(input_ids=[self.bos_token_id] + [
            self.eos_token_id if w == "</s>"
            else zlib.crc32(w.encode()) % span + 100
            for w in text.replace("</s>", " </s> ").split()])
'''
exec(_CRC)


def _cfgs():
    """(JAX config, port config): two layers of the tiny model."""
    j, t = JaxLlavaConfig.tiny_debug(), LlavaConfig.tiny_debug()
    return (dataclasses.replace(j, llama=dataclasses.replace(
                j.llama, num_hidden_layers=2)),
            dataclasses.replace(t, llama=dataclasses.replace(
                t.llama, num_hidden_layers=2)))


def _chunk_rows():
    """Two rows of CHUNK_S ids, the second left-padded by 21."""
    rng = np.random.default_rng(3)
    ids = rng.integers(5, 100, (CHUNK_B, CHUNK_S)).astype(np.int32)
    valid = np.ones((CHUNK_B, CHUNK_S), bool)
    valid[1, :21] = False
    pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    return ids, valid, pos


def _image():
    """A seeded 60 x 45 RGB image (padded to a square by the adapters)."""
    return np.random.default_rng(4).integers(0, 256, (45, 60, 3), np.uint8)


def _jax_adapter(params, cfg):
    """The JAX ``llava`` adapter over ``(params, cfg)``, with the CRC
    tokenizer and the tiny model's image processor."""
    lm = jllava.Llava.__new__(jllava.Llava)
    s = cfg.vision.image_size
    lm.tokenizer = CrcTokenizer(cfg.llama.vocab_size)  # noqa: F821
    lm.model = jax_builder.LlavaModel(params, cfg)
    lm.image_processor = jax_builder.ClipImageProcessor(
        size={"shortest_edge": s}, crop_size={"height": s, "width": s})
    lm.conv_template = "vicuna_v1"
    lm.matryoshka_vis_token_scale = SCALE
    return lm


def _jax_request_logits(lm, req):
    """The logits the JAX adapter's ``loglikelihood`` scores ``req`` by
    (its lines, which keep them to themselves)."""
    context, continuation, visual = req.arguments
    prompt = lm._build_prompt(context, visual is not None)
    ctx_ids = jllava.tokenizer_image_token(prompt, lm.tokenizer)
    cont_ids = lm.tokenizer(continuation).input_ids[1:]
    ids = np.asarray(ctx_ids + cont_ids, np.int32)[None, :]
    if visual is None:
        return np.asarray(jax_logits(lm.model.params["llama"],
                                     lm.model.cfg.llama, jnp.asarray(ids)))
    labels = np.full_like(ids, IGNORE_INDEX)
    labels[0, len(ctx_ids):] = ids[0, len(ctx_ids):]
    pixels = np.asarray(jllava.process_images(
        [visual], lm.image_processor, lm.model.config), np.float32)
    spliced, _ = prepare_multimodal(
        lm.model.params, lm.model.cfg, jnp.asarray(ids), jnp.asarray(pixels),
        numtoks=int(SCALE.rsplit("=", 1)[1]), labels=jnp.asarray(labels))
    return np.asarray(forward_spliced(lm.model.params, lm.model.cfg, spliced))


def _jax_refs(jcfg, jp, jmoe, jmoe_p):
    """The JAX tokens, chunked-prefill logits, router probabilities and
    adapter results on weights placed at (1, 2) by its
    ``shard_model_for_inference``."""
    mesh = make_mesh((1, 2), devices=jax.devices()[:2])
    placed, pcfg, _ = shard_model_for_inference(jp, jcfg, mesh=mesh)
    gate_p, gate_cfg, _ = shard_model_for_inference(jmoe_p, jmoe, mesh=mesh)
    px = np.random.default_rng(1).standard_normal(
        (1, 3, 56, 56)).astype(np.float32)
    ids, valid, pos = _chunk_rows()
    image = Image.fromarray(_image())
    reqs = [JaxInstance("loglikelihood", {}, (c, r, image if i else None),
                        0, "ll", k) for k, (c, r, i) in enumerate(LL_ROWS)]
    with mesh:
        beam = np.asarray(jax_beam(placed, pcfg, BEAM_IDS, px, num_beams=3,
                                   matryoshka_vis_token_scale=SCALE,
                                   gen_cfg=JaxGenConfig(max_new_tokens=6,
                                                        eos_token_id=-1)))
        spec = np.asarray(jax_spec(placed, pcfg, SPEC_IDS, px,
                                   matryoshka_vis_token_scale=SCALE,
                                   gen_cfg=JaxGenConfig(max_new_tokens=10,
                                                        eos_token_id=-1)))
        logits, _ = jax_chunked(placed, pcfg, jax_embed(placed["llama"], ids),
                                jnp.asarray(pos), jnp.asarray(valid),
                                CHUNK_CAP, chunk=CHUNK_S // 2)
        gate = jax_gating(gate_p, gate_cfg, px)
        lm = _jax_adapter(placed, pcfg)
        ll_logits = [_jax_request_logits(lm, r) for r in reqs]
        ll = lm.loglikelihood(reqs)
    return {"beam": beam, "spec": spec, "chunked": np.asarray(logits),
            "gate": np.asarray(gate), "ll_logits": ll_logits, "ll": ll}


_RANK = r"""
import sys
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
import torch
torch.set_num_threads(2)    # ranks share the host's cores
from PIL import Image
from matryoshka_mm_torch.generate import (GenerationConfig, beam_generate,
                                          chunked_prefill, gating_probs,
                                          speculative_generate)
from matryoshka_mm_torch.image_processing import ClipImageProcessor
from matryoshka_mm_torch.lmms_eval.api.instance import Instance
from matryoshka_mm_torch.lmms_eval.models.llava import Llava
from matryoshka_mm_torch.models.builder import LlavaModel
from matryoshka_mm_torch.models.llama import embed_tokens
from matryoshka_mm_torch.parallel import (initialize_distributed,
                                          shard_model_for_inference)

tmp, rank = sys.argv[1], int(sys.argv[2])
g = torch.load(tmp + "/job.pt", weights_only=False)
exec(g["crc"])
initialize_distributed(backend="gloo", init_file=tmp + "/init", rank=rank,
                       world_size=2)
params, cfg, _ = shard_model_for_inference(g["params"], g["cfg"], tp_size=2)
kw = dict(matryoshka_vis_token_scale=g["scale"])
results = {}
results["beam"] = beam_generate(
    params, cfg, g["beam_ids"], g["px"], num_beams=3,
    gen_cfg=GenerationConfig(max_new_tokens=6, eos_token_id=-1), **kw)
results["spec"] = speculative_generate(
    params, cfg, g["spec_ids"], g["px"],
    gen_cfg=GenerationConfig(max_new_tokens=10, eos_token_id=-1), **kw)
model = LlavaModel(params, cfg)
results["model_beam"] = model.generate(
    g["beam_ids"], g["px"], num_beams=3, max_new_tokens=6, eos_token_id=-1,
    **kw)
embeds = embed_tokens(g["params"]["llama"], g["chunk_ids"])
results["chunked"], cache = chunked_prefill(
    params, cfg, embeds, g["chunk_pos"], g["chunk_valid"], g["cap"],
    chunk=g["chunk"])
results["heads"] = cache.k.shape[3]
moe, moe_cfg, _ = shard_model_for_inference(g["moe_params"], g["moe_cfg"],
                                            tp_size=2)
results["gate"] = gating_probs(moe, moe_cfg, g["px"])
# the lmms-eval adapter over the placed model
lm = Llava.__new__(Llava)
s = cfg.vision.image_size
lm.tokenizer = CrcTokenizer(cfg.llama.vocab_size)
lm.model = model
lm.image_processor = ClipImageProcessor(
    size={"shortest_edge": s}, crop_size={"height": s, "width": s})
lm.conv_template = "vicuna_v1"
lm.matryoshka_vis_token_scale = g["scale"]
image = Image.fromarray(g["image"])
reqs = [Instance("loglikelihood", {}, (c, r, image if i else None), 0, "ll",
                 k) for k, (c, r, i) in enumerate(g["ll_rows"])]
results["ll_logits"] = [lm.request_logits(r)[0] for r in reqs]
results["ll"] = lm.loglikelihood(reqs)
if rank == 0:
    torch.save(results, tmp + "/results.pt")
import torch.distributed as dist
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """The world of two ranks started, the JAX references computed while
    it works: ``(JAX references, rank 0's results)``."""
    jcfg, tcfg = _cfgs()
    jp = init_llava_params(jax.random.PRNGKey(2), jcfg)
    jmoe = JaxLlavaConfig.tiny_debug(moe=GATE_MOE)
    tmoe = LlavaConfig.tiny_debug(moe=GATE_MOE)
    jmoe_p = init_llava_params(jax.random.PRNGKey(3), jmoe)
    ids, valid, pos = _chunk_rows()
    px = np.random.default_rng(1).standard_normal(
        (1, 3, 56, 56)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("placed_generate")
    torch.save({"params": bridge(jp, tcfg), "cfg": tcfg, "scale": SCALE,
                "beam_ids": BEAM_IDS, "spec_ids": SPEC_IDS, "px": px,
                "chunk_ids": torch.as_tensor(ids).long(),
                "chunk_pos": torch.as_tensor(pos),
                "chunk_valid": torch.as_tensor(valid), "cap": CHUNK_CAP,
                "chunk": CHUNK_S // 2, "moe_params": bridge(jmoe_p, tmoe),
                "moe_cfg": tmoe, "crc": _CRC, "image": _image(),
                "ll_rows": LL_ROWS}, tmp / "job.pt")
    procs = start_ranks(_RANK, tmp, 2)
    try:
        refs = _jax_refs(jcfg, jp, jmoe, jmoe_p)
    finally:
        wait_ranks(procs)
    return refs, torch.load(tmp / "results.pt", weights_only=False)


@pytest.mark.parametrize("mode", ["beam", "spec", "model_beam"])
def test_generation_modes_on_placed_weights_equal_jax(placed, mode):
    refs, got = placed
    want = refs["spec" if mode == "spec" else "beam"]
    got = np.asarray(got[mode])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_chunked_prefill_on_placed_weights_equals_jax(placed):
    refs, got = placed
    # the rank's cache holds its half of the KV heads
    assert got["heads"] == LlavaConfig.tiny_debug().llama.num_key_value_heads \
        // 2
    np.testing.assert_allclose(got["chunked"].numpy(), refs["chunked"],
                               atol=1e-5, rtol=0)


def test_gating_probs_on_placed_weights_equal_jax(placed):
    refs, got = placed
    np.testing.assert_allclose(got["gate"].numpy(), refs["gate"], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("row", range(len(LL_ROWS)))
def test_loglikelihood_on_placed_weights_equals_jax(placed, row):
    """The adapter's ``loglikelihood`` reads the placed model through the
    rank's view: the logits it scores, its log-probability and greedy
    flag, against the JAX adapter on JAX-placed weights."""
    refs, got = placed
    np.testing.assert_allclose(got["ll_logits"][row].numpy(),
                               refs["ll_logits"][row], atol=1e-5, rtol=0)
    (lp, greedy), (want_lp, want_greedy) = got["ll"][row], refs["ll"][row]
    assert greedy == want_greedy
    np.testing.assert_allclose(lp, want_lp, rtol=1e-5)
    assert np.isfinite(lp) and lp < 0
