"""PyTorch port, the slice as a whole on the tiny config: the port's
``generate`` gives the same greedy tokens as the JAX ``generate`` on the
same (bridged) weights, and ``load_pretrained_model`` + ``eval_model`` run
end to end on the CPU."""

import numpy as np
import jax
import pytest
import torch

from matryoshka_mm_tpu.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGenConfig,
                                        generate as jax_generate)
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.generate import GenerationConfig, generate
from matryoshka_mm_torch.models.convert import params_from_jax


@pytest.fixture(scope="module")
def models():
    jcfg = JaxLlavaConfig.tiny_debug()
    jparams = init_llava_params(jax.random.PRNGKey(0), jcfg)
    tcfg = LlavaConfig.tiny_debug()
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg)


def _prompt(batch):
    rng = np.random.default_rng(batch)
    px = rng.standard_normal((batch, 3, 56, 56)).astype(np.float32)
    if batch == 1:
        ids = np.array([[1, 23, 57, IMAGE_TOKEN_INDEX, 88, 91, 14]], np.int32)
        return ids, px, None
    ids = np.array([[1, 23, 57, IMAGE_TOKEN_INDEX, 88, 91, 14],
                    [0, 0, 1, IMAGE_TOKEN_INDEX, 301, 77, 5]], np.int32)
    return ids, px, ids != 0


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("numtoks", [1, 4, 16])
def test_greedy_tokens_equal_jax(models, numtoks, batch):
    jcfg, jp, tcfg, tp = models
    ids, px, mask = _prompt(batch)
    spec = f"ver=v0_numtoks={numtoks}"
    kw = dict(max_new_tokens=8, decode_chunk=3, eos_token_id=-1)
    want = jax_generate(jp, jcfg, ids, px, attention_mask=mask,
                        matryoshka_vis_token_scale=spec,
                        gen_cfg=JaxGenConfig(**kw))
    got = generate(tp, tcfg, ids, px, attention_mask=mask,
                   matryoshka_vis_token_scale=spec,
                   gen_cfg=GenerationConfig(**kw))
    assert got.dtype == np.int32 and got.shape == (batch, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_eos_stops_at_chunk_boundary_like_jax(models):
    """Pick the 4th greedy token as EOS: both stop after the chunk that
    emitted it and pad from the EOS on; the output shapes agree."""
    jcfg, jp, tcfg, tp = models
    ids, px, _ = _prompt(1)
    spec = "ver=v0_numtoks=4"
    free = generate(tp, tcfg, ids, px, matryoshka_vis_token_scale=spec,
                    gen_cfg=GenerationConfig(max_new_tokens=12,
                                             decode_chunk=3,
                                             eos_token_id=-1))
    eos = int(free[0, 3])
    kw = dict(max_new_tokens=12, decode_chunk=3, eos_token_id=eos)
    want = np.asarray(jax_generate(jp, jcfg, ids, px,
                                   matryoshka_vis_token_scale=spec,
                                   gen_cfg=JaxGenConfig(**kw)))
    got = generate(tp, tcfg, ids, px, matryoshka_vis_token_scale=spec,
                   gen_cfg=GenerationConfig(**kw))
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] < 12


def test_text_only_and_full_scale_equal_jax(models):
    jcfg, jp, tcfg, tp = models
    ids = np.array([[1, 5, 17, 42, 9]], np.int32)
    kw = dict(max_new_tokens=5, decode_chunk=2, eos_token_id=-1)
    np.testing.assert_array_equal(
        generate(tp, tcfg, ids, gen_cfg=GenerationConfig(**kw)),
        np.asarray(jax_generate(jp, jcfg, ids, gen_cfg=JaxGenConfig(**kw))))
    ids, px, _ = _prompt(1)
    np.testing.assert_array_equal(
        generate(tp, tcfg, ids, px, gen_cfg=GenerationConfig(**kw)),
        np.asarray(jax_generate(jp, jcfg, ids, px,
                                gen_cfg=JaxGenConfig(**kw))))


def test_sampling_is_seeded_and_in_vocab(models):
    _, _, tcfg, tp = models
    ids, px, _ = _prompt(1)
    cfg = GenerationConfig(max_new_tokens=6, do_sample=True, temperature=0.8,
                           top_p=0.9, eos_token_id=-1)

    def run(seed):
        return generate(tp, tcfg, ids, px,
                        matryoshka_vis_token_scale="ver=v0_numtoks=4",
                        gen_cfg=cfg,
                        generator=torch.Generator().manual_seed(seed))

    a, b = run(1), run(1)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, 6) and a.min() >= 0 \
        and a.max() < tcfg.llama.vocab_size


@pytest.mark.parametrize("spec", ["ver=v2_numtoks=[1,4]_betas=[0.5,0.5]",
                                  "ver=v0_numtoks=gateprobargmax"])
def test_unported_modes_raise(models, spec):
    _, _, tcfg, tp = models
    ids, px, _ = _prompt(1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        generate(tp, tcfg, ids, px, matryoshka_vis_token_scale=spec)


def test_load_pretrained_and_eval_model_end_to_end(tmp_path, capsys):
    from PIL import Image

    from matryoshka_mm_torch.eval.run_llava import build_parser, eval_model
    from matryoshka_mm_torch.models.builder import load_pretrained_model

    img = np.random.default_rng(0).integers(0, 255, (80, 64, 3), np.uint8)
    path = tmp_path / "img.png"
    Image.fromarray(img).save(path)
    args = build_parser().parse_args([
        "--model-path", "debug://tiny", "--device", "cpu",
        "--image-file", str(path), "--query", "What is shown?",
        "--temperature", "0", "--max_new_tokens", "6",
        "--matryoshka_vis_token_scale", "ver=v0_numtoks=4"])
    out = eval_model(args)
    assert isinstance(out, str)
    assert capsys.readouterr().out.strip() == out
    _, model, _, ctx = load_pretrained_model("debug://tiny", device="cpu")
    assert ctx == 128
    assert model.params["llama"]["embed_tokens"].device.type == "cpu"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_pretrained_model(str(tmp_path), device="cpu", load_4bit=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_pretrained_model("debug://tiny", device="cpu", tp_size=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.generate(np.array([[1, 5]]), num_beams=2)
