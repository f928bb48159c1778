"""PyTorch port: the Mistral and MPT families through ``generate`` and its
modes, the dense and paged ``ContinuousBatcher`` (prefix cache and
speculative rounds included) and a LoRA train step, against the JAX
package on a tiny LLaVA (float32, CPU), the JAX weights carried across by
``params_from_jax``.

Mistral here has GQA 4/2 and a window of 6 slots, and every request decodes
well past it (prompt of 9 + 4 visual tokens, 12 new), so the window decides
the tokens; MPT attends with its alibi bias.  Greedy tokens must be
IDENTICAL to the JAX package's, in float32, in bfloat16 and under
``load_4bit`` (whose trees dequantize on both sides, as the JAX package
does off the TPU).  The train step's losses and
metrics within ``1e-4`` relative of the JAX trainer's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGenConfig,
                                        beam_generate as jax_beam,
                                        chunked_prefill as jax_chunked,
                                        generate as jax_generate,
                                        speculative_generate as jax_spec)
from matryoshka_mm_tpu.models.builder import maybe_quantize
from matryoshka_mm_tpu.models.llama import (LlamaConfig as JaxLlamaConfig,
                                            embed_tokens as jax_embed)
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.ops import lora as jlora
from matryoshka_mm_tpu.train import optimizer as jopt
from matryoshka_mm_tpu.train import trainer as jtrainer
from matryoshka_mm_torch.config import LlamaConfig, LlavaConfig
from matryoshka_mm_torch.generate import (GenerationConfig, beam_generate,
                                          chunked_prefill, generate,
                                          speculative_generate,
                                          stream_generate)
from matryoshka_mm_torch.models.convert import params_from_jax
from matryoshka_mm_torch.models.llama import embed_tokens
from matryoshka_mm_torch.ops import lora as tlora
from matryoshka_mm_torch.serve import paged_cache as tpc
from matryoshka_mm_torch.serve.batching import ContinuousBatcher
from matryoshka_mm_torch.train import optimizer as topt
from matryoshka_mm_torch.train import trainer as ttrainer
from tests.test_torch_train_step import (assert_metrics_close, bridge,
                                         jax_batch, make_batch, make_pair,
                                         torch_batch)

SPEC = "ver=v0_numtoks=4"
DECODER = {"mistral": dict(arch="mistral", num_key_value_heads=2,
                           sliding_window=6),
           "mpt": dict(arch="mpt")}
FAMILIES = sorted(DECODER)
GEN = dict(max_new_tokens=12, decode_chunk=3, eos_token_id=-1)


def _configs(family, **kw):
    kw = dict(DECODER[family], **kw)
    jcfg = dataclasses.replace(JaxLlavaConfig.tiny_debug(),
                               llama=JaxLlamaConfig.tiny_debug(**kw))
    tcfg = dataclasses.replace(LlavaConfig.tiny_debug(),
                               llama=LlamaConfig.tiny_debug(**kw))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(name, kind -> (JAX config, port config, JAX params, bridged)):
    ``float`` (the tiny config's float32), ``bf16`` (the same widths in
    bfloat16) and ``int4`` (the float32 tree under ``load_4bit``)."""
    kinds = {}
    for kind, kw in (("float", {}), ("bf16", dict(dtype="bfloat16"))):
        jcfg, tcfg = _configs(request.param, **kw)
        jp = init_llava_params(jax.random.PRNGKey(3), jcfg)
        kinds[kind] = (jcfg, tcfg, jp)
    jcfg, tcfg, jp = kinds["float"]
    kinds["int4"] = (jcfg, tcfg, maybe_quantize(
        jax.tree.map(lambda a: a, jp), load_8bit=False, load_4bit=True))
    return request.param, {
        k: (jc, tc, p, params_from_jax(jax.tree.map(np.asarray, p), tc,
                                       device="cpu"))
        for k, (jc, tc, p) in kinds.items()}


def _inputs(seed=0, extra=4):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.array([[5, 17, IMAGE_TOKEN_INDEX, 42, 9]]),
                          rng.integers(10, 100, (1, extra))], 1)
    return (ids.astype(np.int32),
            rng.standard_normal((1, 3, 56, 56)).astype(np.float32))


def _jax_tokens(family, ids, px, kind="float"):
    jcfg, _, jp, _ = family[1][kind]
    return np.asarray(jax_generate(
        jp, jcfg, ids, px, matryoshka_vis_token_scale=SPEC,
        gen_cfg=JaxGenConfig(**GEN)))[0]


@pytest.mark.parametrize("kind", ["float", "bf16", "int4"])
def test_generate_equals_jax(family, kind):
    name, kinds = family
    _, tcfg, _, tp = kinds[kind]
    ids, px = _inputs()
    want = _jax_tokens(family, ids, px, kind)
    got = generate(tp, tcfg, ids, px, matryoshka_vis_token_scale=SPEC,
                   gen_cfg=GenerationConfig(**GEN))
    np.testing.assert_array_equal(got[0], want)
    if name == "mistral" and kind == "float":
        # the window decides the tokens
        wide = dataclasses.replace(tcfg, llama=dataclasses.replace(
            tcfg.llama, sliding_window=0))
        assert not np.array_equal(generate(
            tp, wide, ids, px, matryoshka_vis_token_scale=SPEC,
            gen_cfg=GenerationConfig(**GEN))[0], want)
    # the stream's last yield holds the same tokens
    *_, last = stream_generate(tp, tcfg, ids, px,
                               matryoshka_vis_token_scale=SPEC,
                               gen_cfg=GenerationConfig(**GEN))
    np.testing.assert_array_equal(np.asarray(last)[0], want)


def test_beam_and_speculative_equal_jax(family):
    """Three beams, and prompt-lookup speculation (k = 3) on a prompt whose
    text repeats."""
    jcfg, tcfg, jp, tp = family[1]["float"]
    ids, px = _inputs(1)
    gen = dict(max_new_tokens=8, eos_token_id=2)
    want = np.asarray(jax_beam(jp, jcfg, ids, px, num_beams=3,
                               matryoshka_vis_token_scale=SPEC,
                               gen_cfg=JaxGenConfig(**gen)))
    got = beam_generate(tp, tcfg, ids, px, num_beams=3,
                        matryoshka_vis_token_scale=SPEC,
                        gen_cfg=GenerationConfig(**gen))
    np.testing.assert_array_equal(got, want)
    ids = np.concatenate([ids, ids[:, 3:], ids[:, 3:]], 1)
    gen = dict(max_new_tokens=10, eos_token_id=-1)
    want = np.asarray(jax_spec(jp, jcfg, ids, px, k=3,
                               matryoshka_vis_token_scale=SPEC,
                               gen_cfg=JaxGenConfig(**gen)))
    got = speculative_generate(tp, tcfg, ids, px, k=3,
                               matryoshka_vis_token_scale=SPEC,
                               gen_cfg=GenerationConfig(**gen))
    np.testing.assert_array_equal(got, want)


def _serve(batcher, requests):
    batcher._hold_admission = True
    reqs = [batcher.submit(ids, px, numtoks=4, max_new_tokens=12)
            for ids, px in requests]
    batcher._hold_admission = False
    return [np.concatenate(list(batcher.stream(r))) for r in reqs]


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_batcher_equals_jax_generate(family, backend):
    """A burst of two requests (one grouped admission) and a third alone,
    each decoding 12 tokens: the streams are JAX ``generate``'s tokens.  The
    paged backend of either family takes the gather path."""
    _, tcfg, _, tp = family[1]["float"]
    requests = [_inputs(s, extra=3 + s) for s in range(3)]
    b = ContinuousBatcher(tp, tcfg, max_batch=2,
                          prefill_len=64, max_new_tokens=16, chunk=3,
                          gen_cfg=GenerationConfig(**GEN), backend=backend,
                          page_size=16)
    try:
        if backend == "paged":
            assert b.use_kernel is False
        got = _serve(b, requests[:2]) + _serve(b, requests[2:])
    finally:
        b.shutdown()
    for (ids, px), toks in zip(requests, got):
        np.testing.assert_array_equal(toks, _jax_tokens(family, ids, px))


def test_paged_prefix_cache_and_speculative_rounds(family):
    """A repeated prompt hits its cached pages and decodes ``generate``'s
    tokens; a speculative batcher (k = 2) emits them too."""
    _, tcfg, _, tp = family[1]["float"]
    ids, px = _inputs(5, extra=20)
    want = _jax_tokens(family, ids, px)
    for kw in (dict(prefix_cache=True), dict(speculative_k=2)):
        b = ContinuousBatcher(tp, tcfg, max_batch=2,
                              prefill_len=64, max_new_tokens=16, chunk=3,
                              gen_cfg=GenerationConfig(**GEN),
                              backend="paged", page_size=16, **kw)
        try:
            for _ in range(2):
                np.testing.assert_array_equal(_serve(b, [(ids, px)])[0],
                                              want)
            if kw.get("prefix_cache"):
                assert b.stats["prefix_hits"] == 1
            else:
                assert b.spec_stats["verify_steps"] > 0
        finally:
            b.shutdown()


def test_int4_batcher_equals_jax_generate(family):
    _, tcfg, _, tp = family[1]["int4"]
    ids, px = _inputs(7)
    b = ContinuousBatcher(tp, tcfg, max_batch=2,
                          prefill_len=64, max_new_tokens=16, chunk=3,
                          gen_cfg=GenerationConfig(**GEN), backend="paged",
                          page_size=16)
    try:
        got = _serve(b, [(ids, px)])[0]
    finally:
        b.shutdown()
    np.testing.assert_array_equal(got, _jax_tokens(family, ids, px, "int4"))


def test_chunked_prefill_of_a_window_equals_jax():
    """Two chunks of 64 against a 144-slot cache with a window of 40, one
    row left-padded: the port's flash plain version masks the window by
    index at ``q_index_offset``, the JAX reference by position."""
    jcfg, tcfg = _configs("mistral", sliding_window=40,
                          num_attention_heads=2)
    jp = init_llava_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    B, S, cap = 2, 128, 144
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 100, (B, S)).astype(np.int32)
    valid = np.ones((B, S), bool)
    valid[1, :21] = False
    pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    jlogits, _ = jax_chunked(jp, jcfg, jax_embed(jp["llama"], ids),
                             pos, valid, cap, chunk=64)
    got, _ = chunked_prefill(tp, tcfg, embed_tokens(tp["llama"],
                                                    torch.as_tensor(ids)),
                             torch.as_tensor(pos), torch.as_tensor(valid),
                             cap, chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("kernel", [None, True, False])
@pytest.mark.parametrize("name", ["llama", "mistral", "mpt", "window"])
def test_paged_kernel_rule(name, kernel):
    """The JAX dispatch rule: a window config and MPT take the gather path
    on the card; an explicit ``use_kernel=True`` for them raises."""
    cfg = LlamaConfig.tiny_debug(**{"llama": {}, "window": dict(
        sliding_window=8)}.get(name, DECODER.get(name, {})))
    fits = name == "llama"
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    if kernel is None:
        assert tpc._resolve_use_kernel(None, cfg, cuda) is fits
        assert tpc._resolve_use_kernel(None, cfg, cpu) is False
    elif kernel and not fits:
        with pytest.raises(ValueError, match="gather path"):
            tpc._resolve_use_kernel(True, cfg, cuda)
    else:
        assert tpc._resolve_use_kernel(kernel, cfg, cuda) is kernel


def test_mistral_lora_train_steps_equal_jax():
    """Two LoRA steps of the M3 trainer on a Mistral decoder (GQA 4/2,
    window 8 under a 24-token batch, remat) against the JAX trainer."""
    jcfg, jparams, tcfg, _ = make_pair(remat=True, arch="mistral",
                                       num_key_value_heads=2,
                                       sliding_window=8)
    jparams = jlora.add_lora(jparams, jax.random.PRNGKey(1), r=4, alpha=8.0)
    tparams = bridge(jparams, tcfg)
    kw = dict(learning_rate=1e-3, warmup_ratio=0.0, total_steps=10,
              lora_enable=True)
    batch = make_batch(seed=7)
    jstate, jtx = jtrainer.create_train_state(jparams,
                                              jopt.OptimizerConfig(**kw))
    jstep = jtrainer.make_train_step(jcfg, jtx, donate=False,
                                     frozen_vision=True)
    tstate, ttx = ttrainer.create_train_state(tparams,
                                              topt.OptimizerConfig(**kw))
    tstep = ttrainer.make_train_step(tcfg, ttx, frozen_vision=True)
    for _ in range(2):
        jstate, jm = jstep(jstate, jax_batch(batch))
        tstate, tm = tstep(tstate, torch_batch(batch))
        tm = ttrainer.host_metrics(tm)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)
        assert_metrics_close(
            {k: v for k, v in tm.items() if k != "grad_norm"},
            {k: v for k, v in dict(jm).items() if k != "grad_norm"})
    leaves = dict(topt.named_leaves(tparams))
    assert bool(leaves["llama/layers/0/self_attn/k_proj/lora_b"].any())


def test_mpt_add_lora_raises_as_jax():
    """The default LoRA target names LLaMA's ``self_attn`` / ``mlp``
    projections; no MPT leaf matches, so both packages refuse."""
    jcfg, tcfg = _configs("mpt")
    jp = init_llava_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    with pytest.raises(ValueError, match="no leaves matched") as jerr:
        jlora.add_lora(jp, jax.random.PRNGKey(1), r=4, alpha=8.0)
    with pytest.raises(ValueError, match="no leaves matched") as terr:
        tlora.add_lora(tp, torch.Generator().manual_seed(1), r=4, alpha=8.0)
    assert str(terr.value) == str(jerr.value)
