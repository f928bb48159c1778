"""PyTorch port: the Mistral (GQA + sliding window) and MPT (alibi) decoder
families against the JAX package and against random-init HF
``transformers`` models, float32 on the CPU.

Tolerances: logits against the JAX package ``1e-4`` (the same f32 function
with sums in another order), against HF ``3e-4`` (as
``tests/test_model_families.py`` holds the JAX package), alibi slopes
``1e-5`` relative, the MPT cache decode against the full forward ``2e-4``;
the MPT int8-KV forward against the JAX package's ``1e-4`` and against the
float cache ``0.05`` (the JAX test's bound).  Quantized trees are held bit
for bit against the JAX quantizer's bridged leaves."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from matryoshka_mm_tpu.models import llama as jl
from matryoshka_mm_tpu.models.builder import maybe_quantize
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_torch.config import LlamaConfig, LlavaConfig
from matryoshka_mm_torch.models import llama as tl
from matryoshka_mm_torch.models.convert import (convert_llama, convert_mpt,
                                                init_params, params_from_jax)
from matryoshka_mm_torch.ops.quant import Q4KEY, QKEY, quantize_llama_params
from matryoshka_mm_torch.train.optimizer import named_leaves

# the JAX test's tiny shapes: Mistral with GQA 4/2 and a window of 8 under a
# 12-token prompt, MPT with 4 heads
FAMILIES = {
    "mistral": dict(arch="mistral", vocab_size=128, hidden_size=32,
                    intermediate_size=64, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2,
                    max_position_embeddings=64, sliding_window=8,
                    rope_theta=10000.0, rms_norm_eps=1e-6, dtype="float32"),
    "mpt": dict(arch="mpt", vocab_size=128, hidden_size=32,
                intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=4,
                max_position_embeddings=64, tie_word_embeddings=True,
                dtype="float32"),
}
IDS = np.array([[3, 14, 15, 92, 65, 35, 89, 79, 32, 38, 46, 26]], np.int64)


def _pair(family, seed=0, **kw):
    """(JAX config, JAX decoder params, port config, bridged params)."""
    jcfg = jl.LlamaConfig(**dict(FAMILIES[family], **kw))
    tcfg = LlamaConfig(**dict(FAMILIES[family], **kw))
    jp = init_llava_params(jax.random.PRNGKey(seed), dataclasses.replace(
        JaxLlavaConfig.tiny_debug(), llama=jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dataclasses.replace(
        LlavaConfig.tiny_debug(), llama=tcfg), device="cpu")
    return jcfg, jp["llama"], tcfg, tp["llama"]


def _logits(tp, tcfg, ids):
    ids = torch.as_tensor(ids)
    pos = torch.arange(ids.shape[1])[None].expand(ids.shape[0], -1)
    h, _ = tl.llama_forward(tp, tcfg, tl.embed_tokens(tp, ids),
                            position_ids=pos)
    return tl.lm_head(tp, h)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_jax(family):
    """A 12-token prompt: Mistral's window of 8 bites on the last four
    positions, through the flash kernel's plain version (window by index)
    on the port's side and the JAX reference attention (by position)."""
    jcfg, jp, tcfg, tp = _pair(family)
    want = np.asarray(jl.llama_logits(jp, jcfg, jnp.asarray(IDS, jnp.int32)))
    got = _logits(tp, tcfg, IDS)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    if family == "mistral":
        # the window decides the last positions' logits
        wide = _logits(tp, dataclasses.replace(tcfg, sliding_window=0), IDS)
        np.testing.assert_allclose(wide[:, :8].numpy(), want[:, :8],
                                   atol=1e-4)
        assert float((wide[:, 8:] - got[:, 8:]).abs().max()) > 1e-3


def _hf(family):
    torch.manual_seed(0)
    f = FAMILIES[family]
    if family == "mistral":
        hf = transformers.MistralForCausalLM(transformers.MistralConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64, sliding_window=8, rope_theta=10000.0,
            attn_implementation="eager"))
        return hf.eval(), convert_llama(hf.state_dict(), LlamaConfig(**f),
                                        device="cpu")
    hf = transformers.MptForCausalLM(transformers.MptConfig(
        vocab_size=128, d_model=32, n_heads=4, n_layers=2, expansion_ratio=2,
        max_seq_len=64, no_bias=True,
        attn_config=transformers.models.mpt.configuration_mpt
        .MptAttentionConfig(attn_impl="torch", alibi=True,
                            alibi_bias_max=8)))
    # HF MPT's MLP is 4 * d_model wide whatever expansion_ratio says (the
    # JAX test's converter does not check the width)
    return hf.eval(), convert_mpt(hf.state_dict(), LlamaConfig(
        **dict(f, intermediate_size=128)), device="cpu")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_hf(family):
    hf, tp = _hf(family)
    if family == "mistral":
        assert "lm_head" in tp
    else:
        assert set(tp) == {"embed_tokens", "layers", "norm"}
    ids = IDS if family == "mistral" else IDS[:, :8]
    with torch.no_grad():
        want = hf(torch.as_tensor(ids)).logits
    got = _logits(tp, LlamaConfig(**FAMILIES[family]), ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-4, rtol=0)


@pytest.mark.parametrize("heads", [4, 6, 8])
def test_alibi_slopes_match_hf(heads):
    from transformers.models.mpt.modeling_mpt import build_mpt_alibi_tensor

    t = build_mpt_alibi_tensor(heads, 2)      # -slope * (S - 1 - j)
    want = (t[:, 0, 1] - t[:, 0, 0]).numpy()
    got = tl.alibi_slopes(heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jl.alibi_slopes(heads)))


def test_layer_norm_nobias_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 32)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    got = tl.layer_norm_nobias(torch.from_numpy(x), torch.from_numpy(w))
    want = jl.layer_norm_nobias(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cache_decode_matches_the_full_forward(family):
    """Prefill 9 tokens into a cache, then decode three one at a time: each
    step's logits equal the full forward's at that position (Mistral's
    decode kernel plain version takes the window by position)."""
    _, _, tcfg, tp = _pair(family, seed=1)
    full = _logits(tp, tcfg, IDS)
    cache = tl.init_kv_cache(tcfg, 1, 16, device="cpu")
    ids = torch.as_tensor(IDS)
    h, cache = tl.llama_forward(tp, tcfg, tl.embed_tokens(tp, ids[:, :9]),
                                position_ids=torch.arange(9)[None],
                                cache=cache)
    np.testing.assert_allclose(tl.lm_head(tp, h)[0, -1].numpy(),
                               full[0, 8].numpy(), atol=2e-4)
    for i in range(9, 12):
        h, cache = tl.llama_forward(tp, tcfg,
                                    tl.embed_tokens(tp, ids[:, i:i + 1]),
                                    position_ids=torch.full((1, 1), i),
                                    cache=cache)
        np.testing.assert_allclose(tl.lm_head(tp, h)[0, -1].numpy(),
                                   full[0, i].numpy(), atol=2e-4)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_int8_kv_matches_jax(family):
    """The JAX ``test_mpt_int8_kv_matches_bf16`` for both families: 6 slots
    prefilled into an int8 cache, quantized per slot (codes beyond a raw
    cast), the hidden states equal to JAX's and near the float cache's."""
    jcfg, jp, tcfg, tp = _pair(family)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 6, tcfg.hidden_size)).astype(np.float32)
    pos = np.arange(6)[None].astype(np.int32)
    outs = {}
    for kv in ("", "int8"):
        jc = dataclasses.replace(jcfg, kv_cache_dtype=kv)
        tc = dataclasses.replace(tcfg, kv_cache_dtype=kv)
        jh, jcache = jl.llama_forward(
            jp, jc, jnp.asarray(x), position_ids=jnp.asarray(pos),
            attn_valid=jnp.ones((1, 6), bool),
            cache=jl.init_kv_cache(jc, 1, 16))
        cache = tl.init_kv_cache(tc, 1, 16, device="cpu")
        th, cache = tl.llama_forward(tp, tc, torch.from_numpy(x),
                                     position_ids=torch.from_numpy(pos),
                                     cache=cache)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
        outs[kv] = th
        if kv:
            assert cache.k.dtype == torch.int8
            np.testing.assert_array_equal(cache.k.numpy(),
                                          np.asarray(jcache.k))
            assert int(cache.k[:, :, :6].abs().max()) > 8
    assert float((outs["int8"] - outs[""]).abs().max()) < 0.05


def _jax_quantized(family, bits):
    """The JAX ``maybe_quantize`` of a tiny LLaVA of ``family``, and the
    same float tree on the port's side."""
    jcfg = JaxLlavaConfig.tiny_debug()
    jcfg = dataclasses.replace(jcfg, llama=jl.LlamaConfig.tiny_debug(
        arch=family, **({"num_key_value_heads": 2, "sliding_window": 8}
                        if family == "mistral" else {})))
    tcfg = dataclasses.replace(LlavaConfig.tiny_debug(), llama=LlamaConfig(
        **{f.name: getattr(jcfg.llama, f.name)
           for f in dataclasses.fields(LlamaConfig)}))
    jp = init_llava_params(jax.random.PRNGKey(2), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jq = maybe_quantize(jax.tree.map(lambda a: a, jp), load_8bit=bits == 8,
                        load_4bit=bits == 4)
    return tcfg, tp, params_from_jax(jax.tree.map(np.asarray, jq), tcfg,
                                     device="cpu")


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_tree_equals_jax(family, bits):
    """``quantize_llama_params`` gives the JAX quantizer's leaves bit for
    bit: Mistral's q/k/v and gate/up fused, MPT's four projections plain
    leaves and its embedding table (its head) in the model dtype."""
    tcfg, tp, want = _jax_quantized(family, bits)
    got = quantize_llama_params(tp, bits)["llama"]
    key = Q4KEY if bits == 4 else QKEY
    layer = got["layers"][0]
    if family == "mpt":
        assert set(layer["attn"]) == {"Wqkv", "out_proj"}
        assert set(layer["ffn"]) == {"up_proj", "down_proj"}
        assert key in layer["attn"]["Wqkv"] and key in layer["ffn"]["up_proj"]
        assert "lm_head" not in got
        assert got["embed_tokens"].dtype == torch.float32
    else:
        assert set(layer["self_attn"]) == {"qkv_proj", "o_proj"}
        assert set(layer["mlp"]) == {"gateup_proj", "down_proj"}
    have, ref = dict(named_leaves(got)), dict(named_leaves(want["llama"]))
    assert set(have) == set(ref)
    for path, t in have.items():
        assert t.dtype == ref[path].dtype, path
        assert torch.equal(t, ref[path]), path


def test_init_params_builds_the_jax_trees():
    """``init_params`` of each family has the JAX ``init_llava_params``'s
    decoder leaves, shapes and dtypes (no ``lm_head`` for MPT)."""
    for family in FAMILIES:
        jcfg = dataclasses.replace(JaxLlavaConfig.tiny_debug(),
                                   llama=jl.LlamaConfig.tiny_debug(
                                       arch=family))
        tcfg = dataclasses.replace(LlavaConfig.tiny_debug(),
                                   llama=LlamaConfig.tiny_debug(arch=family))
        want = params_from_jax(
            jax.tree.map(np.asarray, init_llava_params(
                jax.random.PRNGKey(0), jcfg)), tcfg, device="cpu")["llama"]
        got = init_params(tcfg, device="cpu")["llama"]
        shapes = {p: (tuple(t.shape), t.dtype) for p, t in named_leaves(got)}
        assert shapes == {p: (tuple(t.shape), t.dtype)
                          for p, t in named_leaves(want)}, family


def test_presets_are_the_jax_presets():
    for name in ("mistral_7b", "mpt_7b", "vicuna_7b"):
        want = getattr(jl.LlamaConfig, name)()
        got = getattr(LlamaConfig, name)()
        for f in dataclasses.fields(LlamaConfig):
            assert getattr(got, f.name) == getattr(want, f.name), (name,
                                                                    f.name)
    with pytest.raises(ValueError, match="arch"):
        LlamaConfig(arch="gpt2")
