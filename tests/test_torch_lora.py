"""PyTorch port: LoRA leaves (``ops/lora.py``, the LoRA branch of
``dequantize_array`` and of ``proj``) against the JAX package.  The JAX
adapters are bridged with ``params_from_jax`` (A is random on both sides,
from different generators), B is set from numpy so that the adapters act.
Float32; merged weights and projections within ``1e-5``, a forward through
the decoder within ``1e-4``; over a quantized base the JAX package rounds
the merged delta to the base's bf16 and the port adds it in f32, so those
compare at ``2e-2`` of max|y|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.models import llama as jl
from matryoshka_mm_tpu.models.builder import maybe_quantize
from matryoshka_mm_tpu.ops import lora as jlora
from matryoshka_mm_tpu.ops.quant import dequantize_array as jdequant
from matryoshka_mm_torch.models import llama as tl
from matryoshka_mm_torch.ops import lora as tlora
from matryoshka_mm_torch.ops import quant as tq
from matryoshka_mm_torch.train.optimizer import named_leaves
from tests.test_torch_train_step import bridge, make_pair

R, ALPHA = 4, 8.0


def _with_b(jparams, seed=0):
    """The JAX tree with every lora_b drawn from numpy (B = 0 would leave
    the adapters without effect)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if str(getattr(path[-1], "key", "")) == "lora_b":
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.05,
                               leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, jparams)


@pytest.fixture(scope="module", params=["plain", "int8", "int4"])
def lora_pair(request):
    jcfg, jparams, tcfg, _ = make_pair()
    if request.param != "plain":
        jparams = maybe_quantize(dict(jparams),
                                 load_8bit=request.param == "int8",
                                 load_4bit=request.param == "int4",
                                 fuse=False)
    jparams = _with_b(jlora.add_lora(jparams, jax.random.PRNGKey(1), r=R,
                                     alpha=ALPHA))
    return request.param, jcfg, jparams, tcfg, bridge(jparams, tcfg)


def test_bridge_keeps_lora_leaves(lora_pair):
    kind, _, jparams, tcfg, tparams = lora_pair
    leaf = tparams["llama"]["layers"][1]["self_attn"]["q_proj"]
    assert tlora.is_lora(leaf) and set(leaf) == {"w", "lora_a", "lora_b",
                                                 "lora_scale"}
    jleaf = jparams["llama"]["layers"]["self_attn"]["q_proj"]
    np.testing.assert_array_equal(leaf["lora_a"].numpy(),
                                  np.asarray(jleaf["lora_a"][1]))
    assert leaf["lora_b"].shape == (64, R) and leaf["lora_a"].shape == (R, 64)
    assert float(leaf["lora_scale"]) == ALPHA / R
    assert tq.is_quantized(leaf["w"]) == (kind != "plain")
    assert tlora.count_lora_params(tparams) == \
        jlora.count_lora_params(jparams)


def test_merged_weight_and_projection(lora_pair):
    kind, _, jparams, _, tparams = lora_pair
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    tol = dict(rtol=0, atol=1e-5) if kind == "plain" else None
    for name in ("q_proj", "o_proj"):
        tleaf = tparams["llama"]["layers"][1]["self_attn"][name]
        jleaf = jax.tree.map(lambda a: a[1],
                             jparams["llama"]["layers"]["self_attn"][name])
        want_w = np.asarray(jdequant(jleaf, jnp.float32), np.float32)
        got_w = tq.dequantize_array(tleaf, torch.float32)
        np.testing.assert_allclose(got_w.detach().numpy(), want_w,
                                   atol=1e-5 if kind == "plain" else 2e-3)
        want_y = np.asarray(jl.proj(jnp.asarray(x), jleaf), np.float32)
        got_y = tl.proj(torch.from_numpy(x), tleaf).detach().numpy()
        np.testing.assert_allclose(
            got_y, want_y, **(tol or dict(rtol=0,
                                          atol=2e-2 * np.abs(want_y).max())))


def test_gradients_reach_the_adapters_only(lora_pair):
    _, _, _, _, tparams = lora_pair
    leaf = tparams["llama"]["layers"][0]["mlp"]["down_proj"]
    for t in (leaf["lora_a"], leaf["lora_b"]):
        t.requires_grad_()
    x = torch.randn(3, 128)
    for y in (tl.proj(x, leaf), x @ tq.dequantize_array(leaf,
                                                        torch.float32).T):
        ga, gb = torch.autograd.grad(y.square().sum(), (leaf["lora_a"],
                                                        leaf["lora_b"]))
        assert bool(ga.any()) and bool(gb.any())
    merged = tq.dequantize_array(leaf, torch.float32)
    torch.testing.assert_close(tl.proj(x, leaf), x @ merged.T, rtol=1e-4,
                               atol=1e-5 if not tq.is_quantized(leaf["w"])
                               else 2e-2)
    for t in (leaf["lora_a"], leaf["lora_b"]):
        t.requires_grad_(False)


def test_decoder_forward_matches_jax(lora_pair):
    kind, jcfg, jparams, tcfg, tparams = lora_pair
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((2, 10, 64)).astype(np.float32)
    pos = np.tile(np.arange(10, dtype=np.int32), (2, 1))
    want, _ = jl.llama_forward(jparams["llama"], jcfg.llama, jnp.asarray(emb),
                               position_ids=jnp.asarray(pos))
    with torch.no_grad():
        got, _ = tl.llama_forward(tparams["llama"], tcfg.llama,
                                  torch.from_numpy(emb),
                                  position_ids=torch.from_numpy(pos))
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0,
        atol=1e-4 if kind == "plain" else 2e-2 * np.abs(want).max())


def test_add_lora_targets_and_init():
    _, jparams, tcfg, tparams = make_pair()
    jwrapped = jlora.add_lora(jparams, jax.random.PRNGKey(0), r=R,
                              alpha=ALPHA)
    wrapped = tlora.add_lora(tparams, torch.Generator().manual_seed(0), r=R,
                             alpha=ALPHA)
    tpaths = {p.replace("/0/", "/") for p, _ in named_leaves(wrapped)
              if p.endswith("lora_a") and "/0/" in p}
    jpaths = {"/".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_leaves_with_path(jwrapped)
              if str(path[-1].key) == "lora_a"}
    assert tpaths == jpaths and len(tpaths) == 7
    leaf = wrapped["llama"]["layers"][0]["mlp"]["gate_proj"]
    assert not bool(leaf["lora_b"].any())
    # he-uniform over the `in` axis: U(-sqrt(6 / in), sqrt(6 / in))
    a, bound = leaf["lora_a"], (6.0 / 64) ** 0.5
    assert float(a.abs().max()) <= bound and float(a.abs().max()) > 0.8 * bound
    ja = np.asarray(jwrapped["llama"]["layers"]["mlp"]["gate_proj"]["lora_a"])
    assert np.abs(ja).max() <= bound
    np.testing.assert_allclose(float(a.std()), ja.std(), rtol=0.25)
    assert leaf["w"] is tparams["llama"]["layers"][0]["mlp"]["gate_proj"]
    assert "lora_a" not in str(wrapped["vision_tower"]) \
        and not tlora.is_lora(wrapped["llama"]["lm_head"])
    with pytest.raises(ValueError, match="rank"):
        tlora.add_lora(tparams, torch.Generator(), r=0)
    with pytest.raises(ValueError, match="no leaves matched"):
        tlora.add_lora(tparams, torch.Generator(), target="nothing$")


def test_merge_strip_extract_load_round_trip(lora_pair):
    kind, _, jparams, tcfg, tparams = lora_pair
    merged = tlora.merge_lora_weights(tparams)
    jmerged = bridge(jlora.merge_lora_weights(jparams), tcfg)
    for (p, got), (_, want) in zip(named_leaves(merged["llama"]),
                                   named_leaves(jmerged["llama"])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=p,
                                   atol=1e-5 if kind == "plain" else 2e-3)
    assert not [p for p, _ in named_leaves(merged) if "lora" in p]
    base = tlora.strip_lora(tparams)
    assert not [p for p, _ in named_leaves(base) if "lora" in p]
    adapters = tlora.extract_lora(tparams)
    assert set(adapters) == {"llama"}
    assert {p.rsplit("/", 1)[-1] for p, _ in named_leaves(adapters)} == \
        {"lora_a", "lora_b", "lora_scale"}
    again = tlora.load_lora(base, adapters)
    loaded, original = dict(named_leaves(again)), dict(named_leaves(tparams))
    assert set(loaded) == set(original)
    assert all(loaded[p] is original[p] for p in original)
    assert tlora.extract_lora(base) == {}
