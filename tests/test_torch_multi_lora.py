"""PyTorch port: multi-LoRA serving (``serve/multi_lora.py`` and the paged
batcher's ``adapters=``) against the JAX package on the tiny config.

Two rank-4 adapters are made by the JAX ``add_lora`` with seeded non-zero
``lora_b`` and bridged through ``params_from_jax`` + the port's
``extract_lora``.  Tolerances: the deltas float32 ``atol 1e-6`` against the
JAX ``lora_delta``; token streams IDENTICAL to JAX's ``generate`` on JAX's
``load_lora`` parameters (both float32 on the CPU).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGenConfig,
                                        generate as jax_generate)
from matryoshka_mm_tpu.models.builder import maybe_quantize
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.ops import lora as jlora
from matryoshka_mm_tpu.serve import multi_lora as jml
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.generate import GenerationConfig
from matryoshka_mm_torch.models.convert import params_from_jax
from matryoshka_mm_torch.ops import lora as tlora
from matryoshka_mm_torch.serve import multi_lora as tml
from matryoshka_mm_torch.serve.batching import ContinuousBatcher

R = 4
SPEC = "ver=v0_numtoks=4"
NAMES = (None, "alpha", "beta")


def _bridge(jtree, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                           device="cpu")


def _jax_adapter(jparams, i, r=R):
    """``add_lora`` with every lora_b drawn from a seed, so the adapter
    changes the model -> (wrapped JAX tree, JAX adapter tree)."""
    wrapped = jlora.add_lora(jparams, jax.random.PRNGKey(10 + i), r=r,
                             alpha=8.0)
    for mod in ("self_attn", "mlp"):
        for j, (proj, leaf) in enumerate(
                sorted(wrapped["llama"]["layers"][mod].items())):
            leaf["lora_b"] = 0.05 * jax.random.normal(
                jax.random.fold_in(jax.random.PRNGKey(20 + i),
                                   7 * j + len(mod)), leaf["lora_b"].shape)
    return wrapped, jlora.extract_lora(wrapped)


@pytest.fixture(scope="module")
def setup():
    """JAX and port configs, base parameters and adapters ``{name: tree}``
    (the port's trees by ``extract_lora`` of the bridged wrapped model)."""
    jcfg, tcfg = JaxLlavaConfig.tiny_debug(), LlavaConfig.tiny_debug()
    jparams = init_llava_params(jax.random.PRNGKey(0), jcfg)
    jad, tad = {}, {}
    for i, name in enumerate(NAMES[1:]):
        wrapped, jad[name] = _jax_adapter(jparams, i)
        tad[name] = tlora.extract_lora(_bridge(wrapped, tcfg))
    return jcfg, tcfg, jparams, _bridge(jparams, tcfg), jad, tad


def _gen(max_new=8):
    kw = dict(max_new_tokens=max_new, decode_chunk=2, eos_token_id=-1)
    return JaxGenConfig(**kw), GenerationConfig(**kw)


def _prompt(seed=0):
    rng = np.random.default_rng(seed)
    ids = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42, 9, 61, 7, 30]], np.int32)
    return ids, rng.standard_normal((1, 3, 56, 56)).astype(np.float32)


def _batcher(setup, params=None, **kw):
    _, tcfg, _, tparams, _, tad = setup
    kw = dict(dict(max_batch=3, prefill_len=64, max_new_tokens=16, chunk=2,
                   backend="paged", page_size=8, adapters=tad,
                   gen_cfg=_gen()[1]), **kw)
    return ContinuousBatcher(tparams if params is None else params, tcfg,
                             **kw)


def _collect(b, req):
    return np.concatenate(list(b.stream(req)))


def test_pack_adapters_shapes(setup):
    _, tcfg, _, _, _, tad = setup
    pack, names = tml.pack_adapters(tad)
    assert names == {None: 0, "alpha": 1, "beta": 2}
    L, D = tcfg.llama.num_hidden_layers, tcfg.llama.hidden_size
    assert pack.a["qkv"].shape == (L, 3, 2, R, D)
    assert pack.a["gateup"].shape == (L, 2, 2, R, D)
    q = ("self_attn", "q_proj")
    assert pack.b[q].shape == (L, D, 2, R) and pack.s[q].shape == (L, 2)
    A, B, S = pack.gather_form(1, q)
    assert A.shape == (3, R, D) and B.shape == (3, D, R)
    assert not A[0].any() and not B[0].any() and not S[0].any()  # the base
    leaf = tad["alpha"]["llama"]["layers"][1]["self_attn"]["q_proj"]
    torch.testing.assert_close(A[1], leaf["lora_a"], rtol=0, atol=0)
    torch.testing.assert_close(B[1], leaf["lora_b"], rtol=0, atol=1e-7)
    assert float(S[1]) == float(leaf["lora_scale"]) == 8.0 / R


def test_pack_rank_mismatch_rejected(setup):
    jcfg, tcfg, jparams, tparams, _, tad = setup
    bad = tlora.extract_lora(_bridge(
        _jax_adapter(jparams, 5, r=8)[0], tcfg))
    with pytest.raises(ValueError, match="rank"):
        tml.pack_adapters({**tad, "bad": bad})
    with pytest.raises(ValueError, match="rank"):
        _batcher(setup, adapters={**tad, "bad": bad})


@pytest.mark.parametrize("key", tml.PROJS, ids=lambda k: k[1])
def test_deltas_match_jax_lora_delta(setup, key):
    """The read-once products and the gather form against the JAX
    ``lora_delta`` on JAX's own pack: float32, atol 1e-6."""
    _, tcfg, _, _, jad, tad = setup
    jpack, _ = jml.pack_adapters(jad)
    pack, _ = tml.pack_adapters(tad)
    group = next(g for g, ks in tml.GROUPS.items() if key in ks)
    d_in = pack.a[group].shape[-1]
    idx = np.array([2, 0, 1, 2], np.int32)
    x = np.random.default_rng(3).standard_normal(
        (4, 3, d_in)).astype(np.float32)
    for layer in range(tcfg.llama.num_hidden_layers):
        want = np.asarray(jml.lora_delta(
            jnp.asarray(x), jpack.a[key][:, layer], jpack.b[key][:, layer],
            jpack.s[key][:, layer], jnp.asarray(idx)))
        mask = tml.row_mask(pack, torch.from_numpy(idx), torch.float32)
        got = tml.group_deltas(pack, layer, group, torch.from_numpy(x),
                               mask)[tml.GROUPS[group].index(key)]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        gather = tml.lora_delta(torch.from_numpy(x),
                                *pack.gather_form(layer, key),
                                torch.from_numpy(idx))
        np.testing.assert_allclose(gather.numpy(), want, rtol=0, atol=1e-6)
        assert not got[1].any()                     # index 0: the base
        # with the base outputs: the delta added by the same product
        base = torch.from_numpy(x[..., :1]).expand(*want.shape).contiguous()
        added = tml.group_deltas(
            pack, layer, group, torch.from_numpy(x), mask,
            bases=[base] * len(tml.GROUPS[group]))[
                tml.GROUPS[group].index(key)]
        np.testing.assert_allclose(added.numpy(), base.numpy() + want,
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["float", "int4"])
def test_multi_lora_pool_matches_jax_generate(setup, kind):
    """Rows of three adapters (base included) decode in one pool, grouped
    per adapter, and each stream equals JAX's ``generate`` on JAX's
    ``load_lora`` parameters.  int4: an unfused quantized base."""
    jcfg, tcfg, jparams, tparams, jad, _ = setup
    params = tparams
    if kind == "int4":
        # a copy: the JAX maybe_quantize(fuse=False) rewrites the layer
        # dicts of the tree it is given
        jparams = maybe_quantize(jax.tree.map(lambda a: a, jparams),
                                 load_8bit=False, load_4bit=True, fuse=False)
        params = _bridge(jparams, tcfg)
    jgen, _ = _gen()
    ids, px = _prompt()
    b = _batcher(setup, params=params, max_batch=6)
    try:
        b._hold_admission = True
        reqs = [(name, b.submit(ids, px, numtoks=4, max_new_tokens=8,
                                lora_id=name))
                for name in NAMES + NAMES[::-1]]
        b._hold_admission = False
        outs = [(name, _collect(b, r)) for name, r in reqs]
        with pytest.raises(KeyError, match="nope"):
            b.submit(ids, px, lora_id="nope")
        assert b.admit_stats["grouped"] == 6       # three groups of two
        assert not b.lora_idx.any()                 # cleared at retirement
    finally:
        b.shutdown()
    for name, got in outs:
        p = jparams if name is None else jlora.load_lora(jparams, jad[name])
        want = np.asarray(jax_generate(p, jcfg, ids, px,
                                       matryoshka_vis_token_scale=SPEC,
                                       gen_cfg=jgen)[0])
        np.testing.assert_array_equal(got, want, err_msg=f"adapter={name}")
    by = dict(outs)
    assert not np.array_equal(by[None], by["alpha"])
    assert not np.array_equal(by["alpha"], by["beta"])


def test_speculative_verify_takes_the_pack(setup):
    """speculative_k: the verify block adds each row's delta too; each
    stream equals JAX's ``generate`` on that adapter's parameters."""
    jcfg, _, jparams, _, jad, _ = setup
    jgen, _ = _gen()
    ids = np.array([[5, 9, 5, 9, 5, 9, 5, 9, 5, 9]], np.int32)
    b = _batcher(setup, speculative_k=2)
    try:
        outs = {n: _collect(b, b.submit(ids, None, max_new_tokens=8,
                                        lora_id=n)) for n in NAMES}
        assert b.spec_stats["verify_steps"] > 0
    finally:
        b.shutdown()
    for name, got in outs.items():
        p = jparams if name is None else jlora.load_lora(jparams, jad[name])
        want = np.asarray(jax_generate(p, jcfg, ids, None, gen_cfg=jgen)[0])
        np.testing.assert_array_equal(got, want, err_msg=f"adapter={name}")
    assert not np.array_equal(outs[None], outs["alpha"])


def test_lora_prefix_chains_are_salted(setup):
    """The same prompt under another adapter misses; a repeat under the
    same adapter hits its own chain and gives the same tokens."""
    b = _batcher(setup, max_batch=2, prefix_cache=True)
    rng = np.random.default_rng(1)
    ids = rng.integers(5, 100, (1, 21)).astype(np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    px = rng.standard_normal((1, 3, 56, 56)).astype(np.float32)
    try:
        def run(name):
            return _collect(b, b.submit(ids, px, numtoks=4, max_new_tokens=4,
                                        lora_id=name))
        base = run(None)
        alpha = run("alpha")
        assert b.stats["prefix_hits"] == 0
        assert run("alpha").tolist() == alpha.tolist()
        assert b.stats["prefix_hits"] == 1
        assert run(None).tolist() == base.tolist()
        assert b.stats["prefix_hits"] == 2
        assert run("beta").tolist() != alpha.tolist()
        assert b.stats["prefix_hits"] == 2
    finally:
        b.shutdown()


def test_refusals(setup):
    """As in the JAX package: the dense backend, fused qkv leaves and an
    unknown adapter name; and MPT, which has no LoRA target."""
    jcfg, tcfg, jparams, tparams, _, tad = setup
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(tparams, tcfg, backend="dense", adapters=tad)
    fused = _bridge(maybe_quantize(jax.tree.map(lambda a: a, jparams),
                                   load_8bit=False, load_4bit=True), tcfg)
    with pytest.raises(ValueError, match="fused qkv"):
        _batcher(setup, params=fused)
    mpt = tcfg.__class__.tiny_debug()
    import dataclasses
    mpt = dataclasses.replace(mpt, llama=dataclasses.replace(
        mpt.llama, arch="mpt"))
    from matryoshka_mm_torch.models.convert import init_params
    mparams = init_params(mpt, seed=0, device="cpu")
    with pytest.raises(ValueError, match="no leaves matched"):
        tlora.add_lora(mparams, torch.Generator().manual_seed(0), r=R)
    with pytest.raises(ValueError, match="MPT"):
        ContinuousBatcher(mparams, mpt, backend="paged", adapters=tad)
    b = _batcher(setup)
    try:
        with pytest.raises(KeyError, match="unknown LoRA adapter"):
            b.submit(*_prompt(), numtoks=4, lora_id="gamma")
    finally:
        b.shutdown()
