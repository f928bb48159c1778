"""PyTorch port: the CLIP router taps, ``models/router.py`` and the router
functions of ``models/llava.py`` against the JAX package on the tiny
config; float32, within ``1e-5`` (taps after four encoder layers
``1e-4``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.models import clip as jclip
from matryoshka_mm_tpu.models import llava as jllava
from matryoshka_mm_tpu.models import router as jrouter
from matryoshka_mm_torch.models import clip as tclip
from matryoshka_mm_torch.models import llava as tllava
from matryoshka_mm_torch.models import router as trouter
from matryoshka_mm_torch.models.convert import init_params
from tests.test_torch_train_step import make_pair

TAPS = ("cls", "clslast", "patchavgpool", "poolout", "attnqk", "attnkk")
MOE = "t=dense_ft=cls_obj=weightedlm"


@pytest.fixture(scope="module")
def pair():
    return make_pair(moe=MOE)


def _pixels(seed=0, B=2):
    return np.random.default_rng(seed).standard_normal(
        (B, 3, 56, 56)).astype(np.float32)


@pytest.mark.parametrize("select_layer", [-2, -1, 2])
def test_all_six_taps_match_jax(pair, select_layer):
    jcfg, jparams, tcfg, tparams = pair
    jv = dataclasses.replace(jcfg.vision, select_layer=select_layer)
    tv = dataclasses.replace(tcfg.vision, select_layer=select_layer)
    px = _pixels()
    want = jclip.clip_vision_forward(jparams["vision_tower"], jnp.asarray(px),
                                     jv, want_router_taps=True)
    with torch.no_grad():
        got = tclip.clip_vision_forward(tparams["vision_tower"],
                                        torch.from_numpy(px), tv,
                                        want_router_taps=True)
    assert set(got) == set(want) == set(TAPS) | {"patch", "cls_patch"}
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-4, err_msg=name)
    for name in ("attnqk", "attnkk"):
        assert got[name].shape == (2, 16) and got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].sum(-1).numpy(), 1.0, atol=1e-5)
    with torch.no_grad():
        plain = tclip.clip_vision_forward(tparams["vision_tower"],
                                          torch.from_numpy(px), tv)
    assert set(plain) == {"patch", "cls_patch"}


def test_gating_networks_match_jax(pair):
    _, jparams, _, tparams = pair
    x = np.random.default_rng(1).standard_normal((5, 32)).astype(np.float32)
    want = jrouter.dense_gating_forward(jparams["router"], jnp.asarray(x))
    got = trouter.dense_gating_forward(tparams["router"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        trouter.uniform_gating_forward(3, torch.from_numpy(x)).numpy(),
        np.asarray(jrouter.uniform_gating_forward(3, jnp.asarray(x))))


def test_build_router_input_and_ema(pair):
    outs = {n: np.random.default_rng(i).standard_normal((2, 4)).astype(
        np.float32) for i, n in enumerate(TAPS)}
    text = np.ones((2, 3), np.float32)
    for fts in (("cls",), ("clslast", "attnqk"), ("textcls", "poolout")):
        want = jrouter.build_router_input(
            {k: jnp.asarray(v) for k, v in outs.items()}, fts,
            jnp.asarray(text))
        got = trouter.build_router_input(
            {k: torch.from_numpy(v) for k, v in outs.items()}, fts,
            torch.from_numpy(text))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    touts = {k: torch.from_numpy(v) for k, v in outs.items()}
    with pytest.raises(ValueError, match="requires a text embedding"):
        trouter.build_router_input(touts, ("textcls",))
    with pytest.raises(ValueError, match="not available"):
        trouter.build_router_input(touts, ("nose",))
    v = torch.tensor(0.4)
    assert trouter.ema_update(None, v, 0.9) == v
    np.testing.assert_allclose(
        float(trouter.ema_update(torch.tensor(0.2), v, 0.9)),
        float(jrouter.ema_update(jnp.asarray(0.2), jnp.asarray(0.4), 0.9)),
        rtol=1e-6)


@pytest.mark.parametrize("fts", [("cls",), ("clslast",), ("patchavgpool",),
                                 ("poolout",), ("attnqk",), ("attnkk",)])
def test_router_forward_matches_jax_for_every_tap(fts):
    jcfg, _, tcfg, _ = make_pair(moe=MOE)
    jcfg = dataclasses.replace(jcfg, router_feature_types=fts)
    tcfg = dataclasses.replace(tcfg, router_feature_types=fts)
    assert tllava.router_embed_dim(tcfg) == jllava.router_embed_dim(jcfg) \
        == (16 if fts[0].startswith("attn") else 32)
    from tests.test_torch_train_step import bridge

    jparams = jllava.init_llava_params(jax.random.PRNGKey(3), jcfg)
    tparams = bridge(jparams, tcfg)
    px = _pixels(2)
    jouts = jllava.encode_images(jparams, jcfg, jnp.asarray(px))
    want = jllava.router_forward(jparams, jcfg, jouts)
    with torch.no_grad():
        touts = tllava.encode_images(tparams, tcfg, torch.from_numpy(px))
        got = tllava.router_forward(tparams, tcfg, touts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert got.shape == (2, 3)


def test_router_variants_and_refusals(pair):
    _, _, tcfg, tparams = pair
    px = torch.from_numpy(_pixels(3))
    plain = dataclasses.replace(tcfg, preset=dataclasses.replace(
        tcfg.preset, moe=None))
    with torch.no_grad():
        outs = tllava.encode_images(tparams, plain, px)
        assert set(outs) == {"patch", "cls_patch"}
        assert tllava.router_forward(tparams, plain, outs) is None
        uniform = dataclasses.replace(tcfg, preset=dataclasses.replace(
            tcfg.preset, moe="t=id_obj=weightedlm"))
        got = tllava.router_forward(tparams, uniform,
                                    tllava.encode_images(tparams, uniform, px))
        assert torch.all(got == 1 / 3)
        # textcls without a text embedding: the JAX ValueError
        text = dataclasses.replace(tcfg, router_feature_types=("textcls",))
        with pytest.raises(ValueError,
                           match="textcls requires a text embedding"):
            tllava.router_forward(tparams, text,
                                  tllava.encode_images(tparams, text, px))
        spliced, gate = tllava.prepare_multimodal(
            tparams, tcfg, torch.tensor([[1, -200, 7, 9]]), px[:1], numtoks=4)
    assert gate.shape == (1, 3) and spliced.embeds.shape[1] == 7


def test_init_params_makes_a_router_for_dense_moe_configs(pair):
    _, _, tcfg, _ = pair
    params = init_params(tcfg, device="cpu", seed=1)
    r = params["router"]
    assert r["fc1"]["weight"].shape == (32, 32)
    assert r["fc2"]["weight"].shape == (3, 32)
    assert float(r["fc1"]["weight"].abs().max()) <= 32 ** -0.5
    assert not bool(r["fc2"]["bias"].any())
    plain = dataclasses.replace(tcfg, preset=dataclasses.replace(
        tcfg.preset, moe="t=id_obj=weightedlm"))
    assert "router" not in init_params(plain, device="cpu", seed=1)


@pytest.mark.parametrize("fn", [init_params,
                                trouter.init_dense_gating_params],
                         ids=lambda f: f.__name__)
def test_public_initialisers_build_on_the_card_unless_told_otherwise(fn):
    """Like ``load_pretrained_model`` and the trainer's entry point, the
    initialisers run on the card by default; the CPU has to be named."""
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"
