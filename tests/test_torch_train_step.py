"""PyTorch port: ``multiscale_forward`` and ``m3_loss`` against the JAX
package on the tiny config (two decoder layers, float32, CPU), the JAX
parameters bridged through ``params_from_jax`` and the same numpy batch on
both sides (left-padded splice, one row shorter than the other).

Tolerances: the loss and every metric ``1e-4`` relative (``1e-6``
absolute for metrics near 0); the gradient of every trainable leaf ``1e-3``
of the leaf's largest JAX gradient (f32 sums in another order through two
layers; leaves whose JAX gradient is 0 throughout must be 0 here as well, up
to ``1e-7``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.train import train_step as jts
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.models.convert import params_from_jax
from matryoshka_mm_torch.train import train_step as tts
from matryoshka_mm_torch.train.optimizer import named_leaves

LAYERS = 2


def make_pair(moe=None, scales=(1, 4, 16), seed=0, **llama_kw):
    """(jax cfg, jax params, port cfg, port params) of one tiny model."""
    jcfg = JaxLlavaConfig.tiny_debug(moe=moe, scales=scales)
    jcfg = dataclasses.replace(jcfg, llama=dataclasses.replace(
        jcfg.llama, num_hidden_layers=LAYERS, **llama_kw))
    tcfg = LlavaConfig.tiny_debug(moe=moe, scales=scales)
    tcfg = dataclasses.replace(tcfg, llama=dataclasses.replace(
        tcfg.llama, num_hidden_layers=LAYERS, **llama_kw))
    jparams = init_llava_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, tcfg, bridge(jparams, tcfg)


def bridge(jtree, tcfg):
    """A JAX tree shaped like the parameters (parameters, gradients) in the
    port's layout."""
    return params_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                           device="cpu")


def make_batch(seed=0, B=2, T=24, vocab=512, size=56):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (B, T)).astype(np.int32)
    ids[:, 3] = -200
    labels = ids.copy()
    labels[:, :T // 2] = -100
    mask = np.ones((B, T), bool)
    mask[1, T - 5:] = False                       # a shorter second row
    px = rng.standard_normal((B, 3, size, size)).astype(np.float32)
    return dict(input_ids=ids, pixel_values=px, labels=labels, attn_mask=mask)


def jax_batch(b):
    return jts.M3Batch(**{k: jnp.asarray(v) for k, v in b.items()})


def torch_batch(b):
    return tts.M3Batch(
        input_ids=torch.from_numpy(b["input_ids"]).long(),
        pixel_values=torch.from_numpy(b["pixel_values"]),
        labels=torch.from_numpy(b["labels"]).long(),
        attn_mask=torch.from_numpy(b["attn_mask"]))


def set_trainable(tparams, frozen=("vision_tower",)):
    for path, leaf in named_leaves(tparams):
        leaf.requires_grad_(leaf.is_floating_point()
                            and not path.startswith(tuple(frozen)))
    return [(p, t) for p, t in named_leaves(tparams) if t.requires_grad]


def assert_metrics_close(got, want, rtol=1e-4):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=rtol,
                                   atol=1e-6, err_msg=k)


def assert_grads_close(tgrads, jgrads_bridged, tol=1e-3):
    """``tgrads``: path -> tensor or None; ``jgrads_bridged``: the JAX
    gradient tree in the port's layout."""
    want = dict(named_leaves(jgrads_bridged))
    for path, g in tgrads.items():
        w = want[path].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        assert np.isfinite(g).all(), path
        np.testing.assert_allclose(g, w, rtol=0, err_msg=path,
                                   atol=max(tol * np.abs(w).max(), 1e-7))


def loss_and_grads(pair, batch, frozen_vision=True, uniform_buffer=False,
                   ema=None):
    """((jax loss, metrics, bridged grads), (torch loss, metrics, grads))."""
    jcfg, jparams, tcfg, tparams = pair

    def jloss(p):
        return jts.m3_loss(p, jcfg, jax_batch(batch), frozen_vision=frozen_vision,
                           uniform_buffer=uniform_buffer,
                           argmaxcost_ema=None if ema is None
                           else jnp.asarray(ema, jnp.float32))

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    trainable = set_trainable(tparams)
    tl, tm = tts.m3_loss(tparams, tcfg, torch_batch(batch),
                         frozen_vision=frozen_vision,
                         uniform_buffer=uniform_buffer,
                         argmaxcost_ema=None if ema is None
                         else torch.tensor(ema, dtype=torch.float32))
    tg = torch.autograd.grad(tl, [t for _, t in trainable], allow_unused=True)
    return ((float(jl), jm, bridge(jg, tcfg)),
            (float(tl), tm, {p: g for (p, _), g in zip(trainable, tg)}))


MOE = {
    "plain": None,
    "weightedlm": "t=dense_ft=cls_obj=weightedlm",
    "uniform_router": "t=id_obj=weightedlm",
    "bounderr": "t=dense_ft=cls_obj=bounderr_margin=0.01_tau=0.5",
    "bounderrsq": "t=dense_ft=cls_obj=bounderrsq_margin=0.0_tau=1",
    "lmlossaddcost": "t=dense_ft=cls_obj=lmlossaddcost_lambda=0.5"
                     "_costt=numtoks",
    "distil": "t=dense_ft=cls_obj=distil_temp=2.0_alpha=0.5_detacht=1"
              "_tss=[1,4]_tst=[16]",
    "pick_best": "t=dense_ft=cls_obj=distilpickteacher_temp=1.0_alpha=0.5"
                 "_tss=[1]_tst=[4,16]_teachert=best_pickby=logprob"
                 "_sametsdistil=1",
    "pick_besttoken": "t=dense_ft=cls_obj=distilpickteacher_temp=1.0"
                      "_alpha=0.5_tss=[1,4]_tst=[4,16]_teachert=besttoken"
                      "_pickby=entropy_sametsdistil=2",
    "pick_cd": "t=dense_ft=cls_obj=distilpickteacher_temp=1.0_alpha=0.5"
               "_detacht=1_tss=[1]_tst=[4,16]_teachert=cd_beta=0.5"
               "_gamma=0.1",
    "pick_avg": "t=dense_ft=cls_obj=distilpickteacher_temp=1.5_alpha=1.0"
                "_tss=[1]_tst=[4,16]_teachert=avg",
    "loadb_switch": "t=dense_ft=cls_obj=weightedlm_loadb=switch_alpha=0.01"
                    "_costt=lognumtoks",
    "argmaxcost_ema": "t=dense_ft=cls_obj=weightedlm_loadb=argmaxcost"
                      "_alpha=1.0_costt=numtoks_tval=0.5_emaa=0.9",
    "argmaxcost_margin": "t=dense_ft=patchavgpool_obj=bounderr_margin=0.0"
                         "_loadb=argmaxcost_alpha=1.0_costt=count*numtoks"
                         "_tmargin=0.1",
}


@pytest.mark.parametrize("name", sorted(MOE))
def test_m3_loss_and_gradients_match_jax(name):
    pair = make_pair(moe=MOE[name])
    if "patchavgpool" in (MOE[name] or ""):
        pair = tuple(dataclasses.replace(
            c, router_feature_types=("patchavgpool",))
            if dataclasses.is_dataclass(c) else c for c in pair)
    ema = 0.3 if name == "argmaxcost_ema" else None
    (jl, jm, jg), (tl, tm, tg) = loss_and_grads(pair, make_batch(), ema=ema)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert_metrics_close(tm, jm)
    assert_grads_close(tg, jg)
    # frozen_vision: nothing reaches the tower
    assert not [p for p, t in named_leaves(pair[3])
                if p.startswith("vision_tower") and t.grad is not None]


def test_betalogprob_two_scales_and_macro_loss():
    moe = ("t=dense_ft=cls_obj=weightedlm_loadb=betalogprob_alpha=0.01"
           "_ba=2.0_bb=3.0")
    pair = make_pair(moe=moe, scales=(1, 4))
    pair = tuple(dataclasses.replace(c, preset=dataclasses.replace(
        c.preset, lm_loss_type="macro"))
        if dataclasses.is_dataclass(c) else c for c in pair)
    (jl, jm, jg), (tl, tm, tg) = loss_and_grads(pair, make_batch(seed=3))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert_metrics_close(tm, jm)
    assert_grads_close(tg, jg)
    with pytest.raises(ValueError, match="betalogprob"):
        tts.m3_loss(make_pair(moe=moe)[3], LlavaConfig.tiny_debug(moe=moe),
                    torch_batch(make_batch()))


def test_first_ema_step_adopts_the_batch_cost():
    pair = make_pair(moe=MOE["argmaxcost_ema"])
    (_, jm, _), (_, tm, _) = loss_and_grads(pair, make_batch(), ema=-1.0)
    assert_metrics_close(tm, jm)
    np.testing.assert_allclose(float(tm["_state/argmaxcost_ema"]),
                               float(tm["moe_load/argmaxcost"]), rtol=1e-6)


def test_multiscale_forward_matches_jax():
    jcfg, jparams, tcfg, tparams = make_pair()
    b = make_batch(seed=1)
    want = jts.multiscale_forward(jparams, jcfg, jax_batch(b))
    with torch.no_grad():
        got = tts.multiscale_forward(tparams, tcfg, torch_batch(b))
    names = ("logits", "labels", "gating_prob", "losses_lm", "ce", "valid")
    for n, g, w in zip(names, got, want):
        if w is None:
            assert g is None, n
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, n
        if n == "logits":
            # rows that see no key differ by design (0 against mean of V);
            # they are pads: compare where the labels' row is attended
            keep = np.asarray(want[5]).any(-1)           # (K, B)
            np.testing.assert_allclose(g[keep][:, -8:], w[keep][:, -8:],
                                       atol=2e-4, err_msg=n)
        elif n in ("labels", "valid"):
            np.testing.assert_array_equal(g, w, err_msg=n)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=n)


def test_bucketed_equals_uniform_buffer():
    pair = make_pair()
    b = make_batch(seed=2)
    assert len(tts.scale_buckets(pair[2], 24)) > 1
    (jl, _, _), (tl, tm, tg) = loss_and_grads(pair, b)
    (jlu, _, _), (tlu, tmu, tgu) = loss_and_grads(pair, b,
                                                  uniform_buffer=True)
    np.testing.assert_allclose(tlu, jlu, rtol=1e-4)
    np.testing.assert_allclose(tl, tlu, rtol=1e-5)
    assert_metrics_close(tm, tmu, rtol=1e-5)
    for p in tg:
        np.testing.assert_allclose(
            tg[p].numpy(), tgu[p].numpy(), rtol=0,
            atol=max(1e-4 * float(tgu[p].abs().max()), 1e-7), err_msg=p)


def test_default_scales_run_as_three_forwards():
    cfg = LlavaConfig.llava_v15_7b_m3()
    got = [(cap, [cfg.tokscale_list[i] for i in m])
           for cap, m in tts.scale_buckets(cfg, 1024)]
    assert got == [(1059, [1, 9, 36]), (1167, [144]), (1599, [576])]


def test_frozen_vision_gives_the_same_loss_and_no_vision_gradient():
    pair = make_pair(moe=MOE["weightedlm"])
    jcfg, jparams, tcfg, tparams = pair
    b = make_batch(seed=4)
    for path, leaf in named_leaves(tparams):
        leaf.requires_grad_(leaf.is_floating_point())
    vision = [t for p, t in named_leaves(tparams["vision_tower"])]
    losses = {}
    for frozen in (False, True):
        loss, _ = tts.m3_loss(tparams, tcfg, torch_batch(b),
                              frozen_vision=frozen)
        grads = torch.autograd.grad(loss, vision, allow_unused=True)
        losses[frozen] = float(loss)
        assert any(g is not None and bool(g.any()) for g in grads) \
            == (not frozen)
    assert losses[True] == losses[False]
    # and with the tower differentiated its gradients are JAX's
    def jloss(p):
        return jts.m3_loss(p, jcfg, jax_batch(b), frozen_vision=False)[0]

    jg = bridge(jax.jit(jax.grad(jloss))(jparams), tcfg)
    loss, _ = tts.m3_loss(tparams, tcfg, torch_batch(b), frozen_vision=False)
    leaves = named_leaves(tparams)
    tg = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True)
    assert_grads_close({p: g for (p, _), g in zip(leaves, tg)}, jg)


KEEPS_FLASH = ("names:flash_out,flash_lse", "names:attn")


@pytest.mark.parametrize("policy", ["", "names:flash_out,flash_lse", "dots",
                                    "names:attn", "names:attn_q,attn_k"])
def test_remat_policies_give_the_gradients_of_no_remat(policy):
    from matryoshka_mm_torch.ops import flash_attention as tflash

    b = make_batch(seed=5)
    grads = {}
    for remat in (False, True):
        _, _, tcfg, tparams = make_pair(remat=remat, remat_policy=policy)
        trainable = set_trainable(tparams)
        calls = []
        orig = tflash.flash_attention_lse

        def counting(*a, **kw):
            calls.append(1)
            return orig(*a, **kw)

        tflash.flash_attention_lse = counting
        try:
            loss, _ = tts.m3_loss(tparams, tcfg, torch_batch(b),
                                  frozen_vision=True)
            g = torch.autograd.grad(loss, [t for _, t in trainable],
                                    allow_unused=True)
        finally:
            tflash.flash_attention_lse = orig
        grads[remat] = g
        forwards = LAYERS * len(tts.scale_buckets(tcfg, 24))
        # a recompute runs every flash forward twice; keeping out and lse,
        # once
        assert len(calls) == forwards * (
            2 if remat and policy not in KEEPS_FLASH else 1)
    for a, c in zip(grads[False], grads[True]):
        if a is None:
            assert c is None
        else:
            torch.testing.assert_close(c, a, rtol=0, atol=1e-6)


@pytest.mark.parametrize("policy,error", [
    ("everything", "unknown remat_policy"),
    ("names:attn_q,mlp_up", "unknown names")])
def test_remat_policies_not_ported_raise(policy, error):
    _, _, tcfg, tparams = make_pair(remat=True, remat_policy=policy)
    set_trainable(tparams)
    with pytest.raises(ValueError, match=error):
        tts.m3_loss(tparams, tcfg, torch_batch(make_batch()))


def _products_run(policy, remat=True):
    """``aten.mm`` / ``aten.addmm`` dispatched over one loss and its
    gradients (the forward, any recompute and the backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    _, _, tcfg, tparams = make_pair(remat=remat, remat_policy=policy)
    trainable = set_trainable(tparams)
    with Count():
        loss, _ = tts.m3_loss(tparams, tcfg, torch_batch(make_batch(seed=5)),
                              frozen_vision=True)
        torch.autograd.grad(loss, [t for _, t in trainable],
                            allow_unused=True)
    return Count.n


@pytest.mark.parametrize("policy", ["dots", "names:attn",
                                    "names:attn_q,attn_k"])
def test_remat_policies_recompute_fewer_products(policy):
    """Each policy recomputes fewer projections than ``remat=True`` alone;
    ``dots`` none at all.  The counts: every product of the LM's forward,
    recompute and backward."""
    full, none = _products_run(""), _products_run("", remat=False)
    got = _products_run(policy)
    assert none <= got < full
    # a full recompute re-runs 6 projections of each layer forward, one
    # product each: q, k, v, o, gate and up (it stops before down, whose
    # output the backward does not need)
    forwards = LAYERS * len(tts.scale_buckets(make_pair()[2], 24))
    assert full - none == 6 * forwards
    kept = {"dots": 6, "names:attn": 4, "names:attn_q,attn_k": 2}[policy]
    assert full - got == kept * forwards


def test_a_config_without_scales_raises():
    _, _, tcfg, tparams = make_pair()
    cfg = dataclasses.replace(tcfg, preset=dataclasses.replace(
        tcfg.preset, matryoshka_vis_token_scale=None))
    with pytest.raises(ValueError, match="token scales"):
        tts.m3_loss(tparams, cfg, torch_batch(make_batch()))
