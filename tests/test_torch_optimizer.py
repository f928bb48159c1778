"""PyTorch port: ``train/optimizer.py`` against the JAX package's optax
construction.

* ``trainable_labels`` equals the JAX label tree, label by label, for every
  freeze mode (the port's path carries the layer's index, the JAX path does
  not: the stacked leaf's label is compared with each layer's);
* the schedules equal optax's at every count;
* three updates from fixed numpy gradients equal optax's: per-group clip,
  the decay mask, the schedule read at the count before the update.  The
  gradients are far above ``eps``, so Adam's ``m / sqrt(v)`` is well
  conditioned: parameters within ``1e-6`` absolute after each update (f32,
  learning rates up to 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matryoshka_mm_tpu.ops import lora as jlora
from matryoshka_mm_tpu.train import optimizer as jopt
from matryoshka_mm_torch.train import optimizer as topt
from tests.test_torch_train_step import bridge, make_pair

MOE = "t=dense_ft=cls_obj=weightedlm"
MODES = {
    "default": {},
    "freeze_backbone": dict(freeze_backbone=True),
    "tune_mm_mlp_adapter": dict(tune_mm_mlp_adapter=True),
    "freeze_mm_mlp_adapter": dict(freeze_mm_mlp_adapter=True),
    "unfreeze_vision": dict(unfreeze_mm_vision_tower=True),
    "tune_router": dict(tune_router=True),
    "lora": dict(lora_enable=True),
    "lora_frozen_projector": dict(lora_enable=True,
                                  freeze_mm_mlp_adapter=True),
}


@pytest.fixture(scope="module")
def pair():
    jcfg, jparams, tcfg, _ = make_pair(moe=MOE)
    jparams = jlora.add_lora(jparams, jax.random.PRNGKey(1), r=2, alpha=4.0)
    return jparams, tcfg, bridge(jparams, tcfg)


def _jax_labels(jparams, cfg):
    """The JAX labels in the port's naming: path without a layer index,
    ``kernel`` read as ``weight``."""
    labels = jopt.trainable_labels(jparams, cfg)
    return {_drop_index("/".join(
        str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
    ).replace("kernel", "weight"): lab
        for path, lab in jax.tree_util.tree_leaves_with_path(labels)}


def _drop_index(path):
    return "/".join(p for p in path.split("/") if not p.isdigit())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trainable_labels_equal_jax(pair, mode):
    jparams, _, tparams = pair
    want = _jax_labels(jparams, jopt.OptimizerConfig(**MODES[mode]))
    got = topt.trainable_labels(tparams, topt.OptimizerConfig(**MODES[mode]))
    assert {_drop_index(p) for p in got} == set(want)
    for path, label in got.items():
        assert label == want[_drop_index(path)], path
    assert len(set(got.values())) > 1


def test_quantized_bases_are_frozen():
    from matryoshka_mm_torch.ops.lora import add_lora
    from matryoshka_mm_torch.ops.quant import quantize_llama_params

    _, _, _, tparams = make_pair()
    quantize_llama_params(tparams, bits=4, fuse=False)
    tparams = add_lora(tparams, torch.Generator().manual_seed(0), r=2)
    labels = topt.trainable_labels(tparams,
                                   topt.OptimizerConfig(lora_enable=True))
    assert labels["llama/layers/0/self_attn/q_proj/w/qint4"] == "frozen"
    assert labels["llama/layers/0/self_attn/q_proj/w/scale"] == "frozen"
    assert labels["llama/layers/0/self_attn/q_proj/lora_scale"] == "frozen"
    assert labels["llama/layers/0/self_attn/q_proj/lora_b"] == "backbone"


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("total,ratio", [(20, 0.25), (10, 0.0), (7, 0.5)])
def test_schedules_equal_optax(kind, total, ratio):
    kw = dict(lr_schedule=kind, total_steps=total, warmup_ratio=ratio)
    want = jopt._schedule(jopt.OptimizerConfig(**kw), 3e-3)
    got = topt._schedule(topt.OptimizerConfig(**kw), 3e-3)
    for count in range(total + 3):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-5,
                                   atol=1e-10, err_msg=str(count))
    if ratio:
        assert got(0) == 0.0       # the first update's rate under warm-up


def _fixed_grads(jparams, step):
    """Gradients from numpy, the same for both sides; the router's are large
    (its group is clipped), the projector's small (its group is not)."""
    rng = np.random.default_rng(100 + step)

    def make(path, leaf):
        name = str(path[0].key)
        scale = 5.0 if name.startswith("router") else \
            1e-3 if name.startswith("mm_projector") else 0.3
        return jnp.asarray(rng.standard_normal(leaf.shape) * scale,
                           leaf.dtype)

    return jax.tree_util.tree_map_with_path(make, jparams)


@pytest.mark.parametrize("mode,kw", [
    ("default", dict(weight_decay=0.1, lr_schedule="cosine",
                     warmup_ratio=0.25, total_steps=8, router_lr=1e-2,
                     mm_projector_lr=5e-3)),
    ("lora", dict(lora_enable=True, weight_decay=0.05, lr_schedule="linear",
                  warmup_ratio=0.0, total_steps=5, max_grad_norm=0.5)),
    ("unfreeze_vision", dict(unfreeze_mm_vision_tower=True,
                             lr_schedule="constant", warmup_ratio=0.2,
                             total_steps=10, mm_vision_tower_lr=2e-3)),
])
def test_three_updates_equal_optax(mode, kw):
    jcfg, jparams, tcfg, _ = make_pair(moe=MOE)
    if mode == "lora":
        jparams = jlora.add_lora(jparams, jax.random.PRNGKey(1), r=2,
                                 alpha=4.0)
        # B = 0 would hide the decay of lora_b
        jparams = jax.tree_util.tree_map_with_path(
            lambda path, a: a + 0.01 if str(path[-1].key) == "lora_b" else a,
            jparams)
    tparams = bridge(jparams, tcfg)
    kw = dict(kw, learning_rate=1e-3)
    jtx = jopt.build_optimizer(jparams, jopt.OptimizerConfig(**kw))
    jstate = jtx.init(jparams)
    ttx = topt.build_optimizer(tparams, topt.OptimizerConfig(**kw))
    tstate = ttx.init(tparams)
    frozen_before = {p: t.clone() for p, t in topt.named_leaves(tparams)
                     if ttx.labels[p] == "frozen"}
    for step in range(3):
        jgrads = _fixed_grads(jparams, step)
        tgrads = dict(topt.named_leaves(bridge(jgrads, tcfg)))
        updates, jstate = jtx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate = ttx.update({p: tgrads[p] for p in ttx.trainable}, tstate,
                            tparams)
        want = dict(topt.named_leaves(bridge(jparams, tcfg)))
        for p, t in topt.named_leaves(tparams):
            np.testing.assert_allclose(t.numpy(), want[p].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{step} {p}")
    assert tstate["count"] == 3
    for p, t in frozen_before.items():
        assert torch.equal(dict(topt.named_leaves(tparams))[p], t), p
    if kw.get("warmup_ratio"):
        # count 0 reads the schedule at 0: moments move, parameters do not
        _, _, _, fresh = make_pair(moe=MOE)
        tx = topt.build_optimizer(fresh, topt.OptimizerConfig(**kw))
        before = {p: t.clone() for p, t in topt.named_leaves(fresh)}
        grads = dict(topt.named_leaves(bridge(
            _fixed_grads(make_pair(moe=MOE)[1], 0), tcfg)))
        st = tx.update({p: grads[p] for p in tx.trainable}, tx.init(fresh),
                       fresh)
        assert all(torch.equal(t, before[p])
                   for p, t in topt.named_leaves(fresh))
        assert any(bool(m.any()) for m in st["mu"].values())


def test_multisteps_equals_optax():
    jcfg, jparams, tcfg, tparams = make_pair()
    kw = dict(learning_rate=1e-3, warmup_ratio=0.0, total_steps=4,
              tune_mm_mlp_adapter=True)
    jtx = optax.MultiSteps(
        jopt.build_optimizer(jparams, jopt.OptimizerConfig(**kw)), 2)
    jstate = jtx.init(jparams)
    ttx = topt.MultiSteps(
        topt.build_optimizer(tparams, topt.OptimizerConfig(**kw)), 2)
    tstate = ttx.init(tparams)
    start = tparams["mm_projector"]["layers"][0]["weight"].clone()
    for step in range(4):
        jgrads = _fixed_grads(jparams, step)
        tgrads = dict(topt.named_leaves(bridge(jgrads, tcfg)))
        updates, jstate = jtx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate = ttx.update({p: tgrads[p] for p in ttx.trainable}, tstate,
                            tparams)
        got = tparams["mm_projector"]["layers"][0]["weight"]
        if step == 0:
            assert torch.equal(got, start)      # no update on a first half
        want = bridge(jparams, tcfg)["mm_projector"]["layers"][0]["weight"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6, err_msg=str(step))
    assert tstate["inner"]["count"] == 2 and tstate["mini_step"] == 0
