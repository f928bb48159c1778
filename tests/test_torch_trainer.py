"""PyTorch port: two ``make_train_step`` steps on the tiny model against
the JAX trainer, same parameters (bridged) and the same numpy batch: plain
M3 with LoRA, QLoRA over an int8 and an int4 base, and an M3-MoE config
with full fine-tuning and the ``argmaxcost_ema`` state.

Tolerances.  Losses and metrics ``1e-4`` relative (step 2 sees step 1's
update, so it also holds the update).  ``grad_norm``: the port reports the
norm over the trainable leaves, so the JAX side's is recomputed over the
same leaves (the JAX step also counts the gradients of frozen float
leaves); ``1e-3`` relative.  Parameters after two steps: Adam divides by
``sqrt(v)``, so an element whose gradient is rounding noise moves by
``+-lr`` on either side; every element must lie within ``2.2 * lr`` a step
of JAX's and nine in ten within ``0.05 * lr``.  Frozen leaves are
bit-identical to their start.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.models.builder import maybe_quantize
from matryoshka_mm_tpu.ops import lora as jlora
from matryoshka_mm_tpu.ops.quant import disable_fused_proj as jdisable
from matryoshka_mm_tpu.train import optimizer as jopt
from matryoshka_mm_tpu.train import train_step as jts
from matryoshka_mm_tpu.train import trainer as jtrainer
from matryoshka_mm_torch.train import optimizer as topt
from matryoshka_mm_torch.train import trainer as ttrainer
from tests.test_torch_optimizer import _drop_index, _jax_labels
from tests.test_torch_train_step import (assert_metrics_close, bridge,
                                         jax_batch, make_batch, make_pair,
                                         torch_batch)

LR = 1e-3
MOE = ("t=dense_ft=cls_obj=weightedlm_loadb=argmaxcost_alpha=1.0"
       "_costt=numtoks_tval=0.5_emaa=0.9")
CASES = {
    # name: (moe, quantized base bits, LoRA)
    "plain_m3_lora": (None, 0, True),
    "qlora_int8": (None, 8, True),
    "qlora_int4": (None, 4, True),
    "moe_argmaxcost_ema": (MOE, 0, False),
}


def _restricted_norm(jgrads, labels):
    total = 0.0
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        name = _drop_index("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                    for k in path)).replace("kernel", "weight")
        if labels[name] != "frozen" and g.dtype != jax.dtypes.float0:
            total += float(jnp.sum(jnp.square(g.astype(jnp.float32))))
    return total ** 0.5


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_train_steps_match_the_jax_trainer(name):
    moe, bits, lora = CASES[name]
    jcfg, jparams, tcfg, _ = make_pair(moe=moe, remat=True)
    if bits:
        jparams = maybe_quantize(dict(jparams), load_8bit=bits == 8,
                                 load_4bit=bits == 4, fuse=False)
    if lora:
        jparams = jlora.add_lora(jparams, jax.random.PRNGKey(1), r=4,
                                 alpha=8.0)
    tparams = bridge(jparams, tcfg)
    kw = dict(learning_rate=LR, warmup_ratio=0.0, total_steps=10,
              lora_enable=lora)
    batch = make_batch(seed=7)

    jstate, jtx = jtrainer.create_train_state(jparams,
                                              jopt.OptimizerConfig(**kw))
    jstep = jtrainer.make_train_step(jcfg, jtx, donate=False,
                                     frozen_vision=True)
    jlabels = _jax_labels(jparams, jopt.OptimizerConfig(**kw))
    tstate, ttx = ttrainer.create_train_state(tparams,
                                              topt.OptimizerConfig(**kw))
    tstep = ttrainer.make_train_step(tcfg, ttx, frozen_vision=True)
    start = {p: t.detach().clone() for p, t in topt.named_leaves(tparams)}
    assert float(tstate.argmaxcost_ema) == -1.0 and tstate.step == 0

    # the gradients of the JAX loss, for the norm over the trainable leaves;
    # compiled once (eager, each step took ~10-50 s of the CPU)
    def jloss(p, ema):
        return jts.m3_loss(p, jcfg, jax_batch(batch), argmaxcost_ema=ema,
                           frozen_vision=True)[0]

    jgrad = jax.jit(jax.grad(jloss, allow_int=True))
    for step in range(2):
        with jdisable():
            jgrads = jgrad(jstate.params, jstate.argmaxcost_ema)
        jstate, jm = jstep(jstate, jax_batch(batch))
        tstate, tm = tstep(tstate, torch_batch(batch))
        jm = dict(jm)
        jm["grad_norm"] = _restricted_norm(jgrads, jlabels)
        tm = ttrainer.host_metrics(tm)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=1e-3, err_msg=f"step {step}")
        assert_metrics_close({k: v for k, v in tm.items() if k != "grad_norm"},
                             {k: v for k, v in jm.items() if k != "grad_norm"})
        np.testing.assert_allclose(float(tstate.argmaxcost_ema),
                                   float(jstate.argmaxcost_ema), rtol=1e-5)
    assert tstate.step == 2 and int(jstate.step) == 2
    assert (float(tstate.argmaxcost_ema) >= 0) == (moe is not None)

    want = dict(topt.named_leaves(bridge(jstate.params, tcfg)))
    moved = 0
    for p, t in topt.named_leaves(tparams):
        if ttx.labels[p] == "frozen":
            assert not t.requires_grad and torch.equal(t, start[p]), p
            continue
        assert t.requires_grad, p
        diff = (t.detach() - want[p]).abs().flatten()
        assert float(diff.max()) <= 2.2 * LR * 2, p
        if diff.numel() >= 10:
            assert float(diff.kthvalue(int(0.9 * diff.numel())).values) \
                <= 0.05 * LR, p
        moved += bool((t.detach() != start[p]).any())
    assert moved >= 0.9 * len(ttx.trainable)
    if lora:
        # step 1 has lora_b = 0, so lora_a moves only in step 2
        leaves = dict(topt.named_leaves(tparams))
        assert bool(leaves["llama/layers/0/self_attn/q_proj/lora_b"].any())
        assert not torch.equal(
            leaves["llama/layers/0/self_attn/q_proj/lora_a"],
            start["llama/layers/0/self_attn/q_proj/lora_a"])


def test_create_train_state_marks_the_trainable_leaves():
    _, _, _, tparams = make_pair(moe=MOE)
    state, tx = ttrainer.create_train_state(
        tparams, topt.OptimizerConfig(tune_router=True))
    on = {p for p, t in topt.named_leaves(tparams) if t.requires_grad}
    assert on == set(tx.trainable) and on \
        and all(p.startswith("router") for p in on)
    assert set(state.opt_state["mu"]) == on
    assert state.params is tparams


def test_gradient_accumulation_updates_every_second_call():
    _, _, tcfg, tparams = make_pair()
    state, tx = ttrainer.create_train_state(
        tparams, topt.OptimizerConfig(learning_rate=LR, warmup_ratio=0.0,
                                      tune_mm_mlp_adapter=True))
    tx = topt.MultiSteps(tx, 2)
    state = state._replace(opt_state=tx.init(state.params))
    step = ttrainer.make_train_step(tcfg, tx, frozen_vision=True)
    w = tparams["mm_projector"]["layers"][0]["weight"]
    before = w.detach().clone()
    state, m = step(state, torch_batch(make_batch(seed=1)))
    assert torch.equal(w.detach(), before) and float(m["grad_norm"]) > 0
    state, _ = step(state, torch_batch(make_batch(seed=2)))
    assert not torch.equal(w.detach(), before)
    assert state.opt_state["inner"]["count"] == 1 and state.step == 2
