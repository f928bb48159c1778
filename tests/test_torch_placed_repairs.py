"""PyTorch port: three cases on weights placed over a mesh of gloo ranks
that the JAX package computes and the port once refused, each against the
JAX package on its 8-device CPU mesh:

* MPT at a ``model`` axis above 1: the logits of the placed decoder and a
  LoRA step (adapters on ``Wqkv``, ``out_proj``, ``up_proj``,
  ``down_proj``) at meshes (1, 2) and (2, 2);
* a quantized base (``--bits 4`` and ``--bits 8``, the unfused layout) with
  LoRA: one step at (2, 1) and (1, 2) against the JAX step on one device,
  in ``tests/test_torch_placed_qlora.py`` through :func:`run_worlds`;
* the entry points on weights placed by ``shard_model_for_inference``:
  ``tests/test_torch_placed_generate.py``.

Each file starts worlds of its own, so that the three run side by side.

The ranks get the bridged parameters in a file, block ``jax`` and hand back
their results; the JAX side runs while they work.

Tolerances.  MPT (float32): ``loss`` and ``grad_norm`` ``2e-5`` relative,
the updated trainable leaves ``2e-5`` relative as one vector and each within
``1e-3`` of its largest element, logits ``1e-5`` absolute (the tolerances of
``tests/test_torch_sharded_train.py``).  The quantized recipes: ``loss``
``1e-4`` and ``grad_norm`` ``1e-3`` relative, the tolerances of the
one-device QLoRA parity in ``tests/test_torch_trainer.py`` (a bf16
dequantized weight times float32 activations, summed in another order),
the leaves ``2e-5`` relative as one vector and every element within
``0.05 * lr`` (that test's bound for nine elements in ten: a
zero-initialized projector bias holds one update, smaller than the
rounding of the sums).  ``adam_eps = 1`` makes Adam's first update near
``lr * g``, so the leaves can be compared.  The JAX ``grad_norm`` counts
the frozen base too, so it is recomputed over the trainable leaves on one
device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.models.builder import maybe_quantize
from matryoshka_mm_tpu.models.llama import llama_logits as jax_logits
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.ops import lora as jlora
from matryoshka_mm_tpu.ops.quant import disable_fused_proj as jdisable
from matryoshka_mm_tpu.parallel import batch_sharding, make_mesh, shard_params
from matryoshka_mm_tpu.train import optimizer as jopt
from matryoshka_mm_tpu.train import train_step as jts
from matryoshka_mm_tpu.train import trainer as jtrainer
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.train.optimizer import named_leaves
from tests.test_torch_optimizer import _jax_labels
from tests.test_torch_sharding import start_ranks, wait_ranks
from tests.test_torch_trainer import _restricted_norm
from tests.test_torch_train_step import bridge, jax_batch, make_batch

LR = 1e-3
MPT_LORA = r"(attn|ffn)/(Wqkv|[a-z_]*proj)$"
# case: (mesh shapes on two ranks, on four ranks, (loss rtol, grad_norm
# rtol, each updated leaf's tolerance: of its largest element, or an absolute
# one))
CASES = {"mpt": ([(1, 2)], [(2, 2)], (2e-5, 2e-5, ("of max", 1e-3))),
         "int4": ([(2, 1), (1, 2)], [], (1e-4, 1e-3, ("abs", 0.05 * LR))),
         "int8": ([(2, 1), (1, 2)], [], (1e-4, 1e-3, ("abs", 0.05 * LR)))}
LEAF_RTOL = 2e-5


def _cfgs(case):
    """(JAX config, port config) of a case: two layers of the tiny model;
    MPT ties its head to the embedding."""
    kw = dict(num_hidden_layers=2)
    if case == "mpt":
        kw.update(arch="mpt", tie_word_embeddings=True)
    j, t = JaxLlavaConfig.tiny_debug(), LlavaConfig.tiny_debug()
    return (dataclasses.replace(j, llama=dataclasses.replace(j.llama, **kw)),
            dataclasses.replace(t, llama=dataclasses.replace(t.llama,
                                                             remat=True,
                                                             **kw)))


def _seed_lora_b(tree, rng):
    if not isinstance(tree, dict):
        return tree
    if "lora_b" in tree:
        b = tree["lora_b"]
        return {**tree, "lora_b": jnp.asarray(rng.normal(0.0, 0.02, b.shape),
                                              b.dtype)}
    return {k: _seed_lora_b(v, rng) for k, v in tree.items()}


def _params(case):
    """(JAX config, JAX parameters, port config) of a training case: LoRA
    (r = 4) with every ``lora_b`` drawn from a seed (a zero start leaves
    every ``lora_a`` with a zero gradient)."""
    jcfg, tcfg = _cfgs(case)
    jp = init_llava_params(jax.random.PRNGKey(0), jcfg)
    kw = {}
    if case == "mpt":
        kw["target"] = MPT_LORA
    else:
        jp = maybe_quantize(dict(jp), load_8bit=case == "int8",
                            load_4bit=case == "int4", fuse=False)
    jp = jlora.add_lora(jp, jax.random.PRNGKey(1), r=4, alpha=8.0, **kw)
    return jcfg, _seed_lora_b(jp, np.random.default_rng(5)), tcfg


def _batch():
    b = make_batch(seed=7, B=4, T=24)
    b["labels"][2:, :21] = -100        # rows 2, 3: 3 labels; 0, 1: 12
    return b


def _opt():
    return dict(learning_rate=LR, warmup_ratio=0.0, total_steps=10,
                lora_enable=True, adam_eps=1.0)


def _jax_shape(case, shape):
    """The JAX placement a port mesh is held against: MPT's own mesh shape;
    one device for the quantized recipes (the JAX step's value does not
    depend on the mesh, and each compile costs seconds)."""
    return shape if case == "mpt" else None


def _jax_case(case, jcfg, jp, tcfg, batch):
    """The JAX step at each placement the case's meshes are held against
    (loss, updated trainable leaves in the port's layout), its grad_norm
    over the trainable leaves on one device, and for MPT the placed logits
    of the test's ids."""
    ocfg = jopt.OptimizerConfig(**_opt())
    two, four, _ = CASES[case]
    out = {}
    for shape in {_jax_shape(case, s) for s in two + four}:
        n = 1 if shape is None else shape[0] * shape[1]
        mesh = make_mesh(shape or (1, 1), devices=jax.devices()[:n])
        with mesh:
            placed = shard_params(mesh, jp)
            state, tx = jtrainer.create_train_state(placed, ocfg)
            b = jax.tree.map(lambda x: jax.device_put(
                x, batch_sharding(mesh)), jax_batch(batch))
            step = jtrainer.make_train_step(jcfg, tx, donate=False,
                                            frozen_vision=True)
            state, metrics = step(state, b)
            got = {"loss": float(metrics["loss"]),
                   "updated": dict(named_leaves(bridge(
                       jax.tree.map(np.asarray, state.params), tcfg)))}
            if case == "mpt":
                got["logits"] = np.asarray(jax_logits(
                    placed["llama"], jcfg.llama,
                    jnp.asarray(batch["input_ids"][:, 4:])))
        out[shape] = got
    with jdisable():
        grads = jax.jit(jax.grad(lambda p: jts.m3_loss(
            p, jcfg, jax_batch(batch), frozen_vision=True)[0],
            allow_int=True))(jp)
    out["grad_norm"] = _restricted_norm(grads, _jax_labels(jp, ocfg))
    return out


_RANK = r"""
import sys
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
import torch
torch.set_num_threads(2)    # ranks share the host's cores
from matryoshka_mm_torch.models.llama import llama_logits
from matryoshka_mm_torch.parallel import (initialize_distributed, make_mesh,
                                          put_batch)
from matryoshka_mm_torch.parallel.sharding import (compute_view, full_tree,
                                                   shard_params)
from matryoshka_mm_torch.train.optimizer import OptimizerConfig, named_leaves
from matryoshka_mm_torch.train.train_step import M3Batch
from matryoshka_mm_torch.train.trainer import (create_train_state,
                                               host_metrics, make_train_step)

tmp, rank = sys.argv[1], int(sys.argv[2])
job = torch.load(tmp + "/job.pt", weights_only=False)
initialize_distributed(backend="gloo", init_file=tmp + "/init", rank=rank,
                       world_size=job["world"])
batch = M3Batch(**job["batch"])
results = {}
for name, case in job["cases"].items():
    for shape in case["meshes"]:
        mesh = make_mesh(shape, device_type="cpu")
        placed = shard_params(mesh, case["params"])
        got = {}
        if case["cfg"].llama.arch == "mpt":
            view, vcfg = compute_view(placed, case["cfg"])
            with torch.no_grad():
                got["logits"] = llama_logits(view["llama"], vcfg.llama,
                                             batch.input_ids[:, 4:])
        state, tx = create_train_state(placed, OptimizerConfig(**job["opt"]))
        step = make_train_step(case["cfg"], tx, frozen_vision=True)
        state, m = step(state, M3Batch(*put_batch(mesh, tuple(batch))))
        leaves = dict(named_leaves(placed))
        got["metrics"] = host_metrics(m)
        got["leaves"] = full_tree({p: leaves[p] for p in tx.trainable})
        results[f"{name} {tuple(shape)}"] = got
if rank == 0:
    torch.save(results, tmp + "/results.pt")
import torch.distributed as dist
dist.destroy_process_group()
"""


def run_worlds(tmp_path_factory, names):
    """The cases ``names`` of CASES: a world of two ranks and one of four
    for each case that has meshes of that size, all started at once, the
    JAX references computed while they work.  Returns ``(JAX references,
    two-rank results, four-rank results)``, each rank's results by
    ``"case (mesh shape)"``."""
    batch = _batch()
    tb = {"input_ids": torch.from_numpy(batch["input_ids"]).long(),
          "pixel_values": torch.from_numpy(batch["pixel_values"]),
          "labels": torch.from_numpy(batch["labels"]).long(),
          "attn_mask": torch.from_numpy(batch["attn_mask"])}
    cases = {c: _params(c) for c in names}
    jobs, procs = {2: [], 4: []}, []
    for c, (_, jp, tcfg) in cases.items():
        for world, meshes in zip((2, 4), CASES[c]):
            if not meshes:
                continue
            tmp = tmp_path_factory.mktemp(f"{c}{world}")
            torch.save({"world": world, "batch": tb, "opt": _opt(),
                        "cases": {c: {"params": bridge(jp, tcfg),
                                      "cfg": tcfg, "meshes": meshes}}},
                       tmp / "job.pt")
            jobs[world].append(tmp)
            procs += start_ranks(_RANK, tmp, world)
    try:
        refs = {c: _jax_case(c, *cases[c], batch) for c in names}
    finally:
        wait_ranks(procs)
    return (refs, *({k: v for tmp in jobs[world] for k, v in torch.load(
        tmp / "results.pt", weights_only=False).items()} for world in (2, 4)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory, ["mpt"])


def _check_step(got, ref, grad_norm, rtol):
    m = got["metrics"]
    np.testing.assert_allclose(m["loss"], ref["loss"], rtol=rtol[0])
    np.testing.assert_allclose(m["grad_norm"], grad_norm, rtol=rtol[1])
    leaves = got["leaves"]
    assert any(p.endswith("lora_a") for p in leaves), sorted(leaves)
    diff = sum(float((leaves[p].double() - ref["updated"][p].double())
                     .square().sum()) for p in leaves)
    size = sum(float(ref["updated"][p].double().square().sum())
               for p in leaves)
    assert (diff / size) ** 0.5 <= LEAF_RTOL, (diff / size) ** 0.5
    kind, tol = rtol[2]
    for p, t in leaves.items():
        w = ref["updated"][p]
        err = float((t - w).abs().max())
        if kind == "of max":
            tol_p = tol * max(float(w.abs().max()), 1e-6)
        else:
            tol_p = tol
        assert err <= tol_p, (p, err, tol_p)


def check_case(worlds, case, shape):
    """A case's step at ``shape`` against the JAX step."""
    refs, two, four = worlds
    got = (four if shape == (2, 2) else two)[f"{case} {shape}"]
    _check_step(got, refs[case][_jax_shape(case, shape)],
                refs[case]["grad_norm"], CASES[case][2])


@pytest.mark.parametrize("case,shape", [("mpt", (1, 2)), ("mpt", (2, 2))])
def test_placed_lora_step_equals_the_jax_step(worlds, case, shape):
    check_case(worlds, case, shape)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_mpt_logits_on_a_model_axis_equal_the_jax_placement(worlds, shape):
    refs, two, four = worlds
    got = (four if shape == (2, 2) else two)[f"mpt {shape}"]["logits"]
    np.testing.assert_allclose(got.numpy(), refs["mpt"][shape]["logits"],
                               atol=1e-5, rtol=0)
