"""PyTorch port: train steps over a ``(data, model)`` mesh of gloo ranks
against the JAX one-device step, and ``train()`` at ``--tp_size 2``.

The tiny model (two decoder layers, 4 heads, float32) in two recipes: the
flagship M3-MoE objective (dense router on the CLS feature, weighted LM
loss, switch load balance) with every float leaf but the tower trained,
and LoRA (r = 4) over a frozen base, its ``lora_b`` drawn from a seed
(``add_lora`` starts it at 0, which leaves every ``lora_a`` with a zero
gradient, so a wrong split of ``lora_a`` would not show).  One batch of 4
rows whose last two rows keep their last 3 labels and the first two their
last 12, so that each data rank holds a different count and a rank-local
normalizer would show.  The test process hands the ranks the bridged
parameters in a file and runs the JAX steps while they work; the ranks
block ``jax`` and hand back their metrics and their updated trainable
leaves, gathered whole.

Tolerances: ``loss`` and ``grad_norm`` ``2e-5`` relative (the JAX test of
a sharded step against one device); the updated trainable leaves ``2e-5``
relative as one vector, and each leaf within ``1e-3`` of its largest
element (a zero-initialized bias holds one update, whose gradient sums
the batch with cancellation).  ``adam_eps = 1``: Adam's first update is
then near ``lr * g``, not ``lr * sign(g)``, so leaves can be compared at
all.  The JAX ``grad_norm`` of the LoRA recipe is recomputed over the
trainable leaves (the JAX step also counts the frozen base).  The JAX
side runs without remat, the ranks with it (the same function).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.ops import lora as jlora
from matryoshka_mm_tpu.train import optimizer as jopt
from matryoshka_mm_tpu.train import train_step as jts
from matryoshka_mm_tpu.train import trainer as jtrainer
from matryoshka_mm_torch.train.optimizer import named_leaves
from matryoshka_mm_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_sharding import (run_ranks, start_ranks,
                                       wait_ranks)
from tests.test_torch_train_entry import SCALES
from tests.test_torch_optimizer import _jax_labels
from tests.test_torch_trainer import _restricted_norm
from tests.test_torch_train_step import (bridge, jax_batch, make_batch,
                                         make_pair)

LR = 1e-3
RTOL = 2e-5
LEAF_TOL = 1e-3
RECIPES = {"moe": ("t=dense_ft=cls_obj=weightedlm_loadb=switch_alpha=0.01",
                   False),
           "lora": (None, True)}
EMA_MOE = ("t=dense_ft=cls_obj=weightedlm_loadb=argmaxcost_alpha=1.0"
           "_costt=numtoks_tval=0.5_emaa=0.9")


def _batch():
    b = make_batch(seed=7, B=4, T=24)
    b["labels"][2:, :21] = -100        # rows 2, 3: 3 labels; 0, 1: 12
    return b


def _seed_lora_b(tree, rng):
    """``tree`` with every ``lora_b`` drawn from ``rng``."""
    if not isinstance(tree, dict):
        return tree
    if "lora_b" in tree:
        b = tree["lora_b"]
        return {**tree, "lora_b": jnp.asarray(
            rng.normal(0.0, 0.02, b.shape), b.dtype)}
    return {k: _seed_lora_b(v, rng) for k, v in tree.items()}


def _opt_kw(lora):
    return dict(learning_rate=LR, warmup_ratio=0.0, total_steps=10,
                lora_enable=lora, adam_eps=1.0)


def _pair(recipe):
    """``(JAX cfg, JAX params, port cfg with remat)`` of a recipe."""
    moe, lora = RECIPES[recipe]
    jcfg, jparams, _, _ = make_pair(moe=moe)
    tcfg = make_pair(moe=moe, remat=True)[2]
    if lora:
        jparams = _seed_lora_b(jlora.add_lora(
            jparams, jax.random.PRNGKey(1), r=4, alpha=8.0),
            np.random.default_rng(5))
    return jcfg, jparams, tcfg


def _jax_step(recipe, jcfg, jparams, tcfg, batch):
    """The JAX one-device step: its loss, trainable grad norm and updated
    trainable leaves in the port's layout."""
    lora = RECIPES[recipe][1]
    ocfg = jopt.OptimizerConfig(**_opt_kw(lora))
    state, tx = jtrainer.create_train_state(jparams, ocfg)
    step = jtrainer.make_train_step(jcfg, tx, donate=False,
                                    frozen_vision=True)
    state, metrics = step(state, jax_batch(batch))
    grad_norm = float(metrics["grad_norm"])
    if lora:
        # the JAX step differentiates the frozen base too and counts it
        grads = jax.jit(jax.grad(lambda p: jts.m3_loss(
            p, jcfg, jax_batch(batch), frozen_vision=True)[0]))(jparams)
        grad_norm = _restricted_norm(grads, _jax_labels(jparams, ocfg))
    updated = dict(named_leaves(bridge(state.params, tcfg)))
    return {"loss": float(metrics["loss"]), "grad_norm": grad_norm,
            "updated": updated}


_RANK = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
import torch
torch.set_num_threads(2)    # ranks share the host's cores
import torch.distributed as dist
from matryoshka_mm_torch.parallel import (initialize_distributed, make_mesh,
                                          put_batch)
from matryoshka_mm_torch.parallel.sharding import full_tree, shard_params
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


def steps(case, shape, n=1):
    mesh = make_mesh(shape, device_type="cpu")
    placed = shard_params(mesh, case["params"])
    state, tx = create_train_state(placed, OptimizerConfig(**case["opt"]))
    step = make_train_step(case["cfg"], tx, frozen_vision=True)
    rows = M3Batch(*put_batch(mesh, tuple(batch)))
    before = {p: (t.placements, t.to_local().shape)
              for p, t in named_leaves(placed)}
    seen = []
    for _ in range(n):
        state, m = step(state, rows)
        seen.append((host_metrics(m), float(state.argmaxcost_ema)))
    after = {p: (t.placements, t.to_local().shape)
             for p, t in named_leaves(placed)}
    assert before == after, "placements changed"
    leaves = dict(named_leaves(placed))
    whole = full_tree({p: leaves[p] for p in tx.trainable})
    return seen, whole, mesh


for name, case in job["cases"].items():
    for shape in job["meshes"]:
        seen, whole, _ = steps(case, tuple(shape))
        results[f"{name} {tuple(shape)}"] = {"metrics": seen[0][0],
                                             "leaves": whole}
if "ema" in job:
    case = job["ema"]
    state, tx = create_train_state(case["params_one"],
                                   OptimizerConfig(**case["opt"]))
    one = make_train_step(case["cfg"], tx, frozen_vision=True)
    for _ in range(2):
        state, _ = one(state, batch)
    seen, _, mesh = steps(case, (2, 1), n=2)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, [e for _, e in seen])
    results["ema"] = {"ranks": every, "one": float(state.argmaxcost_ema)}
if "train" in job:
    from matryoshka_mm_torch.train import train as ttrain

    state = ttrain.train(argv=job["train"])
    results["train_step"] = state.step
    try:
        ttrain.train(argv=job["train"] + ["--dp_size", "2"])
    except ValueError as e:
        results["dp_refused"] = str(e)
if rank == 0:
    torch.save(results, tmp + "/results.pt")
dist.destroy_process_group()
"""


_ONE = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
import torch
torch.set_num_threads(2)    # ranks share the host's cores
from matryoshka_mm_torch.train import train as ttrain

tmp = sys.argv[1]
argv = json.loads(open(tmp + "/argv.json").read())
with open(tmp + "/out0.json", "w") as f:
    json.dump({"step": ttrain.train(argv=argv).step}, f)
"""


def _job(cases, tb, world, meshes):
    return {"world": world, "batch": tb, "meshes": meshes,
            "cases": {k: {"params": c["params"], "cfg": c["cfg"],
                          "opt": _opt_kw(c["lora"])}
                      for k, c in cases.items()}}


@pytest.fixture(scope="module")
def data_args(tmp_path_factory):
    """``tests/test_torch_train_entry.py``'s four-sample JSON and image."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("data")
    Image.new("RGB", (48, 48), (180, 40, 40)).save(tmp / "r.jpg")
    rows = [{"id": str(i), "image": "r.jpg", "conversations": [
        {"from": "human", "value": "<image>\nWrite a caption."},
        {"from": "gpt", "value": f"a red square number {i} " + "very " * i},
    ]} for i in range(4)]
    (tmp / "train.json").write_text(json.dumps(rows))
    return ["--model_name_or_path", "debug://tiny", "--data_path",
            str(tmp / "train.json"), "--image_folder", str(tmp),
            "--device", "cpu", "--learning_rate", "1e-3",
            "--model_max_length", "128", "--report_to", "none",
            "--matryoshka_vis_token_scale", SCALES]


@pytest.fixture(scope="module")
def worlds(data_args, tmp_path_factory):
    """Both worlds of ranks started at once, the JAX steps run while they
    work: ``(JAX references, two-rank results, the two-rank job, its
    directory, four-rank results)``.  Two ranks: every recipe at (2, 1)
    and (1, 2); two steps of the argmaxcost-EMA objective at (2, 1);
    ``train()`` at ``--tp_size 2``.  Four ranks: every recipe at
    (2, 2)."""
    batch = _batch()
    tb = {"input_ids": torch.from_numpy(batch["input_ids"]).long(),
          "pixel_values": torch.from_numpy(batch["pixel_values"]),
          "labels": torch.from_numpy(batch["labels"]).long(),
          "attn_mask": torch.from_numpy(batch["attn_mask"])}
    pairs = {r: _pair(r) for r in RECIPES}
    cases = {r: {"params": bridge(jp, tcfg), "cfg": tcfg,
                 "lora": RECIPES[r][1]} for r, (_, jp, tcfg) in pairs.items()}
    tmp2 = tmp_path_factory.mktemp("world2")
    job = _job(cases, tb, 2, [(2, 1), (1, 2)])
    _, _, tcfg, tparams = make_pair(moe=EMA_MOE, remat=True)
    job["ema"] = {"params": tparams, "cfg": tcfg, "opt": _opt_kw(False),
                  "params_one": copy.deepcopy(tparams)}
    job["train"] = data_args + [
        "--version", "v1", "--lora_enable", "True", "--lora_r", "4",
        "--lora_alpha", "8", "--max_steps", "2", "--output_dir",
        str(tmp2 / "tp"), "--per_device_train_batch_size", "2",
        "--tp_size", "2", "--moe", RECIPES["moe"][0]]
    torch.save(job, tmp2 / "job.pt")
    tmp4 = tmp_path_factory.mktemp("world4")
    torch.save(_job(cases, tb, 4, [(2, 2)]), tmp4 / "job.pt")
    procs = start_ranks(_RANK, tmp2, 2) + start_ranks(_RANK, tmp4, 4)
    try:
        refs = {r: _jax_step(r, *pairs[r], batch) for r in RECIPES}
    finally:
        wait_ranks(procs)
    return (refs, torch.load(tmp2 / "results.pt", weights_only=False), job,
            tmp2, torch.load(tmp4 / "results.pt", weights_only=False))


def _check(got, ref):
    m = got["metrics"]
    np.testing.assert_allclose(m["loss"], ref["loss"], rtol=RTOL)
    np.testing.assert_allclose(m["grad_norm"], ref["grad_norm"], rtol=RTOL)
    leaves = got["leaves"]
    assert leaves, "no trainable leaves"
    diff = sum(float((leaves[p].double() - ref["updated"][p].double())
                     .square().sum()) for p in leaves)
    size = sum(float(ref["updated"][p].double().square().sum())
               for p in leaves)
    assert (diff / size) ** 0.5 <= RTOL, (diff / size) ** 0.5
    for p, t in leaves.items():
        w = ref["updated"][p]
        err = float((t - w).abs().max())
        assert err <= LEAF_TOL * max(float(w.abs().max()), 1e-6), (p, err)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_steps_on_two_ranks_equal_the_jax_step(worlds, recipe, shape):
    _check(worlds[1][f"{recipe} {shape}"], worlds[0][recipe])


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_steps_on_a_2x2_mesh_equal_the_jax_step(worlds, recipe):
    _check(worlds[4][f"{recipe} (2, 2)"], worlds[0][recipe])


def test_argmaxcost_ema_stays_equal_on_every_rank(worlds):
    ema = worlds[1]["ema"]
    first, second = zip(*ema["ranks"])
    assert len(set(first)) == 1 and len(set(second)) == 1, ema
    assert 0 <= first[0] <= 1 and second[0] != first[0]
    np.testing.assert_allclose(second[0], ema["one"], rtol=1e-5)


def test_train_at_tp_size_2_saves_the_one_process_lora(worlds, tmp_path):
    _, results, job, tmp, _ = worlds
    assert results["train_step"] == 2
    # two ranks at tp_size 2 leave one data rank
    assert "dp_size=2 != 2 ranks // tp_size=2" in results["dp_refused"]
    argv = list(job["train"])
    i = argv.index("--tp_size")
    del argv[i:i + 2]
    argv[argv.index("--output_dir") + 1] = str(tmp_path / "one")
    # one process, at the ranks' hash seed (the debug tokenizer hashes
    # words)
    (tmp_path / "argv.json").write_text(json.dumps(argv))
    run_ranks(_ONE, tmp_path, 1)
    assert json.loads((tmp_path / "out0.json").read_text())["step"] == 2
    got, cfg = load_checkpoint(str(tmp / "tp"), device="cpu")
    want, _ = load_checkpoint(str(tmp_path / "one"), device="cpu")
    assert set(got) == set(want) == {"lora", "mm_projector", "router"}
    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    assert set(got) == set(want)
    # Adam divides by sqrt(v): an element whose gradient is rounding noise
    # moves by up to lr; 1% of the two steps' rate is the absolute slack
    for p, w in want.items():
        assert got[p].dtype == w.dtype == torch.float32, p
        torch.testing.assert_close(got[p], w, rtol=1e-4, atol=2 * 0.01 * LR,
                                   msg=p)
    with open(tmp / "tp" / "meta.json") as f:
        assert json.load(f) == {"step": 2, "lora_only": True}
