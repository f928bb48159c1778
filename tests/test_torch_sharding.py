"""PyTorch port: ``parallel/sharding.py``'s placements against the JAX
``param_shardings`` on the (4, 2) mesh, and ``generate`` over placed
weights (``shard_params`` on a (2, 1) mesh of two gloo ranks, and
``shard_model_for_inference`` at tp = 2) against the JAX greedy tokens.

The placements are a pure function of (path, shape, axis sizes), so they
are compared without a process group: every leaf of the port's tree (the
tiny model, with LoRA adapters, and with a router) against the JAX leaf it
came from, a per-layer leaf against the stacked JAX leaf less its leading
entry, a ``weight`` against the JAX ``(in, out)`` kernel transposed.  The
inference ranks get the bridged weights and the prompt in a file, block
``jax``, and return their tokens in a file; they must equal the JAX
tokens exactly (float32).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from matryoshka_mm_tpu.generate import GenerationConfig, generate
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.ops import lora as jlora
from matryoshka_mm_tpu.parallel import param_shardings as jax_shardings
from matryoshka_mm_tpu.parallel.sharding import _path_str
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.parallel import sharding as S
from matryoshka_mm_torch.train.optimizer import named_leaves
from tests.test_torch_train_step import bridge

REPO = Path(__file__).resolve().parents[1]
MOE = "t=dense_ft=cls_obj=weightedlm_loadb=switch_alpha=0.01"
_STACKED = ("llama/layers/", "vision_tower/layers/")


def _expected(jtree, mesh):
    """port path -> placements, from the JAX shardings of ``jtree``."""
    want = {}
    sh = jax_shardings(mesh, jtree)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        jpath = _path_str(path)
        spec = tuple(_spec_of(sh, path))
        spec = spec + (None,) * (np.ndim(leaf) - len(spec))
        stacked = jpath.startswith(_STACKED)
        if stacked:
            spec = spec[1:]
        if jpath.endswith("/kernel"):
            jpath, spec = jpath[:-len("kernel")] + "weight", spec[::-1]
        placements = tuple(Shard(spec.index(a)) if a in spec else Replicate()
                           for a in ("data", "model"))
        if stacked:
            head, _, tail = jpath.partition("/layers/")
            for i in range(np.shape(leaf)[0]):
                want[f"{head}/layers/{i}/{tail}"] = placements
        else:
            want[jpath] = placements
    return want


def _spec_of(tree, path):
    node = tree
    for k in path:
        node = node[getattr(k, "key", getattr(k, "idx", k))]
    return node.spec


def _trees():
    jcfg = JaxLlavaConfig.tiny_debug()
    tcfg = LlavaConfig.tiny_debug()
    plain = init_llava_params(jax.random.PRNGKey(0), jcfg)
    lora = jlora.add_lora(plain, jax.random.PRNGKey(1), r=4, alpha=8.0)
    jm, tm = JaxLlavaConfig.tiny_debug(moe=MOE), LlavaConfig.tiny_debug(
        moe=MOE)
    router = init_llava_params(jax.random.PRNGKey(0), jm)
    return {"tiny": (plain, tcfg), "lora": (lora, tcfg),
            "router": (router, tm)}


@pytest.mark.parametrize("name", ["tiny", "lora", "router"])
def test_placements_equal_the_jax_param_shardings(mesh8, name):
    jtree, tcfg = _trees()[name]
    want = _expected(jtree, mesh8)
    port = {p: S.placements_for(p, t.shape, {"data": 4, "model": 2})
            for p, t in named_leaves(bridge(jtree, tcfg))}
    assert set(port) == set(want)
    wrong = {p: (port[p], want[p]) for p in port if port[p] != want[p]}
    assert not wrong, wrong
    # a rule's axis on a dim that does not divide it falls back to
    # replicated: the (1, 1) LoRA scale under q_proj's ("model", "data")
    if name == "lora":
        p = "llama/layers/0/self_attn/q_proj/lora_scale"
        assert S.jax_spec(p, (1, 1), {"data": 4, "model": 2}) == (None, None)
        assert S.spec_for_path("llama/layers/self_attn/q_proj/lora_scale",
                               3) == (None, "model", "data")
        assert port[p] == (Replicate(), Replicate())
        assert port["llama/layers/1/self_attn/q_proj/lora_a"] == \
            (Shard(1), Shard(0))
        assert port["llama/layers/1/mlp/down_proj/lora_b"] == \
            (Shard(0), Shard(1))


def test_placements_rules_in_the_port_layout():
    sizes = {"data": 4, "model": 2}
    assert S.placements_for("llama/layers/3/self_attn/q_proj", (64, 64),
                            sizes) == (Shard(1), Shard(0))
    assert S.placements_for("llama/layers/3/self_attn/o_proj", (64, 64),
                            sizes) == (Shard(0), Shard(1))
    assert S.placements_for("llama/embed_tokens", (512, 64), sizes) == \
        (Shard(1), Shard(0))
    # the CLIP kernels are (in, out) in JAX, (out, in) here
    assert S.placements_for("vision_tower/layers/0/mlp/fc2/weight",
                            (32, 64), sizes) == (Shard(0), Shard(1))
    # no rule: dim -2 on data; a 1-dim leaf replicated; 3 rows on 4 ranks
    assert S.placements_for("router/fc1/weight", (16, 32), sizes) == \
        (Shard(1), Replicate())
    assert S.placements_for("llama/norm", (64,), sizes) == \
        (Replicate(), Replicate())
    assert S.placements_for("router/fc2/weight", (3, 16), sizes) == \
        (Shard(1), Replicate())
    assert S.placements_for("router/fc2/weight", (3, 6), sizes) == \
        (Replicate(), Replicate())


_RANK = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
import torch
torch.set_num_threads(2)    # ranks share the host's cores
from matryoshka_mm_torch.parallel import (initialize_distributed, make_mesh,
                                          shard_model_for_inference,
                                          shard_params)
from matryoshka_mm_torch.generate import GenerationConfig, generate
from matryoshka_mm_torch.config import LlavaConfig

tmp, rank = sys.argv[1], int(sys.argv[2])
initialize_distributed(backend="gloo", init_file=tmp + "/init", rank=rank,
                       world_size=2)
job = torch.load(tmp + "/job.pt", weights_only=False)
params, cfg = job["params"], job["cfg"]
out = {}
for spec in job["specs"]:
    kw = dict(matryoshka_vis_token_scale=spec,
              gen_cfg=GenerationConfig(max_new_tokens=job["new"]))
    m21 = make_mesh((2, 1), device_type="cpu")
    out["placed " + spec] = generate(shard_params(m21, params), cfg,
                                     job["ids"], job["px"], **kw).tolist()
    tp, tcfg, mesh = shard_model_for_inference(params, cfg, tp_size=2)
    assert tcfg.llama.attn_impl == "reference" and mesh.size(1) == 2
    out["tp " + spec] = generate(tp, tcfg, job["ids"], job["px"],
                                 **kw).tolist()
try:
    shard_model_for_inference(params, cfg, mesh=make_mesh(
        (2, 1), device_type="cpu"))
except ValueError as e:
    out["refused"] = str(e)
with open(f"{tmp}/out{rank}.json", "w") as f:
    json.dump(out, f)
"""


def start_ranks(script, tmp, world):
    """``script`` started on ``world`` fresh processes, ``argv = [tmp,
    rank]``, hash seed 0 (the debug tokenizer hashes words)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONHASHSEED="0")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    env.pop("WORLD_SIZE", None)
    return [subprocess.Popen([sys.executable, "-c", script, str(tmp),
                              str(r)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def wait_ranks(procs, timeout=240):
    """Wait for every process of ``procs``; each must exit 0.  A process
    still running after ``timeout`` seconds is killed."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]


def run_ranks(script, tmp, world, timeout=240):
    """:func:`start_ranks`, then :func:`wait_ranks`."""
    wait_ranks(start_ranks(script, tmp, world), timeout)


def test_generate_over_placed_weights_gives_the_jax_tokens(tmp_path):
    jcfg = JaxLlavaConfig.tiny_debug()
    jcfg = dataclasses.replace(jcfg, llama=dataclasses.replace(
        jcfg.llama, attn_impl="reference"))
    jp = init_llava_params(jax.random.PRNGKey(0), jcfg)
    ids = np.array([[5, 17, -200, 42, 9]], np.int32)
    px = np.random.default_rng(1).standard_normal(
        (1, 3, jcfg.vision.image_size, jcfg.vision.image_size)).astype(
        np.float32)
    specs = ["ver=v0_numtoks=4", "ver=v2_numtoks=[1,4]_betas=[0.5,0.5]"]
    want = {s: np.asarray(generate(
        jp, jcfg, ids, px, matryoshka_vis_token_scale=s,
        gen_cfg=GenerationConfig(max_new_tokens=6))).tolist() for s in specs}
    tcfg = LlavaConfig.tiny_debug().with_attn_impl("reference")
    torch.save({"params": bridge(jp, tcfg), "cfg": tcfg, "ids": ids,
                "px": px, "specs": specs, "new": 6}, tmp_path / "job.pt")
    run_ranks(_RANK, tmp_path, 2)
    for r in range(2):
        got = json.loads((tmp_path / f"out{r}.json").read_text())
        assert "must be (1, tp)" in got.pop("refused")
        for s in specs:
            assert got["placed " + s] == want[s], (r, s)
            assert got["tp " + s] == want[s], (r, s)
