"""PyTorch port: ``parallel/pipeline.py``'s ``pipelined_decoder`` over gloo
ranks against the JAX one on its 8-device CPU mesh, at
``LlamaConfig.tiny_debug`` (4 layers, float32): the hidden states for
(stages, microbatches) in (2, 2), (2, 4) and (4, 4), and, on every rank,
the gradient of ``sum(out ** 2)`` with respect to ``embeds`` and the
gradients of the rank's own stage's layers, against ``jax.grad`` through
the JAX pipeline.  One more case lays four ranks out as two pipelines of
two stages (mesh (2, 2)), the data dim; two cases recompute each layer in
the backward (``remat``).  Each rank is handed its stage's layers only
(``stage_params``), where the JAX function takes the whole stack.

Tolerances: the outputs ``2e-5``, the gradients ``5e-4`` (those of
``tests/test_pipeline.py``).  The ranks get the bridged parameters in a
file, block ``jax`` and return their results; the JAX side runs while
they work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.models.llama import embed_tokens
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.parallel.pipeline import (make_pp_mesh as jax_mesh,
                                                 pipelined_decoder as jax_pp)
from matryoshka_mm_torch.config import LlavaConfig
from tests.test_torch_sharding import start_ranks, wait_ranks
from tests.test_torch_train_step import bridge

B, L = 4, 8
# world: [(stages, microbatches, remat)]
CASES = {2: [(2, 2, False), (2, 4, True)],
         4: [(4, 4, True), (2, 2, False)]}


def _setup():
    jcfg = JaxLlavaConfig.tiny_debug()
    jp = init_llava_params(jax.random.PRNGKey(0), jcfg)
    ids = np.random.default_rng(0).integers(5, 100, (B, L)).astype(np.int32)
    embeds = embed_tokens(jp["llama"], jnp.asarray(ids))
    pos = jnp.broadcast_to(jnp.arange(L)[None], (B, L))
    valid = jnp.ones((B, L), bool)
    return jcfg, jp, embeds, pos, valid


def _jax_refs(jcfg, jp, embeds, pos, valid):
    """Per (stages, microbatches): the JAX pipeline's outputs and its
    gradients with respect to ``embeds`` and the stacked layers (one
    compiled call each)."""
    refs = {}
    for S, M in sorted({(S, M) for cases in CASES.values()
                        for S, M, _ in cases}):
        mesh = jax_mesh(S, devices=jax.devices()[:S])

        def loss(e, layers, mesh=mesh, M=M):
            p = dict(jp["llama"], layers=layers)
            out = jax_pp(p, jcfg.llama, e, pos, valid, mesh,
                         n_microbatches=M)
            return jnp.sum(out ** 2), out

        (_, out), (g_e, g_layers) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(embeds,
                                                 jp["llama"]["layers"])
        refs[(S, M)] = {"out": np.asarray(out), "g_embeds": np.asarray(g_e),
                        "g_layers": jax.tree.map(np.asarray, g_layers)}
    return refs


_RANK = r"""
import sys
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
import torch
torch.set_num_threads(2)    # ranks share the host's cores
import dataclasses
import torch.distributed as dist
from matryoshka_mm_torch.parallel import initialize_distributed
from matryoshka_mm_torch.parallel.pipeline import (make_pp_mesh,
                                                   pipelined_decoder,
                                                   stage_params)

tmp, rank = sys.argv[1], int(sys.argv[2])
job = torch.load(tmp + "/job.pt", weights_only=False)
initialize_distributed(backend="gloo", init_file=tmp + "/init", rank=rank,
                       world_size=job["world"])
results = {}
for S, M, remat in job["cases"]:
    mesh = make_pp_mesh(S, device_type="cpu")
    s = mesh.get_local_rank("stage")
    llama = job["params"]
    params = stage_params(llama, S, s)
    for lp in params["layers"]:
        for t in lp["self_attn"].values():
            t.grad = None
            t.requires_grad_(True)
    embeds = job["embeds"].clone().requires_grad_(True)
    cfg = dataclasses.replace(job["cfg"], remat=remat)
    out = pipelined_decoder(params, cfg, embeds, job["pos"],
                            job["valid"], mesh, n_microbatches=M)
    (out ** 2).sum().backward()
    results[(S, M, remat)] = {
        "out": out.detach(), "g_embeds": embeds.grad, "stage": s,
        "g_q": [lp["self_attn"]["q_proj"].grad.clone()
                for lp in params["layers"]]}
    for lp in llama["layers"]:
        for t in lp["self_attn"].values():
            t.requires_grad_(False)
every = [None] * dist.get_world_size()
dist.all_gather_object(every, results)
if rank == 0:
    torch.save(every, tmp + "/results.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started at once, the JAX side run while they work:
    ``(JAX references, {world: every rank's results})``."""
    jcfg, jp, embeds, pos, valid = _setup()
    tcfg = LlavaConfig.tiny_debug()
    llama = bridge(jp, tcfg)["llama"]
    procs, dirs = [], {}
    for world, cases in CASES.items():
        tmp = tmp_path_factory.mktemp(f"pp{world}")
        torch.save({"world": world, "cases": cases, "params": llama,
                    "cfg": tcfg.llama,
                    "embeds": torch.from_numpy(np.array(embeds)),
                    "pos": torch.from_numpy(np.array(pos)).long(),
                    "valid": torch.from_numpy(np.array(valid))},
                   tmp / "job.pt")
        dirs[world] = tmp
        procs += start_ranks(_RANK, tmp, world)
    try:
        refs = _jax_refs(jcfg, jp, embeds, pos, valid)
    finally:
        wait_ranks(procs)
    return refs, {w: torch.load(d / "results.pt", weights_only=False)
                  for w, d in dirs.items()}


_ALL = [(w, c) for w, cases in CASES.items() for c in cases]


@pytest.mark.parametrize("world,case", _ALL)
def test_pipeline_matches_the_jax_pipeline(worlds, world, case):
    refs, got = worlds
    want = refs[case[:2]]["out"]
    for rank in got[world]:
        np.testing.assert_allclose(rank[case]["out"].numpy(), want,
                                   atol=2e-5)


@pytest.mark.parametrize("world,case", _ALL)
def test_pipeline_gradients_on_every_rank(worlds, world, case):
    """Every rank holds the one-device gradient of ``embeds`` (not a sum
    over the stages) and the gradients of its stage's layers."""
    refs, got = worlds
    ref = refs[case[:2]]
    S = case[0]
    for rank in got[world]:
        r = rank[case]
        np.testing.assert_allclose(r["g_embeds"].numpy(), ref["g_embeds"],
                                   atol=5e-4)
        per = 4 // S
        for j, g in enumerate(r["g_q"]):
            want = ref["g_layers"]["self_attn"]["q_proj"][r["stage"] * per
                                                          + j]
            np.testing.assert_allclose(g.numpy(), want, atol=5e-4)
