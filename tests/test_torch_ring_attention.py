"""PyTorch port: ``parallel/ring_attention.py``'s ``ring_attention`` over
gloo ranks against the JAX one on its 8-device CPU mesh, case for case as
``tests/test_ring_attention.py`` holds the JAX function against the
reference: 2 and 4 ranks, causal and not, a padded tail, ``use_flash=True``
(the port's flash plain version against the JAX Pallas kernel in interpret
mode) and the gradient of ``sum(out ** 2)`` with respect to the one input
that is ``q``, ``k`` and ``v`` at once.  Rank ``i`` holds block ``i`` of the
sequence; its block of the output (and of the gradient) is held against
the same rows of JAX's.

Tolerances, those of ``tests/test_ring_attention.py``: the default path
``2e-5``, the flash path ``2e-4``, the gradient ``5e-5``.  Dh is 8 as there
(the JAX interpret-mode flash forward gives NaN on a row with no key at
Dh 16 and 64; no row here is keyless).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from matryoshka_mm_tpu.parallel.ring_attention import (
    ring_attention as jax_ring)
from tests.test_torch_sharding import start_ranks, wait_ranks

# name: (ranks, (B, H, S, Dh), causal, valid up to, use_flash, seed)
CASES = {
    "n2 causal": (2, (2, 2, 32, 8), True, None, False, 0),
    "n4 causal": (4, (2, 2, 32, 8), True, None, False, 0),
    "n4 full": (4, (2, 2, 32, 8), False, None, False, 0),
    "n4 padded": (4, (1, 2, 16, 8), True, 12, False, 1),
    "flash n2 causal": (2, (1, 2, 512, 8), True, None, True, 3),
    "flash n4 causal": (4, (1, 2, 512, 8), True, None, True, 3),
    "flash n4 full": (4, (1, 2, 512, 8), False, None, True, 3),
    "flash n2 padded": (2, (1, 1, 256, 8), True, 200, True, 4),
}
GRAD = (2, (1, 1, 16, 8), 2)          # ranks, shape, seed
TOL = {False: 2e-5, True: 2e-4}


def _inputs(shape, seed, valid_to, same):
    """q, k, v (one tensor thrice when ``same``, as the JAX tests pass the
    padded and gradient cases) and kv_valid, float32."""
    rng = np.random.default_rng(seed)
    n = 1 if same else 3
    qkv = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    if same:
        qkv = qkv * 3
    valid = np.ones((shape[0], shape[2]), bool)
    if valid_to is not None:
        valid[:, valid_to:] = False
    return qkv, valid


def _jax_refs():
    refs = {}
    for name, (n, shape, causal, valid_to, flash, seed) in CASES.items():
        qkv, valid = _inputs(shape, seed, valid_to, valid_to is not None)
        mesh = Mesh(np.asarray(jax.devices()[:n]), axis_names=("seq",))
        refs[name] = np.asarray(jax_ring(
            *map(jnp.asarray, qkv), mesh, causal=causal,
            kv_valid=None if valid_to is None else jnp.asarray(valid),
            use_flash=flash))
    n, shape, seed = GRAD
    (x, _, _), _ = _inputs(shape, seed, None, True)
    mesh = Mesh(np.asarray(jax.devices()[:n]), axis_names=("seq",))
    refs["grad"] = np.asarray(jax.grad(lambda t: jnp.sum(
        jax_ring(t, t, t, mesh, causal=True) ** 2))(jnp.asarray(x)))
    return refs


_RANK = r"""
import sys
sys.modules["jax"] = None
sys.modules["matryoshka_mm_tpu"] = None
import torch
torch.set_num_threads(2)    # ranks share the host's cores
import torch.distributed as dist
from matryoshka_mm_torch.parallel import initialize_distributed, make_mesh
from matryoshka_mm_torch.parallel import ring_attention as R

calls = [0]
flash = R.flash_attention_lse


def counted(*a, **kw):
    calls[0] += 1
    return flash(*a, **kw)


R.flash_attention_lse = counted

tmp, rank = sys.argv[1], int(sys.argv[2])
job = torch.load(tmp + "/job.pt", weights_only=False)
n = job["world"]
initialize_distributed(backend="gloo", init_file=tmp + "/init", rank=rank,
                       world_size=n)
mesh = make_mesh((1, n), axis_names=("data", "seq"), device_type="cpu")
i = mesh.get_local_rank("seq")


def block(t, dim):
    return t.chunk(n, dim=dim)[i].contiguous()


results = {}
for name, (qkv, valid, causal, use_flash, padded) in job["cases"].items():
    q, k, v = (block(t, 2) for t in qkv)
    calls[0] = 0
    results[name] = R.ring_attention(
        q, k, v, mesh, causal=causal, use_flash=use_flash,
        kv_valid=block(valid, 1) if padded else None)
    results[name + " calls"] = calls[0]
if "grad" in job:
    x = block(job["grad"], 2).requires_grad_(True)
    out = R.ring_attention(x, x, x, mesh, causal=True)
    (out ** 2).sum().backward()
    results["grad"] = x.grad
every = [None] * n
dist.all_gather_object(every, results)
if rank == 0:
    torch.save(every, tmp + "/results.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and 4 ranks started at once, the JAX side run while
    they work: ``(JAX references, {world: every rank's results})``."""
    procs, dirs = [], {}
    for world in (2, 4):
        cases = {}
        for name, (n, shape, causal, valid_to, flash, seed) in CASES.items():
            if n != world:
                continue
            qkv, valid = _inputs(shape, seed, valid_to, valid_to is not None)
            cases[name] = ([torch.from_numpy(t) for t in qkv],
                           torch.from_numpy(valid), causal, flash,
                           valid_to is not None)
        job = {"world": world, "cases": cases}
        if world == GRAD[0]:
            (x, _, _), _ = _inputs(GRAD[1], GRAD[2], None, True)
            job["grad"] = torch.from_numpy(x)
        tmp = tmp_path_factory.mktemp(f"ring{world}")
        torch.save(job, tmp / "job.pt")
        dirs[world] = tmp
        procs += start_ranks(_RANK, tmp, world)
    try:
        refs = _jax_refs()
    finally:
        wait_ranks(procs)
    return refs, {w: torch.load(d / "results.pt", weights_only=False)
                  for w, d in dirs.items()}


def _whole(ranks, name, dim=2):
    return torch.cat([r[name] for r in ranks], dim=dim).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_the_jax_ring(worlds, name):
    refs, got = worlds
    n, shape, causal, valid_to, flash, _ = CASES[name]
    out, want = _whole(got[n], name), refs[name]
    assert out.shape == tuple(shape)
    if valid_to is not None:       # the rows the JAX tests hold
        out, want = out[:, :, :valid_to], want[:, :, :valid_to]
    np.testing.assert_allclose(out, want, atol=TOL[flash])


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_flash_blocks_by_rank(worlds, name):
    """The flash path runs a block on rank i for each earlier block and its
    own (i + 1 causal), for every block otherwise (n); the default path
    none."""
    _, got = worlds
    n, _, causal, _, flash, _ = CASES[name]
    want = [(i + 1 if causal else n) if flash else 0 for i in range(n)]
    assert [r[name + " calls"] for r in got[n]] == want


def test_ring_gradients_match_jax(worlds):
    refs, got = worlds
    np.testing.assert_allclose(_whole(got[GRAD[0]], "grad"), refs["grad"],
                               atol=5e-5)
