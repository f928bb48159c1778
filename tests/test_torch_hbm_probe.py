"""PyTorch port, device-memory bandwidth probes on the CPU: the plain read
checksum against the JAX package's Pallas ``_read_once`` in interpret mode,
the copy's equality, and the rule that a time which is not positive raises.

The two checksums fold the array differently (the Pallas kernel keeps a
``(1, k)`` accumulator of the first 8 rows of every ``(bm, k)`` block, the
port one f32 per warp of its grid), so they are compared where both are
defined by the input alone: with ``bm = 8`` every row is folded, and both
must sum to ``reps`` times the sum of all bytes, exactly (integers below
2**24 in f32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import functools

import jax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from matryoshka_mm_tpu.ops.hbm_probe import _copy_kernel, _read_kernel
from matryoshka_mm_torch.ops import hbm_probe as thbm


def _read_once(x, bm, reps):
    """The JAX package's ``_read_once`` with its kernel and block specs, in
    interpret mode (the package's own call compiles for the TPU only)."""
    m, k = x.shape
    return pl.pallas_call(
        functools.partial(_read_kernel, n_blocks=m // bm, reps=reps),
        grid=(reps, m // bm),
        in_specs=[pl.BlockSpec((bm, k), lambda r, i: (i, 0))],
        out_specs=pl.BlockSpec((1, k), lambda r, i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, k), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, k), jnp.float32)],
        interpret=True)(x)


def _copy_once(x, bm, reps):
    m, k = x.shape
    return pl.pallas_call(
        _copy_kernel, grid=(reps, m // bm),
        in_specs=[pl.BlockSpec((bm, k), lambda r, i: (i, 0))],
        out_specs=pl.BlockSpec((bm, k), lambda r, i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, k), x.dtype),
        interpret=True)(x)


@pytest.mark.parametrize("m,k,reps", [(64, 128, 1), (64, 256, 3),
                                      (8, 2048, 2)])
def test_read_checksum_total_equals_pallas_interpret(m, k, reps):
    x = np.random.default_rng(m + k).integers(-127, 128, (m, k)).astype(
        np.int8)
    want = np.asarray(_read_once(jnp.asarray(x), bm=8, reps=reps))
    got = thbm.hbm_read(torch.from_numpy(x).reshape(-1), reps)
    assert got.dtype == torch.float32 and got.shape == (thbm.BLOCKS * 8,)
    assert float(got.double().sum()) == float(want.astype(np.float64).sum()) \
        == reps * int(x.astype(np.int64).sum())


def test_read_checksum_bins_vectors_by_thread_and_warp():
    """Vector i goes to thread i % T; a warp's 32 threads share a bin."""
    blocks = 2
    total = blocks * thbm.THREADS
    x = torch.zeros((3 * total + 5, 16), dtype=torch.int8)
    x[0, 0] = 7                 # thread 0 -> warp 0
    x[33, 3] = -2               # thread 33 -> warp 1
    x[total + 40, 15] = 5       # second round, thread 40 -> warp 1
    x[3 * total + 4, 1] = 1     # the ragged tail, thread 4 -> warp 0
    out = thbm.hbm_read_plain(x.reshape(-1), reps=2, blocks=blocks)
    want = torch.zeros(total // 32)
    want[0], want[1] = 2 * (7 + 1), 2 * (-2 + 5)
    assert torch.equal(out, want)


def test_copy_equals_input_and_pallas_interpret():
    x = np.random.default_rng(0).integers(-127, 128, (32, 128)).astype(np.int8)
    want = np.asarray(_copy_once(jnp.asarray(x), bm=8, reps=2))
    t = torch.from_numpy(x).reshape(-1)
    got = thbm.hbm_copy(t, reps=2)
    assert got.data_ptr() != t.data_ptr()
    np.testing.assert_array_equal(got.numpy().reshape(x.shape), want)
    np.testing.assert_array_equal(want, x)


@pytest.mark.parametrize("ms", [0.0, -0.25, float("nan")])
def test_time_that_is_not_positive_raises(ms):
    with pytest.raises(RuntimeError, match="not positive"):
        thbm.gb_per_s(1 << 20, ms)
    assert thbm.gb_per_s(3_000_000, 1.0) == pytest.approx(3.0)


def test_probe_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="int8"):
        thbm.hbm_read(torch.zeros(64, dtype=torch.uint8))
    with pytest.raises(ValueError, match="16 bytes"):
        thbm.hbm_copy(torch.zeros(65, dtype=torch.int8))
    with pytest.raises(ValueError, match="reps"):
        thbm.hbm_read(torch.zeros(64, dtype=torch.int8), reps=0)
    with pytest.raises(ValueError, match="5 runs"):
        thbm._time_runs(lambda: None, 1, runs=3)
