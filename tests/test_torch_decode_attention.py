"""PyTorch port: decode attention against the JAX package's
``flash_decode_attention`` / ``flash_decode_attention_stacked`` (Pallas,
interpret mode), and against ``attention_reference`` where the TPU kernel
cannot take the cache length.  Tolerance ``rtol=atol=2e-5`` as in
tests/test_decode_attention.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.ops.attention import attention_reference
from matryoshka_mm_tpu.ops.decode_attention import (
    flash_decode_attention as jax_decode,
    flash_decode_attention_stacked as jax_decode_stacked)
from matryoshka_mm_torch.ops import decode_attention as tdec

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, B, H, Hkv, S, Dh, *, layers=1, valid_frac=0.7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((layers, B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((layers, B, S, Hkv, Dh)).astype(np.float32)
    n_valid = max(1, int(S * valid_frac))
    valid = np.zeros((B, S), bool)
    valid[:, :n_valid] = True
    valid[-1, :3] = False                      # a left-padded row
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    q_pos = np.full((B,), n_valid - 1, np.int32)
    return q, k, v, valid, kv_pos, q_pos


def _port(q, k, v, valid, kv_pos, q_pos, window=None, layer=0):
    # the layer view of a stacked cache, as models/llama.py passes it
    return tdec.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k)[layer],
        torch.from_numpy(v)[layer], torch.from_numpy(valid),
        torch.from_numpy(kv_pos), torch.from_numpy(q_pos),
        sliding_window=window).numpy()


CASES = {
    # name: (B, H, Hkv, S, Dh, window)
    "mha": (2, 4, 4, 128, 32, None),
    "gqa": (3, 8, 2, 64, 16, None),
    "window": (1, 4, 4, 128, 32, 16),
    "several_blocks": (1, 4, 4, 512, 16, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_jax_kernel(name):
    B, H, Hkv, S, Dh, window = CASES[name]
    q, k, v, valid, kv_pos, q_pos = _case(len(name), B, H, Hkv, S, Dh)
    want = jax_decode(
        jnp.asarray(q), jnp.asarray(k[0]), jnp.asarray(v[0]),
        jnp.asarray(valid), jnp.asarray(kv_pos), jnp.asarray(q_pos),
        sliding_window=window, interpret=True)
    got = _port(q, k, v, valid, kv_pos, q_pos, window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_decode_matches_jax_stacked_at_layer_2():
    q, k, v, valid, kv_pos, q_pos = _case(9, 2, 4, 2, 64, 16, layers=3)
    want = jax_decode_stacked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(2),
        jnp.asarray(valid), jnp.asarray(kv_pos), jnp.asarray(q_pos),
        interpret=True)
    got = _port(q, k, v, valid, kv_pos, q_pos, layer=2)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("S,window", [(100, None), (37, 8)])
def test_ragged_cache_length_matches_reference(S, window):
    """S with no block divisor the TPU kernel accepts: compare with the
    JAX masked-softmax reference instead."""
    q, k, v, valid, kv_pos, q_pos = _case(S, 2, 4, 2, S, 16, valid_frac=0.9)
    want = attention_reference(
        jnp.asarray(q)[:, :, None, :], jnp.asarray(k[0]).transpose(0, 2, 1, 3),
        jnp.asarray(v[0]).transpose(0, 2, 1, 3), causal=True,
        q_positions=jnp.asarray(q_pos)[:, None],
        kv_positions=jnp.asarray(kv_pos), kv_valid=jnp.asarray(valid),
        sliding_window=window)[:, :, 0, :]
    got = _port(q, k, v, valid, kv_pos, q_pos, window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_row_without_valid_slot_is_zero():
    q, k, v, valid, kv_pos, q_pos = _case(4, 2, 4, 4, 32, 16)
    valid[0] = False
    got = _port(q, k, v, valid, kv_pos, q_pos)
    assert np.all(got[0] == 0) and np.all(np.isfinite(got))
