"""PyTorch port: decode attention against the JAX package's
``flash_decode_attention`` / ``flash_decode_attention_stacked`` (Pallas,
interpret mode), and against ``attention_reference`` where the TPU kernel
cannot take the cache length.  Tolerance ``rtol=atol=2e-5`` as in
tests/test_decode_attention.py.

The kernel splits a row's slots over ``n_split`` blocks and merges their
softmax states; ``decode_attention_split_plain`` does the same in PyTorch
and is held here against the whole-row plain version and the JAX kernels
at every ``n_split`` (float32, the same tolerance: only the order of the
f32 sums moves), with a split that is wholly masked, a row with no valid
slot, a ragged S, a window and the int8 cache (against the JAX int8
kernel ``0.05``, as tests/test_torch_quant_kernels.py: the TPU kernel
rounds q and the scaled probabilities to bf16).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.models.llama import _quantize_kv_slots as jax_kv_slots
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


def _split(q, k, v, valid, kv_pos, q_pos, n_split, window=None, layer=0,
           **kw):
    return tdec.decode_attention_split_plain(
        torch.from_numpy(q), torch.from_numpy(k)[layer],
        torch.from_numpy(v)[layer], torch.from_numpy(valid),
        torch.from_numpy(kv_pos), torch.from_numpy(q_pos),
        sliding_window=window, n_split=n_split, **kw).numpy()


@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
def test_split_plain_matches_jax_kernel_and_plain(n_split):
    """Row 0: its first 31 slots invalid and its last split wholly masked;
    row 1: no valid slot at all (gives 0); row 2 as ``_case`` makes it."""
    B, H, Hkv, S, Dh = 3, 4, 2, 512, 32
    q, k, v, valid, kv_pos, q_pos = _case(n_split, B, H, Hkv, S, Dh,
                                          valid_frac=1.0)
    valid[0, :31] = False
    if n_split > 1:          # (with one split the row would have no slot)
        valid[0, tdec.split_ranges(S, n_split)[-1][0]:] = False
    valid[1] = False
    want = jax_decode_stacked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(0),
        jnp.asarray(valid), jnp.asarray(kv_pos), jnp.asarray(q_pos),
        interpret=True)
    got = _split(q, k, v, valid, kv_pos, q_pos, n_split)
    assert np.all(got[1] == 0) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got[[0, 2]], np.asarray(want)[[0, 2]], **TOL)
    np.testing.assert_allclose(got, _port(q, k, v, valid, kv_pos, q_pos),
                               **TOL)


@pytest.mark.parametrize("n_split", [2, 8])
def test_split_plain_with_a_window_matches_jax_kernel(n_split):
    q, k, v, valid, kv_pos, q_pos = _case(3, 2, 4, 4, 256, 32)
    want = jax_decode(
        jnp.asarray(q), jnp.asarray(k[0]), jnp.asarray(v[0]),
        jnp.asarray(valid), jnp.asarray(kv_pos), jnp.asarray(q_pos),
        sliding_window=40, interpret=True)
    got = _split(q, k, v, valid, kv_pos, q_pos, n_split, window=40)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("n_split", [3, 4])
def test_split_plain_on_a_ragged_cache_matches_reference(n_split):
    S = 301
    q, k, v, valid, kv_pos, q_pos = _case(S, 2, 4, 2, S, 16, valid_frac=0.9)
    want = attention_reference(
        jnp.asarray(q)[:, :, None, :], jnp.asarray(k[0]).transpose(0, 2, 1, 3),
        jnp.asarray(v[0]).transpose(0, 2, 1, 3), causal=True,
        q_positions=jnp.asarray(q_pos)[:, None],
        kv_positions=jnp.asarray(kv_pos), kv_valid=jnp.asarray(valid)
    )[:, :, 0, :]
    got = _split(q, k, v, valid, kv_pos, q_pos, n_split)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("n_split", [1, 4])
def test_split_plain_int8_cache_matches_jax_kernel(n_split):
    B, H, Hkv, S, Dh = 2, 4, 2, 256, 128
    rng = np.random.default_rng(n_split)
    q = jnp.asarray(rng.standard_normal((B, H, Dh)), jnp.float32) * 0.3
    k = jnp.asarray(rng.standard_normal((1, B, S, Hkv, Dh)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((1, B, S, Hkv, Dh)), jnp.float32)
    kq, ks = (np.asarray(a[0]) for a in jax_kv_slots(k))
    vq, vs = (np.asarray(a[0]) for a in jax_kv_slots(v))
    valid = np.ones((B, S), bool)
    valid[0, :40] = False
    if n_split > 1:
        valid[0, tdec.split_ranges(S, n_split)[-1][0]:] = False
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    q_pos = np.full((B,), S - 1, np.int32)
    qb = q.astype(jnp.bfloat16)
    want = jax_decode(qb, jnp.asarray(kq), jnp.asarray(vq),
                      jnp.asarray(valid), jnp.asarray(kv_pos),
                      jnp.asarray(q_pos), k_scale=jnp.asarray(ks),
                      v_scale=jnp.asarray(vs), interpret=True)
    t = torch.from_numpy
    args = (torch.tensor(np.asarray(qb.astype(jnp.float32))).bfloat16(),
            t(kq), t(vq), t(valid), t(kv_pos), t(q_pos))
    got = tdec.decode_attention_split_plain(*args, k_scale=t(ks),
                                            v_scale=t(vs), n_split=n_split)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - np.asarray(want, np.float32)).max() \
        < 0.05
    whole = tdec.decode_attention_plain(*args, k_scale=t(ks), v_scale=t(vs))
    torch.testing.assert_close(got.float(), whole.float(), atol=2e-2,
                               rtol=2e-2)


def test_split_rule_takes_4_at_batch_one_and_never_a_short_split():
    """7B at B = 1 (32 kv heads, 672 slots): 4 splits, 128 blocks; at B = 4
    2 splits (256 blocks, two an SM); a split never holds fewer than 64
    slots (128 by the rule), n_split is a power of two up to 8 and the
    blocks stay within two an SM."""
    assert tdec.decode_splits(1, 32, 672) == 4
    assert tdec.decode_splits(4, 32, 672) == 2
    assert tdec.decode_splits(1, 32, 4096) == 8
    assert tdec.decode_splits(1, 32, 40) == tdec.decode_splits(1, 32, 255) == 1
    for B in (1, 2, 3, 4, 8):
        for Hkv in (1, 2, 8, 32):
            for S in (1, 63, 64, 65, 127, 128, 129, 300, 513, 672, 4096):
                n = tdec.decode_splits(B, Hkv, S)
                assert n in (1, 2, 4, 8)
                assert n == 1 or B * Hkv * n <= 2 * tdec.H100_SMS
                sizes = [e - a for a, e in tdec.split_ranges(S, n)]
                assert sum(sizes) == S
                assert n == 1 or min(sizes) >= 64
