"""PyTorch port: prefill flash attention and the attention dispatch against
the JAX package (Pallas flash in interpret mode on the CPU).

The same numpy inputs, made from a seed, go through both.  Flash outputs
are compared on rows with at least one valid key; what a row with none
holds is no part of the contract (flash gives 0 there, the masked-softmax
reference the mean of V).  Tolerance ``atol=2e-3`` as in
tests/test_flash_attention.py; lse ``atol=1e-4``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.ops import attention as jattn
from matryoshka_mm_tpu.ops import flash_attention as jflash
from matryoshka_mm_torch.ops import attention as tattn
from matryoshka_mm_torch.ops import flash_attention as tflash


def _inputs(seed, B, H, Hkv, Sq, Sk, Dh=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, Dh)).astype(np.float32)
    return q, k, v


def _left_pad_valid(B, Sk, n_valid):
    valid = np.zeros((B, Sk), bool)
    for b, n in enumerate(n_valid):
        valid[b, :n] = True
    return valid


def _row_has_key(valid, Sq, Sk, causal, window, offset):
    rows = np.arange(Sq)[:, None] + offset
    cols = np.arange(Sk)[None, :]
    ok = valid[:, None, :].repeat(Sq, axis=1)
    if causal:
        ok &= cols <= rows
    if window:
        ok &= rows - cols < window
    return ok.any(axis=-1)                                     # (B, Sq)


CASES = {
    # name: (B, H, Hkv, Sq, Sk, causal, window, offset, valid rows per batch)
    "causal": (1, 2, 2, 64, 64, True, None, 0, None),
    "non_causal": (1, 2, 2, 64, 64, False, None, 0, None),
    "left_padding": (2, 2, 2, 48, 48, True, None, 0, "left"),
    "gqa": (2, 4, 2, 40, 40, True, None, 0, None),
    "window": (1, 4, 2, 64, 64, True, 16, 0, None),
    "q_index_offset": (1, 2, 2, 24, 96, True, None, 40, None),
    "prefill_into_larger_cache": (2, 4, 2, 64, 100, True, None, 0, "cache"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_matches_jax(name):
    B, H, Hkv, Sq, Sk, causal, window, offset, pad = CASES[name]
    q, k, v = _inputs(len(name), B, H, Hkv, Sq, Sk)
    if pad == "left":
        valid = np.ones((B, Sk), bool)
        valid[0, :7] = False
        valid[1, :19] = False
    elif pad == "cache":
        # a left-padded prompt in slots [0, Sq) of a cache of Sk slots
        valid = _left_pad_valid(B, Sk, [Sq, Sq])
        valid[1, :5] = False
    else:
        valid = np.ones((B, Sk), bool)

    want = jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_valid=jnp.asarray(valid), sliding_window=window,
        q_index_offset=offset)
    got = tflash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_valid=torch.from_numpy(valid),
        sliding_window=window, q_index_offset=offset)
    rows = _row_has_key(valid, Sq, Sk, causal, window, offset)   # (B, Sq)
    want = np.asarray(want).transpose(0, 2, 1, 3)[rows]
    got = got.numpy().transpose(0, 2, 1, 3)[rows]
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_jax(causal):
    B, H, Hkv, S = 2, 4, 2, 48
    q, k, v = _inputs(7, B, H, Hkv, S, S)
    valid = np.ones((B, S), bool)
    valid[1, :11] = False
    want_o, want_l = jflash.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_valid=jnp.asarray(valid))
    got_o, got_l = tflash.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_valid=torch.from_numpy(valid))
    rows = _row_has_key(valid, S, S, causal, None, 0)
    np.testing.assert_allclose(
        got_o.numpy().transpose(0, 2, 1, 3)[rows],
        np.asarray(want_o).transpose(0, 2, 1, 3)[rows], atol=2e-3)
    np.testing.assert_allclose(got_l.numpy().transpose(0, 2, 1)[rows],
                               np.asarray(want_l).transpose(0, 2, 1)[rows],
                               atol=1e-4)
    # a row with no valid key: output 0 and the masked lse
    if causal:
        assert np.all(got_o.numpy()[1, :, :11] == 0)
        assert np.all(got_l.numpy()[1, :, :11] == tflash.LSE_MASKED)


@pytest.mark.parametrize("mode", ["positions_window", "gqa_padding", "bias"])
def test_attention_reference_matches_jax(mode):
    B, H, Hkv, Sq, Sk = 2, 4, (2 if mode == "gqa_padding" else 4), 5, 12
    q, k, v = _inputs(11, B, H, Hkv, Sq, Sk, Dh=16)
    rng = np.random.default_rng(3)
    q_pos = np.tile(np.arange(7, 7 + Sq), (B, 1)).astype(np.int32)
    kv_pos = np.tile(np.arange(Sk), (B, 1)).astype(np.int32)
    valid = np.ones((B, Sk), bool)
    valid[1, :3] = False
    kw = dict(causal=True, q_positions=q_pos, kv_positions=kv_pos,
              kv_valid=valid,
              sliding_window=4 if mode == "positions_window" else None,
              bias=(rng.standard_normal((1, H, Sq, Sk)).astype(np.float32)
                    if mode == "bias" else None))
    want = jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: None if a is None else (jnp.asarray(a)
                                      if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()})
    got = tattn.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        impl="reference",
        **{n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_dispatch_routes_prefill_to_flash_and_decode_to_reference():
    """'auto' sends Sq > 1 to the flash plain version (fully masked rows
    give 0), Sq == 1 and 'reference' to the masked softmax (mean of V)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 2, 2, 8, 8))
    valid = torch.ones((1, 8), dtype=torch.bool)
    valid[0, :3] = False
    auto = tattn.attention(q, k, v, kv_valid=valid)
    ref = tattn.attention(q, k, v, kv_valid=valid, impl="reference")
    assert torch.all(auto[0, :, :3] == 0)
    torch.testing.assert_close(ref[0, :, 0], v[0, :].mean(dim=1))
    torch.testing.assert_close(auto[:, :, 3:], ref[:, :, 3:], atol=1e-5,
                               rtol=1e-5)
    one = tattn.attention(q[:, :, -1:], k, v, kv_valid=valid,
                          q_positions=torch.tensor([[7]]))
    torch.testing.assert_close(one, ref[:, :, -1:], atol=1e-6, rtol=1e-6)


def test_cpu_wrapper_never_counts_a_launch():
    before = tflash.flash_attention_lse.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 2, 16, 16))
    tflash.flash_attention(q, k, v)
    assert tflash.flash_attention_lse.launches == before
