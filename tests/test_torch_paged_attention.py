"""PyTorch port, paged decode attention: the plain version (what the wrapper
runs on a CPU tensor) against the JAX package's Pallas kernels in interpret
mode, on the same numpy inputs.

Tolerances: float32 2e-5 (two f32 softmaxes summed in another order); bf16
2e-2 (bf16 outputs, probabilities rounded to bf16 before PV); int8 pools
3e-2 (the Pallas kernel rounds ``q * scale`` and the scaled probabilities to
bf16 for its matrix unit, the port keeps them in f32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged,
    paged_decode_attention_stacked as jax_paged_stacked)
from matryoshka_mm_torch.models.convert import _tensor
from matryoshka_mm_torch.ops.paged_attention import (
    paged_attention_plain, paged_decode_attention,
    paged_decode_attention_stacked)

Dh, PAGE, NPAGES, P = 128, 16, 12, 4
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "int8": 3e-2}


def _quant(x):
    """per-(slot, head) absmax int8 quantization over the last dim."""
    s = np.maximum(np.abs(x).max(axis=-1) / 127.0, 1e-8)
    q = np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def _case(seed, B, H, Hkv, row_lens, kind, layers=None):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal(lead + (NPAGES, PAGE, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal(lead + (NPAGES, PAGE, Hkv, Dh)).astype(np.float32)
    tables = rng.permutation(NPAGES)[:B * P].reshape(B, P).astype(np.int32)
    ks = vs = None
    if kind == "int8":
        (k, ks), (v, vs) = _quant(k), _quant(v)
    elif kind == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))
    return q, k, v, ks, vs, tables, np.asarray(row_lens, np.int32)


def _t(a):
    return None if a is None else _tensor(a, "cpu", None)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("B,H,Hkv,row_lens", [
    (2, 4, 4, (30, 50)),            # mid-page lengths
    (2, 4, 4, (15, 63)),            # the new token fills a page exactly
    (2, 4, 4, (16, 47)),            # ... or opens one
    (2, 4, 4, (0, 31)),             # a zero-length row (only the new token)
    (2, 4, 2, (20, 40)),            # GQA, group of 2
    (3, 8, 1, (0, 17, 62)),         # GQA, group of 8
])
def test_plain_matches_pallas_interpret(kind, B, H, Hkv, row_lens):
    q, k, v, ks, vs, tables, lens = _case(len(row_lens) + H + Hkv, B, H, Hkv,
                                          row_lens, kind)
    want = np.asarray(jax_paged(_j(q), _j(k), _j(v), _j(tables), _j(lens),
                                k_scale=_j(ks), v_scale=_j(vs)),
                      dtype=np.float32)
    args = (_t(q), _t(k), _t(v), _t(tables), _t(lens), _t(ks), _t(vs))
    got = paged_attention_plain(*args)
    assert got.dtype == args[0].dtype and got.shape == (B, H, Dh)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[kind])
    # on a CPU tensor the wrapper IS the plain version
    assert torch.equal(paged_decode_attention(*args), got)


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_stacked_matches_pallas_interpret(kind):
    """The layer-indexed form picks the right layer's pools; the int8 scales
    come flat ``(L, n_pages, page * Hkv)`` as the JAX package stores them."""
    L, B, H, Hkv = 3, 2, 4, 2
    q, k, v, ks, vs, tables, lens = _case(7, B, H, Hkv, (22, 47), kind,
                                          layers=L)
    flat = (lambda s: None if s is None
            else s.reshape(L, NPAGES, PAGE * Hkv))
    for l in range(L):
        want = np.asarray(jax_paged_stacked(
            _j(q), _j(k), _j(v), jnp.asarray(l, jnp.int32), _j(tables),
            _j(lens), k_scale=_j(ks), v_scale=_j(vs)))
        got = paged_decode_attention_stacked(
            _t(q), _t(k), _t(v), l, _t(tables), _t(lens), _t(flat(ks)),
            _t(flat(vs)))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL[kind])


def test_plain_ignores_pages_past_the_row_and_other_rows():
    """Garbage in slots past ``row_len + 1`` and in other rows' pages does
    not change a row's output."""
    q, k, v, _, _, tables, lens = _case(3, 2, 4, 4, (17, 40), "float32")
    base = paged_attention_plain(_t(q), _t(k), _t(v), _t(tables), _t(lens))
    k2, v2 = k.copy(), v.copy()
    k2[tables[0, 1], 2:] = 1e4            # row 0 holds 18 slots: 16 + 2
    v2[tables[0, 2:]] = -1e4
    got = paged_attention_plain(_t(q), _t(k2), _t(v2), _t(tables), _t(lens))
    np.testing.assert_array_equal(got.numpy(), base.numpy())
