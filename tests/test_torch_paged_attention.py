"""PyTorch port, paged decode attention: the plain version (what the wrapper
runs on a CPU tensor) and the split plain version (the CUDA kernel's split
of a row's slots over the blocks of a cluster, in PyTorch) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs, and
against each other; the rule that picks the split.

Tolerances against JAX: float32 2e-5 (two f32 softmaxes summed in another
order); bf16 2e-2 (bf16 outputs, probabilities rounded to bf16 before PV);
int8 pools 3e-2 (the Pallas kernel rounds ``q * scale`` and the scaled
probabilities to bf16 for its matrix unit, the port keeps them in f32).
Split plain against plain: 1e-5 where the math is f32 (float32 and int8
pools: the same f32 sums in another order), 2e-2 in bf16 (the
probabilities are rounded to bf16 against another max)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged,
    paged_decode_attention_stacked as jax_paged_stacked)
from matryoshka_mm_torch.models.convert import _tensor
from matryoshka_mm_torch.ops.paged_attention import (
    paged_attention_plain, paged_attention_split_plain,
    paged_decode_attention, paged_decode_attention_stacked, paged_splits)

Dh, PAGE, NPAGES, P = 128, 16, 12, 4
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "int8": 3e-2}
SPLIT_TOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 1e-5}
SPLITS = (1, 2, 3, 4, 8)


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


CASES = [
    (2, 4, 4, (30, 50)),            # mid-page lengths
    (2, 4, 4, (15, 63)),            # the new token fills a page exactly
    (2, 4, 4, (16, 47)),            # ... or opens one
    (2, 4, 4, (0, 31)),             # a zero-length row (only the new token)
    (2, 4, 2, (20, 40)),            # GQA, group of 2
    (3, 8, 1, (0, 17, 62)),         # GQA, group of 8
]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("B,H,Hkv,row_lens", CASES)
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


def _args(q, k, v, ks, vs, tables, lens):
    return (_t(q), _t(k), _t(v), _t(tables), _t(lens), _t(ks), _t(vs))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("B,H,Hkv,row_lens", CASES)
def test_split_plain_matches_pallas_interpret(kind, B, H, Hkv, row_lens):
    """The kernel's split and merge, at every split, against the Pallas
    kernel on the cases above."""
    q, k, v, ks, vs, tables, lens = _case(len(row_lens) + H + Hkv, B, H, Hkv,
                                          row_lens, kind)
    want = np.asarray(jax_paged(_j(q), _j(k), _j(v), _j(tables), _j(lens),
                                k_scale=_j(ks), v_scale=_j(vs)),
                      dtype=np.float32)
    args = _args(q, k, v, ks, vs, tables, lens)
    for n in SPLITS:
        got = paged_attention_split_plain(*args, n_split=n)
        assert got.dtype == args[0].dtype and got.shape == (B, H, Dh)
        np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[kind],
                                   err_msg=f"n_split={n}")


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name,H,Hkv,row_lens", [
    # row_len 0: with 8 splits, 7 of them are empty and weigh 0
    ("empty row", 4, 4, (0, 0)),
    # the new token fills the row's second page exactly
    ("page boundary", 4, 4, (2 * PAGE - 1, PAGE - 1)),
    # rows of every length up to the table's capacity
    ("ragged", 4, 4, (1, 3 * PAGE + 5, P * PAGE - 1)),
    ("gqa 4", 8, 2, (5, 2 * PAGE + 3, P * PAGE - 1)),
])
def test_split_plain_matches_plain(kind, name, H, Hkv, row_lens):
    B = len(row_lens)
    q, k, v, ks, vs, tables, lens = _case(B + H, B, H, Hkv, row_lens, kind)
    args = _args(q, k, v, ks, vs, tables, lens)
    want = paged_attention_plain(*args).float()
    for n in SPLITS:
        got = paged_attention_split_plain(*args, n_split=n)
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   atol=SPLIT_TOL[kind], rtol=SPLIT_TOL[kind],
                                   err_msg=f"{name} n_split={n}")


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_split_plain_never_reads_past_the_row(kind):
    """A retired row (length 0, its table all the trash page 0) and garbage
    table entries past every row's last used page, ids outside the pool
    included: the split plain version reads none of them, so its output is
    that of a clean table, bit for bit, and the plain version's on it."""
    q, k, v, ks, vs, tables, lens = _case(11, 3, 4, 4, (0, 17, 40), kind)
    tables[0] = 0                                  # retired: the trash page
    clean = _args(q, k, v, ks, vs, tables, lens)
    garbage = tables.copy()
    garbage[1, 2:] = 10 ** 6                       # row 1 uses 2 pages
    garbage[2, 3:] = -5                            # row 2 uses 3 pages
    dirty = _args(q, k, v, ks, vs, garbage, lens)
    want = paged_attention_plain(*clean)
    for n in SPLITS:
        got = paged_attention_split_plain(*dirty, n_split=n)
        assert torch.equal(got,
                           paged_attention_split_plain(*clean, n_split=n))
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=SPLIT_TOL[kind], rtol=SPLIT_TOL[kind])


def test_split_plain_defaults_to_the_rule():
    q, k, v, ks, vs, tables, lens = _case(5, 2, 4, 4, (30, 50), "float32")
    args = _args(q, k, v, ks, vs, tables, lens)
    n = paged_splits(2, 4, P, PAGE)
    assert torch.equal(paged_attention_split_plain(*args),
                       paged_attention_split_plain(*args, n_split=n))


@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("Hkv", [1, 8, 32])
@pytest.mark.parametrize("P,page", [(1, 16), (4, 16), (25, 64), (18, 64),
                                    (2048, 16)])
def test_paged_splits_is_a_power_of_two_up_to_eight(B, Hkv, P, page):
    n = paged_splits(B, Hkv, P, page)
    assert n in (1, 2, 4, 8)
    # more rows never ask for more blocks a row
    assert paged_splits(2 * B, Hkv, P, page) <= n


def test_paged_splits_at_the_7b_shapes():
    """Hkv 32, page 64: 25 pages a row as in chip_smoke.py phase 6, 18 as the
    serving pool's ``pages_per_row`` (prefill_len 1024 + 128 new tokens);
    the card's 132 SMs."""
    for P in (25, 18):
        assert paged_splits(1, 32, P, 64) == 8
        assert paged_splits(8, 32, P, 64) == 2
        assert paged_splits(8, 32, P, 64, sms=132) == 2


@pytest.mark.parametrize("bad", [torch.tensor(8), np.int64(8), 8.0, True])
def test_paged_splits_takes_plain_ints_only(bad):
    """A device tensor (or anything but an int) is refused: the rule may
    not read, let alone sync on, what lies on the device."""
    with pytest.raises(TypeError):
        paged_splits(bad, 32, 25, 64)
    with pytest.raises(TypeError):
        paged_splits(8, 32, bad, 64)
