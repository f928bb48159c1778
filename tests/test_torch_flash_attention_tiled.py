"""PyTorch port: the tile walk of the tensor-core flash forward kernel.

``flash_attention_tiled_plain`` walks 64-row q tiles over 64-key kv tiles
with the kernel's loop bounds, its rule for which tiles run the
per-element mask, its online-softmax order and its bf16 rounding of P.
The cases put it where such a walk goes wrong: sequence lengths around one
and two tiles, a padding longer than a tile (whole kv tiles without a
valid slot, q tiles whose rows see no key), windows inside one tile and
across several, ``q_index_offset`` with ``Sq != Sk``, GQA, causal and not.

Against the whole-matrix ``flash_attention_plain``: float32 ``atol=1e-5``
(the same products, summed tile by tile); bfloat16 ``atol=2e-3`` plus one
bf16 unit of the value (``rtol=2**-7``: both round their f32 result to
bf16, and P is rounded against the running max here and against the row's
max there); lse ``1e-5``.  Against the JAX ``flash_attention`` and, where
it takes the case (no window, no offset), ``flash_attention_lse`` (Pallas,
interpret mode) in float32: ``atol=2e-3``, lse ``1e-4``, on rows that see a
key.  On the CPU the JAX forward gives NaN on a row without a key at Dh 16
and 64, so the cases where a row can be keyless use Dh 32 or 128 there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.ops import flash_attention as jflash
from matryoshka_mm_torch.ops import flash_attention as tflash

# name: (B, H, Hkv, Sq, Sk, causal, window, offset, left pads per row, Dh)
CASES = {
    "causal": (1, 2, 2, 64, 64, True, None, 0, None, 32),
    "non_causal": (1, 2, 2, 65, 130, False, None, 0, (4,), 64),
    "s63": (1, 2, 2, 63, 63, True, None, 0, None, 64),
    "s64": (1, 2, 2, 64, 64, True, None, 0, (3,), 128),
    "s65": (2, 2, 2, 65, 65, True, None, 0, (0, 9), 32),
    "s129": (1, 2, 1, 129, 129, True, None, 0, (5,), 128),
    "pad70": (2, 2, 2, 129, 129, True, None, 0, (70, 0), 32),
    "pad70_dh128": (1, 2, 2, 129, 129, True, None, 0, (70,), 128),
    "window16": (1, 2, 2, 129, 129, True, 16, 0, (3,), 32),
    "window100_pad70": (1, 2, 2, 130, 130, True, 100, 0, (70,), 128),
    "offset": (1, 2, 2, 70, 130, True, None, 40, None, 64),
    "offset_window": (1, 2, 2, 40, 130, True, 16, 90, None, 32),
    "gqa4": (1, 4, 1, 100, 100, True, None, 0, (11,), 128),
}
# one case of each kind (interpret mode costs a compile a case); none with a
# keyless row at Dh 64, where the JAX forward gives NaN (module docstring)
VS_JAX = ["causal", "gqa4", "non_causal", "offset_window", "pad70_dh128",
          "s129", "s63", "s65", "window16"]
TOL = {"float32": dict(atol=1e-5, rtol=0),
       "bfloat16": dict(atol=2e-3, rtol=2 ** -7)}


def _make(name):
    B, H, Hkv, Sq, Sk, causal, window, offset, pads, Dh = CASES[name]
    rng = np.random.default_rng(len(name) + Sq)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh)))
    valid = np.ones((B, Sk), bool)
    for b, n in enumerate(pads or ()):
        valid[b, :n] = False
    rows = np.arange(Sq)[:, None] + offset
    cols = np.arange(Sk)[None, :]
    sees = valid[:, None, :].repeat(Sq, axis=1)
    if causal:
        sees &= cols <= rows
    if window:
        sees &= rows - cols < window
    kw = dict(causal=causal, sliding_window=window, q_index_offset=offset)
    return q, k, v, valid, sees.any(-1), kw           # row_ok (B, Sq)


def _port(fn, q, k, v, valid, kw, dtype):
    td = getattr(torch, dtype)
    out, lse = fn(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                  kv_valid=torch.from_numpy(valid), **kw)
    assert out.dtype == td and lse.dtype == torch.float32
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tiled_forward_matches_whole_matrix_plain(name, dtype):
    q, k, v, valid, row_ok, kw = _make(name)
    got_o, got_l = _port(tflash.flash_attention_tiled_plain, q, k, v, valid,
                         kw, dtype)
    want_o, want_l = _port(tflash.flash_attention_plain, q, k, v, valid, kw,
                           dtype)
    assert np.isfinite(got_o).all() and np.isfinite(got_l).all()
    np.testing.assert_allclose(got_o, want_o, **TOL[dtype])
    np.testing.assert_allclose(got_l, want_l, atol=1e-5, rtol=0)
    # a row without a valid key: exactly 0 and the masked lse, skipped
    # tiles and tiles of keyless rows included
    keyless = ~row_ok[:, None, :].repeat(q.shape[1], axis=1)   # (B, H, Sq)
    assert np.all(got_o[keyless] == 0)
    assert np.all(got_l[keyless] == tflash.LSE_MASKED)
    assert np.all(got_l[~keyless] > tflash.LSE_MASKED)


@pytest.mark.parametrize("name", VS_JAX)
def test_tiled_forward_matches_jax(name):
    """``out`` against the JAX ``flash_attention``; ``lse`` against the JAX
    ``flash_attention_lse``, which takes no window and no offset."""
    q, k, v, valid, row_ok, kw = _make(name)
    jq, jk, jv, jvalid = (jnp.asarray(a) for a in (q, k, v, valid))
    want_o = jflash.flash_attention(jq, jk, jv, kv_valid=jvalid, **kw)
    got_o, got_l = _port(tflash.flash_attention_tiled_plain, q, k, v, valid,
                         kw, "float32")
    keep = row_ok                                            # (B, Sq)
    np.testing.assert_allclose(
        got_o.transpose(0, 2, 1, 3)[keep],
        np.asarray(want_o).transpose(0, 2, 1, 3)[keep], atol=2e-3, rtol=0)
    if kw["sliding_window"] is None and kw["q_index_offset"] == 0:
        _, want_l = jflash.flash_attention_lse(jq, jk, jv, kv_valid=jvalid,
                                               causal=kw["causal"])
        np.testing.assert_allclose(
            got_l.transpose(0, 2, 1)[keep],
            np.asarray(want_l).transpose(0, 2, 1)[keep], atol=1e-4, rtol=0)


def test_tiled_forward_walks_only_the_tiles_in_its_bounds():
    """A causal walk over 129 rows visits the kv tiles at and below each q
    tile's diagonal; the tiles that skip the mask are wholly below it."""
    valid = torch.ones(129, dtype=torch.bool)
    walks = {q0: list(tflash._kv_tiles(q0, min(q0 + 64, 129), 129, valid,
                                       True, 0, 0))
             for q0 in (0, 64, 128)}
    assert walks == {0: [(0, 64, True)],
                     64: [(0, 64, False), (64, 128, True)],
                     128: [(0, 64, False), (64, 128, False),
                           (128, 129, True)]}
    valid[70] = False            # an invalid slot masks its tile everywhere
    assert [m for *_, m in tflash._kv_tiles(128, 129, 129, valid, True, 0,
                                            0)] == [False, True, True]
