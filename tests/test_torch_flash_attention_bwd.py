"""PyTorch port: the flash-attention backward (the plain versions of the dQ
and dK/dV kernels and the ``autograd.Function`` around them, on the CPU)
against ``jax.grad`` of the JAX ``flash_attention`` (its Pallas kernels in
interpret mode) and against torch autograd through ``attention_reference``.

The same numpy inputs, made from a seed, go through all of them.  The
output gradient is zero on query rows that see no key (such rows carry
``IGNORE_INDEX`` labels in training), and gradients are compared on valid
rows and slots only: what the masked-softmax reference does on a fully
masked row (the mean of V) is no part of the contract.  Tolerances: float32
``2e-4`` of max|grad| (f32 sums in another order), bfloat16 ``3e-2`` (p and
ds are rounded to bf16 before their products, on slightly other f32).

The tensor-core kernels walk 64 x 64 tiles, skip those outside the causal
diagonal and the window, and run the per-element mask only on tiles that
need it.  ``flash_attention_bwd_tiled_plain`` walks the same tiles with the
same rules on the CPU; the ``TILED`` cases put it at the places where such
a walk goes wrong (sequence lengths around one and two tiles, ``Sq != Sk``
with an offset, a window inside one tile and one across three, a padding
longer than a tile, GQA) and hold it against the whole-matrix plain
versions and against ``jax.grad``.  Tolerances there: float32 ``1e-5`` of
max|grad| against the plain versions (the same products, summed tile by
tile), the file's ``2e-4`` against JAX; bfloat16 ``2e-2`` against both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.ops import flash_attention as jflash
from matryoshka_mm_torch.ops import attention as tattn
from matryoshka_mm_torch.ops import flash_attention as tflash

TOL = {"float32": 2e-4, "bfloat16": 3e-2}

CASES = {
    # name: (B, H, Hkv, Sq, Sk, causal, window, offset, left pads per row)
    "causal": (1, 2, 2, 64, 64, True, None, 0, None),
    "non_causal": (1, 2, 2, 48, 48, False, None, 0, None),
    "left_padding": (2, 2, 2, 50, 50, True, None, 0, (7, 19)),
    "unaligned": (2, 2, 2, 37, 37, True, None, 0, (0, 5)),
    "gqa": (2, 4, 2, 40, 40, True, None, 0, (0, 11)),
    "window": (1, 4, 2, 64, 64, True, 16, 0, (3,)),
    "q_index_offset": (1, 2, 2, 24, 96, True, None, 40, None),
}


# the same, then Dh: where a walk over 64 x 64 tiles goes wrong
TILED = {
    "s63": (1, 2, 2, 63, 63, True, None, 0, None, 64),
    "s64": (1, 2, 2, 64, 64, True, None, 0, (3,), 128),
    "s65": (2, 2, 2, 65, 65, True, None, 0, (0, 9), 32),
    "s129": (1, 2, 1, 129, 129, True, None, 0, (5,), 128),
    "offset": (1, 2, 2, 70, 131, True, None, 40, None, 64),
    "offset_pad": (2, 2, 2, 65, 150, True, None, 85, (0, 70), 128),
    "window16": (1, 2, 2, 129, 129, True, 16, 0, (3,), 32),
    "window150": (1, 2, 2, 200, 200, True, 150, 0, None, 64),
    "window_offset": (1, 2, 2, 40, 150, True, 16, 100, None, 32),
    "pad70": (2, 2, 2, 129, 129, True, None, 0, (70, 0), 32),
    "pad70_dh64": (2, 2, 2, 129, 129, True, None, 0, (70, 0), 64),
    "pad70_dh128": (1, 2, 2, 129, 129, True, None, 0, (70,), 128),
    "gqa4": (1, 8, 2, 100, 100, True, None, 0, (11,), 128),
    "non_causal": (1, 2, 2, 65, 130, False, None, 0, (4,), 64),
}
# On the CPU the JAX forward overflows on a query row with no valid key when
# Dh is 16 or 64 (its ``exp2(s * c - m)`` is contracted to an fma whose
# rounding error, times 1e30, is positive at those scales): the row's ``out``
# is NaN and its ``lse`` +inf, and the NaN ``delta`` reaches ``dk`` of every
# key (the rows it pads ``Sq`` with count: under a window they see no key
# either).  The port returns 0 and -1e30 there.  So the one case that pads
# at Dh = 64 is held against the port's own plain versions only.
TILED_VS_JAX = sorted(n for n in TILED if n != "pad70_dh64")
TILED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _make(name, dtype="float32", Dh=32):
    if name in TILED:
        *case, Dh = TILED[name]
    else:
        case = CASES[name]
    B, H, Hkv, Sq, Sk, causal, window, offset, pads = case
    rng = np.random.default_rng(len(name))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh), (B, H, Sq, Dh)))
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
    row_ok = sees.any(-1)                                     # (B, Sq)
    do = do * row_ok[:, None, :, None]
    return (q, k, v, do, valid, row_ok,
            dict(causal=causal, sliding_window=window, q_index_offset=offset))


def _jax_grads(q, k, v, do, valid, kw, dtype):
    jd = jnp.dtype(dtype)

    def loss(q, k, v):
        o = jflash.flash_attention(q, k, v, kv_valid=jnp.asarray(valid), **kw)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_operands(q, k, v, do, dtype):
    td = getattr(torch, dtype)
    return [torch.from_numpy(a).to(td) for a in (q, k, v, do)]


def _assert_close(got, want, row_ok, valid, dtype, what, tol=TOL):
    """dq on the rows that see a key, dk / dv on the valid slots."""
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = np.asarray(g, np.float32)
        assert np.isfinite(g).all(), f"{what}: {name} has NaN or inf"
        keep = row_ok if name == "dq" else valid
        g, w = g.transpose(0, 2, 1, 3)[keep], w.transpose(0, 2, 1, 3)[keep]
        np.testing.assert_allclose(g, w, atol=tol[dtype] * np.abs(w).max(),
                                   rtol=0, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_grad(name):
    q, k, v, do, valid, row_ok, kw = _make(name)
    want = _jax_grads(q, k, v, do, valid, kw, "float32")
    tq, tk, tv, tdo = _torch_operands(q, k, v, do, "float32")
    tvalid = torch.from_numpy(valid)
    out, lse = tflash.flash_attention_lse(tq, tk, tv, kv_valid=tvalid, **kw)
    got = tflash.flash_attention_bwd_plain(tq, tk, tv, tvalid, out, lse, tdo,
                                           **kw)
    _assert_close([g.numpy() for g in got], want, row_ok, valid, "float32",
                  name)
    # masked rows and slots get exactly nothing
    assert np.all(got[0].numpy().transpose(0, 2, 1, 3)[~row_ok] == 0)
    if kw["q_index_offset"] == 0:
        assert np.all(got[1].numpy().transpose(0, 2, 1, 3)[~valid] == 0)
        assert np.all(got[2].numpy().transpose(0, 2, 1, 3)[~valid] == 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_function_matches_jax_grad(name):
    q, k, v, do, valid, row_ok, kw = _make(name)
    want = _jax_grads(q, k, v, do, valid, kw, "float32")
    tq, tk, tv, tdo = _torch_operands(q, k, v, do, "float32")
    for t in (tq, tk, tv):
        t.requires_grad_()
    out = tflash.flash_attention(tq, tk, tv, kv_valid=torch.from_numpy(valid),
                                 **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), tdo)
    _assert_close([g.numpy() for g in got], want, row_ok, valid, "float32",
                  name)


@pytest.mark.parametrize("name", ["left_padding", "gqa", "window"])
def test_bfloat16_backward_matches_jax_grad(name):
    q, k, v, do, valid, row_ok, kw = _make(name)
    want = _jax_grads(q, k, v, do, valid, kw, "bfloat16")
    tq, tk, tv, tdo = _torch_operands(q, k, v, do, "bfloat16")
    for t in (tq, tk, tv):
        t.requires_grad_()
    out = tflash.flash_attention(tq, tk, tv, kv_valid=torch.from_numpy(valid),
                                 **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), tdo)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_close([g.float().numpy() for g in got], want, row_ok, valid,
                  "bfloat16", name)


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if n != "q_index_offset"))
def test_autograd_function_matches_autograd_through_reference(name):
    """Index causality equals position causality at offset 0, so torch's
    own autograd through the masked softmax is a second reference."""
    q, k, v, do, valid, row_ok, kw = _make(name)
    grads = []
    for impl in ("auto", "reference"):
        tq, tk, tv, tdo = _torch_operands(q, k, v, do, "float32")
        for t in (tq, tk, tv):
            t.requires_grad_()
        out = tattn.attention(tq, tk, tv, causal=kw["causal"],
                              kv_valid=torch.from_numpy(valid),
                              sliding_window=kw["sliding_window"], impl=impl)
        grads.append([g.numpy() for g in
                      torch.autograd.grad(out, (tq, tk, tv), tdo)])
    _assert_close(grads[0], grads[1], row_ok, valid, "float32", name)


def test_fully_masked_rows_put_no_nan_into_real_keys():
    """A left-padded row: its queries see no key, their lse is -1e30, and
    exp2 of what the backward recomputes overflows.  With a NON-zero output
    gradient on those rows the gradients of the real keys stay finite and
    equal to those of the same batch with a zero gradient there."""
    q, k, v, do, valid, row_ok, kw = _make("left_padding")
    rng = np.random.default_rng(1)
    noisy = do + rng.standard_normal(do.shape).astype(np.float32) \
        * ~row_ok[:, None, :, None]
    outs = []
    for d in (do, noisy):
        tq, tk, tv, td = _torch_operands(q, k, v, d, "float32")
        tvalid = torch.from_numpy(valid)
        out, lse = tflash.flash_attention_lse(tq, tk, tv, kv_valid=tvalid,
                                              **kw)
        assert torch.all(lse.transpose(1, 2)[torch.from_numpy(~row_ok)]
                         == tflash.LSE_MASKED)
        outs.append(tflash.flash_attention_bwd_plain(tq, tk, tv, tvalid, out,
                                                     lse, td, **kw))
    for a, b in zip(*outs):
        assert torch.isfinite(b).all()
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_strided_operands_and_lse_stays_non_differentiable():
    """The model hands over transposed views; ``flash_attention_lse`` has
    no gradient, as in JAX."""
    q, k, v, do, valid, row_ok, kw = _make("gqa")
    base = [torch.from_numpy(a.transpose(0, 2, 1, 3).copy()).requires_grad_()
            for a in (q, k, v)]
    tq, tk, tv = (t.transpose(1, 2) for t in base)
    out = tflash.flash_attention(tq, tk, tv, kv_valid=torch.from_numpy(valid),
                                 **kw)
    got = torch.autograd.grad(out, base, torch.from_numpy(do))
    cq, ck, cv, _ = _torch_operands(q, k, v, do, "float32")
    for t in (cq, ck, cv):
        t.requires_grad_()
    want = torch.autograd.grad(
        tflash.flash_attention(cq, ck, cv, kv_valid=torch.from_numpy(valid),
                               **kw), (cq, ck, cv), torch.from_numpy(do))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.transpose(1, 2), w, atol=1e-6, rtol=0)
    o, lse = tflash.flash_attention_lse(cq, ck, cv)
    assert not o.requires_grad and not lse.requires_grad


def test_residuals_skip_the_second_forward_and_cpu_counts_no_launch():
    q, k, v, do, valid, _, kw = _make("causal")
    tq, tk, tv, tdo = _torch_operands(q, k, v, do, "float32")
    tq.requires_grad_()
    res = tflash.FlashResiduals()
    first = tflash.flash_attention(tq, tk, tv, residuals=res, **kw)
    first = first.detach().clone()
    assert res.out is not None and res.lse is not None
    res.out.add_(1.0)          # a second forward must return what is held
    second = tflash.flash_attention(tq, tk, tv, residuals=res, **kw)
    torch.testing.assert_close(second, first + 1.0, atol=0, rtol=0)
    assert second.grad_fn is not None
    for fn in (tflash.flash_attention_lse, tflash.flash_attention_bwd_dq,
               tflash.flash_attention_bwd_dkv):
        assert fn.launches == 0
    torch.autograd.grad(second, tq, tdo)
    assert tflash.flash_attention_bwd_dq.launches == 0


def _tiled_and_plain(name, dtype):
    """The tiled twin's and the whole-matrix plain versions' gradients of
    one case, as float32 numpy arrays, with the case's masks."""
    q, k, v, do, valid, row_ok, kw = _make(name)
    tq, tk, tv, tdo = _torch_operands(q, k, v, do, dtype)
    tvalid = torch.from_numpy(valid)
    out, lse = tflash.flash_attention_lse(tq, tk, tv, kv_valid=tvalid, **kw)
    args = (tq, tk, tv, tvalid, out, lse, tdo)
    tiled = tflash.flash_attention_bwd_tiled_plain(*args, **kw)
    plain = tflash.flash_attention_bwd_plain(*args, **kw)
    assert all(g.dtype == getattr(torch, dtype) for g in tiled)
    return ([g.float().numpy() for g in tiled],
            [g.float().numpy() for g in plain], (q, k, v, do, valid, row_ok,
                                                 kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(TILED))
def test_tiled_walk_matches_whole_matrix_plain(name, dtype):
    tiled, plain, (_, _, _, _, valid, row_ok, kw) = _tiled_and_plain(name,
                                                                    dtype)
    _assert_close(tiled, plain, row_ok, valid, dtype, name, tol=TILED_TOL)
    # masked rows and slots get exactly nothing, skipped tiles included
    assert np.all(tiled[0].transpose(0, 2, 1, 3)[~row_ok] == 0)
    if kw["q_index_offset"] == 0:
        assert np.all(tiled[1].transpose(0, 2, 1, 3)[~valid] == 0)
        assert np.all(tiled[2].transpose(0, 2, 1, 3)[~valid] == 0)


@pytest.mark.parametrize("name", TILED_VS_JAX)
def test_tiled_walk_matches_jax_grad(name):
    tiled, _, (q, k, v, do, valid, row_ok, kw) = _tiled_and_plain(name,
                                                                 "float32")
    want = _jax_grads(q, k, v, do, valid, kw, "float32")
    _assert_close(tiled, want, row_ok, valid, "float32", name)


@pytest.mark.parametrize("name", ["s65", "pad70_dh128", "window16", "gqa4",
                                  "offset"])
def test_tiled_walk_matches_jax_grad_bfloat16(name):
    tiled, _, (q, k, v, do, valid, row_ok, kw) = _tiled_and_plain(name,
                                                                 "bfloat16")
    want = _jax_grads(q, k, v, do, valid, kw, "bfloat16")
    _assert_close(tiled, want, row_ok, valid, "bfloat16", name,
                  tol=TILED_TOL)


def test_tiled_walk_lets_no_overflow_through_on_rows_without_keys():
    """Rows left of a padding longer than a tile have lse = -1e30; with a
    non-zero output gradient there, the tiles that run without the
    per-element mask still hold no such row: every gradient stays finite
    and equals the whole-matrix plain version's."""
    q, k, v, do, valid, row_ok, kw = _make("pad70")
    rng = np.random.default_rng(2)
    noisy = do + rng.standard_normal(do.shape).astype(np.float32) \
        * ~row_ok[:, None, :, None]
    tq, tk, tv, tdo = _torch_operands(q, k, v, noisy, "float32")
    tvalid = torch.from_numpy(valid)
    out, lse = tflash.flash_attention_lse(tq, tk, tv, kv_valid=tvalid, **kw)
    args = (tq, tk, tv, tvalid, out, lse, tdo)
    tiled = tflash.flash_attention_bwd_tiled_plain(*args, **kw)
    plain = tflash.flash_attention_bwd_plain(*args, **kw)
    for g, w in zip(tiled, plain):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-5 * float(w.abs().max()),
                                   rtol=0)
