"""PyTorch port: every function of ``train/losses.py`` against its JAX twin
on the same numpy arrays, float32, within ``1e-5`` (absolute and relative:
the same f32 formulas, sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.train import losses as jL
from matryoshka_mm_torch.train import losses as tL

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, V, K = 3, 9, 17, 4


def _data(seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, S, V)) * 2).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[:, :3] = -100
    labels[1, 6:] = -100
    labels[2, :] = -100                 # a row with no valid label
    return logits, labels


def _both(name, *args, **kw):
    """Call ``name`` on both sides with numpy arguments."""
    j = getattr(jL, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                            else a for a in args), **kw)
    t = getattr(tL, name)(*(torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in args), **kw)
    return t, j


def _close(t, j):
    if isinstance(j, tuple):
        for a, b in zip(t, j):
            _close(a, b)
        return
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)


def test_token_cross_entropy():
    _close(*_both("token_cross_entropy", *_data()))


@pytest.mark.parametrize("kind", ["micro", "macro"])
@pytest.mark.parametrize("fn", ["lm_loss", "lm_loss_unreduced"])
def test_lm_losses(fn, kind):
    _close(*_both(fn, *_data(1), lm_loss_type=kind))


@pytest.mark.parametrize("kind", ["micro", "macro"])
def test_lm_loss_weighted(kind):
    w = np.random.default_rng(2).random((B, 1)).astype(np.float32)
    _close(*_both("lm_loss_weighted", *_data(2), w, lm_loss_type=kind))


def test_invalid_loss_type_raises():
    logits, labels = (torch.from_numpy(a) for a in _data())
    with pytest.raises(ValueError, match="lm_loss_type"):
        tL.lm_loss(logits, labels, "nano")


@pytest.mark.parametrize("chunk", [4, 8, 256])
def test_chunked_cross_entropy_equals_the_unchunked(chunk):
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((B, S, 12)).astype(np.float32)
    w = rng.standard_normal((V, 12)).astype(np.float32)
    _, labels = _data(3)
    t, j = _both("chunked_token_cross_entropy", hidden, w, labels,
                 chunk=chunk)
    _close(t, j)
    full = tL.token_cross_entropy(
        torch.from_numpy(hidden) @ torch.from_numpy(w).T,
        torch.from_numpy(labels))
    _close(t, tuple(x.numpy() for x in full))
    for kind in ("micro", "macro"):
        _close(*_both("chunked_lm_loss_unreduced", hidden, w, labels,
                      lm_loss_type=kind, chunk=chunk))


def test_chunked_cross_entropy_gradient_equals_the_unchunked():
    rng = np.random.default_rng(4)
    hidden = torch.from_numpy(
        rng.standard_normal((B, S, 12)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(
        rng.standard_normal((V, 12)).astype(np.float32)).requires_grad_()
    labels = torch.from_numpy(_data(4)[1])
    ce, _ = tL.chunked_token_cross_entropy(hidden, w, labels, chunk=4)
    got = torch.autograd.grad(ce.sum(), (hidden, w))
    want = torch.autograd.grad(
        tL.token_cross_entropy(hidden @ w.T, labels)[0].sum(), (hidden, w))
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("level", ["seq", "token"])
@pytest.mark.parametrize("fn", ["compute_seq_logprob", "compute_seq_accuracy",
                                "compute_seq_brier", "compute_seq_entropy"])
def test_sequence_scores(fn, level):
    _close(*_both(fn, *_data(5), level=level))


@pytest.mark.parametrize("name", sorted(tL.SCORE_FNS))
def test_score_fn_table(name):
    logits, labels = _data(6)
    assert set(tL.SCORE_FNS) == set(jL.SCORE_FNS)
    _close(tL.SCORE_FNS[name](torch.from_numpy(logits),
                              torch.from_numpy(labels), level="seq"),
           jL.SCORE_FNS[name](jnp.asarray(logits), jnp.asarray(labels),
                              level="seq"))


@pytest.mark.parametrize("reduction", ["mean", "seqlevel_mean"])
@pytest.mark.parametrize("detach", [False, True])
def test_tokenwise_kd_loss(reduction, detach):
    logits_t, labels = _data(7)
    logits_s, _ = _data(8)
    _close(*_both("tokenwise_kd_loss", logits_t, logits_s, labels, 2.0,
                  detach, reduction=reduction))
    with pytest.raises(ValueError, match="reduction"):
        tL.tokenwise_kd_loss(torch.from_numpy(logits_t),
                             torch.from_numpy(logits_s),
                             torch.from_numpy(labels), 1.0, False, "sum")


def _gate(seed=9):
    rng = np.random.default_rng(seed)
    g = rng.random((5, K)).astype(np.float32)
    return g / g.sum(1, keepdims=True)


def test_gating_helpers():
    g = _gate()
    _close(*_both("compute_gating_prob_argmax", g, 0.5))
    _close(*_both("per_expert_assignment", g))


@pytest.mark.parametrize("kind", ["count", "numtoks", "lognumtoks",
                                  "count*numtoks", "count*lognumtoks"])
def test_per_expert_cost(kind):
    assign = np.array([0.4, 0.2, 0.0, 0.4], np.float32)
    _close(*_both("get_per_expert_cost", kind, assign, [1, 9, 36, 144]))
    with pytest.raises(ValueError, match="not supported"):
        tL.get_per_expert_cost("price", torch.from_numpy(assign), [1, 9])


def test_load_balance_and_router_objectives():
    g = _gate(10)
    cost = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    losses_lm = np.random.default_rng(11).random((5, K)).astype(np.float32)
    _close(*_both("switch_load_balance_loss", g, cost, 0.01))
    _close(*_both("beta_logprob_loss", g[:, :2], 0.01, 2.0, 3.0))
    for squared in (False, True):
        _close(*_both("bounderr_loss", losses_lm, g, 0.05, squared))
    _close(*_both("lmlossaddcost_loss", losses_lm, g, cost, 0.5))
    batch_cost = np.float32(0.3)
    for target, margin in ((0.25, None), (None, 0.1)):
        j = jL.argmaxcost_ema_loss(jnp.asarray(g), jnp.asarray(cost),
                                   jnp.asarray(batch_cost), 2.0, target,
                                   margin)
        t = tL.argmaxcost_ema_loss(torch.from_numpy(g),
                                   torch.from_numpy(cost),
                                   torch.tensor(batch_cost), 2.0, target,
                                   margin)
        _close(t, j)


def test_argmaxcost_gradient_flows_through_the_local_cost_only():
    g = torch.from_numpy(_gate(12)).requires_grad_()
    cost = torch.tensor([0.1, 0.2, 0.3, 0.4])
    loss = tL.argmaxcost_ema_loss(g, cost, torch.tensor(0.9), 1.0, 0.25, None)
    (grad,) = torch.autograd.grad(loss, g)
    # d/dg of alpha * (batch - target)^2 through the straight-through term
    want = 2 * (0.9 - 0.25) * cost[None, :].expand(5, K) / 5
    torch.testing.assert_close(grad, want, rtol=1e-5, atol=1e-7)
