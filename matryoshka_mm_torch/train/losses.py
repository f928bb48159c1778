"""Training loss library (port of ``matryoshka_mm_tpu/train/losses.py``).

* LM losses, micro/macro, weighted, unreduced;
* sequence scoring functions logprob / accuracy / brier / entropy;
* token-wise knowledge distillation;
* gating-probability softening and per-expert cost schedules;
* MoE load-balance and router objectives: switch, argmaxcost, betalogprob,
  bounderr(sq), lmlossaddcost.

All functions are batch-global: the batch axis is the whole batch of the
step, and gating statistics are plain means over it.  Inside
:func:`global_batch` a rank holds only its rows of that batch: every
reduction over the batch axis (:func:`batch_sum`, :func:`batch_mean`) is
then taken over the data ranks too, as one all-reduce whose gradient
passes back unchanged (``parallel/collectives.py`` ``reduce_from_group``).
Every rank so computes the loss of the whole batch, and the gradient it
carries back is its rows' part of the whole batch's gradient; the sum over
the data ranks is that gradient.  (A mean of each rank's local loss would
be another loss wherever the ranks hold different numbers of valid
labels.)
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..constants import IGNORE_INDEX
from ..parallel.collectives import reduce_from_group

_EPS = 1e-8
_batch = threading.local()


@contextlib.contextmanager
def global_batch(group):
    """Reductions over the batch axis inside span the ranks of ``group``
    (a process group of data ranks holding equal numbers of rows; None:
    this process holds the whole batch)."""
    prev = getattr(_batch, "group", None)
    _batch.group = group
    try:
        yield
    finally:
        _batch.group = prev


def batch_rows(n: int) -> int:
    """Rows of the whole batch, for ``n`` rows here."""
    group = getattr(_batch, "group", None)
    return n if group is None else n * dist.get_world_size(group)


def batch_sum(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """``x`` summed over the whole batch (``dim``, or every dim)."""
    s = x.sum() if dim is None else x.sum(dim)
    group = getattr(_batch, "group", None)
    return s if group is None else reduce_from_group(s, group)


def batch_mean(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """``x`` averaged over the whole batch (``dim`` 0 its batch axis, or
    every dim of a ``(B,)`` tensor)."""
    if getattr(_batch, "group", None) is None:
        return x.mean() if dim is None else x.mean(dim=dim)
    return batch_sum(x, dim) / batch_rows(x.shape[0])


def _shift(logits: torch.Tensor, labels: torch.Tensor):
    """Align logits[t] with labels[t+1] (next-token prediction)."""
    return logits[..., :-1, :], labels[..., 1:]


def _label_logprob(logits: torch.Tensor, labels: torch.Tensor):
    """``(-log p[label], valid)`` with invalid labels zeroed; labels are
    clamped into the vocabulary so that none can poison the gather."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).clamp(0, logits.shape[-1] - 1)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logprobs, -1, safe.long()[..., None])[..., 0]
    return torch.where(valid, -ll, 0.0), valid


def token_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """(B, S-1) per-token CE with invalid labels zeroed; also returns the
    mask."""
    return _label_logprob(*_shift(logits, labels))


def reduce_token_losses(losses, valid, lm_loss_type: str, weights=None, unreduced=False):
    """The reductions the LM losses share.  ``micro`` normalizes by the
    batch's valid tokens, ``macro`` by each sequence's."""
    if lm_loss_type == "micro":
        per_seq = losses.sum(-1)
        if unreduced:
            return per_seq * batch_rows(per_seq.shape[0]) \
                / (batch_sum(valid) + _EPS)
        if weights is None:
            return batch_sum(losses) / batch_sum(valid).clamp(min=1)
        return batch_sum(per_seq * weights) / (batch_sum(valid) + _EPS)
    if lm_loss_type == "macro":
        per_seq = losses.sum(-1) / (valid.sum(-1) + _EPS)
        if unreduced:
            return per_seq
        return batch_mean(per_seq if weights is None else per_seq * weights)
    raise ValueError(f"invalid lm_loss_type = {lm_loss_type}")


def lm_loss(logits, labels, lm_loss_type: str = "micro") -> torch.Tensor:
    """Scalar LM loss."""
    losses, valid = token_cross_entropy(logits, labels)
    return reduce_token_losses(losses, valid, lm_loss_type)


def lm_loss_weighted(logits, labels, sample_weights,
                     lm_loss_type: str = "micro") -> torch.Tensor:
    """LM loss weighted per sample by the gating probability."""
    losses, valid = token_cross_entropy(logits, labels)
    w = sample_weights.reshape(losses.shape[0]).float()
    return reduce_token_losses(losses, valid, lm_loss_type, weights=w)


def chunked_token_cross_entropy(hidden: torch.Tensor, lm_head_w,
                                labels: torch.Tensor, chunk: int = 256):
    """Per-token CE from hidden states WITHOUT materializing the (B, S, V)
    float32 logits: the sequence is processed in chunks, each projected to
    logits, reduced to per-token CE and freed; under autograd each chunk is
    recomputed in the backward, so no chunk's logits are kept either.
    Returns ((B, S-1) ce, (B, S-1) valid) as :func:`token_cross_entropy`."""
    from ..models.llama import proj

    def body(hc, lc):
        return _label_logprob(proj(hc, lm_head_w).float(), lc)[0]

    shift_hidden, shift_labels = hidden[:, :-1, :], labels[..., 1:]
    needs_grad = torch.is_grad_enabled() and hidden.requires_grad
    ce = []
    for s in range(0, shift_hidden.shape[1], chunk):
        hc, lc = shift_hidden[:, s:s + chunk], shift_labels[:, s:s + chunk]
        ce.append(checkpoint(body, hc, lc, use_reentrant=False,
                             preserve_rng_state=False)
                  if needs_grad else body(hc, lc))
    return torch.cat(ce, dim=1), shift_labels != IGNORE_INDEX


def chunked_lm_loss_unreduced(hidden, lm_head_w, labels,
                              lm_loss_type: str = "micro",
                              chunk: int = 256) -> torch.Tensor:
    """(B,) per-sample loss from hidden states, logits never
    materialized."""
    losses, valid = chunked_token_cross_entropy(hidden, lm_head_w, labels,
                                                chunk)
    return reduce_token_losses(losses, valid, lm_loss_type, unreduced=True)


def lm_loss_unreduced(logits, labels,
                      lm_loss_type: str = "micro") -> torch.Tensor:
    """(B,) per-sample losses whose mean equals the reduced loss."""
    losses, valid = token_cross_entropy(logits, labels)
    return reduce_token_losses(losses, valid, lm_loss_type, unreduced=True)


# ---------------------------------------------------------------------------
# sequence scoring (teacher selection)
# ---------------------------------------------------------------------------

def _seq_mean(x, valid, level):
    if level == "token":
        return x
    return x.sum(-1) / valid.sum(-1).clamp(min=1)


def compute_seq_logprob(logits, labels, level: str = "seq"):
    losses, valid = token_cross_entropy(logits, labels)
    lp = torch.where(valid, -losses, 0.0)
    return lp if level == "token" else lp.sum(-1)


def compute_seq_accuracy(logits, labels, level: str = "seq"):
    shift_logits, shift_labels = _shift(logits, labels)
    valid = shift_labels != IGNORE_INDEX
    preds = shift_logits.argmax(dim=-1)
    correct = torch.where(valid, (preds == shift_labels).float(), 0.0)
    return _seq_mean(correct, valid, level)


def compute_seq_brier(logits, labels, level: str = "seq"):
    shift_logits, shift_labels = _shift(logits, labels)
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0)
    probs = torch.softmax(shift_logits.float(), dim=-1)
    p_true = torch.gather(probs, -1, safe.long()[..., None])[..., 0]
    # sum_c (p_c - y_c)^2 = sum p^2 - 2 p_true + 1
    brier = (probs * probs).sum(-1) - 2.0 * p_true + 1.0
    return _seq_mean(torch.where(valid, brier, 0.0), valid, level)


def compute_seq_entropy(logits, labels, level: str = "seq"):
    shift_logits, shift_labels = _shift(logits, labels)
    valid = shift_labels != IGNORE_INDEX
    logprobs = torch.log_softmax(shift_logits.float(), dim=-1)
    ent = torch.where(valid, -(logprobs.exp() * logprobs).sum(-1), 0.0)
    return _seq_mean(ent, valid, level)


SCORE_FNS = {
    "logprob": compute_seq_logprob,
    "accuracy": compute_seq_accuracy,
    "brier": lambda *a, **k: -compute_seq_brier(*a, **k),
    "entropy": lambda *a, **k: -compute_seq_entropy(*a, **k),
}


# ---------------------------------------------------------------------------
# distillation
# ---------------------------------------------------------------------------

def tokenwise_kd_loss(logits_t, logits_s, labels_t, temperature: float,
                      detach_teacher_grad: bool, reduction: str = "mean"):
    """Soft-target CE between teacher and student distributions.  The
    caller guarantees equal sequence lengths (all scales are spliced into
    one left-padded buffer, see ``train_step``)."""
    if detach_teacher_grad:
        logits_t = logits_t.detach()
    shift_s, shift_labels = _shift(logits_s, labels_t)
    shift_t, _ = _shift(logits_t, labels_t)
    logprob_s = torch.log_softmax(shift_s.float() / temperature, dim=-1)
    prob_t = torch.softmax(shift_t.float() / temperature, dim=-1)
    ce = -(prob_t * logprob_s).sum(-1)                       # (B, S-1)
    valid = shift_labels != IGNORE_INDEX
    ce = torch.where(valid, ce, 0.0)
    if reduction == "mean":
        return batch_sum(ce) / (batch_sum(valid) + _EPS) * (temperature ** 2)
    if reduction == "seqlevel_mean":
        return ce.sum(-1) / (batch_sum(valid) + _EPS) * (temperature ** 2)
    raise ValueError(f"invalid reduction {reduction}")


# ---------------------------------------------------------------------------
# router / load-balance pieces
# ---------------------------------------------------------------------------

def compute_gating_prob_argmax(gating_prob: torch.Tensor,
                               tau: float = 1.0) -> torch.Tensor:
    """Soft 'argmax' of the gating distribution: a softmax with
    temperature."""
    return torch.softmax(gating_prob / tau, dim=-1)


def per_expert_assignment(gating_prob: torch.Tensor) -> torch.Tensor:
    """(K,) fraction of the batch argmax-assigned to each expert."""
    K = gating_prob.shape[1]
    one_hot = torch.nn.functional.one_hot(gating_prob.argmax(dim=1), K)
    return batch_mean(one_hot.float(), 0)


def get_per_expert_cost(per_expert_cost_type: str,
                        batch_per_expert_assignment: torch.Tensor,
                        tokscales) -> torch.Tensor:
    """(K,) cost vector."""
    scales = torch.tensor(tokscales, dtype=torch.float32,
                          device=batch_per_expert_assignment.device)
    if per_expert_cost_type == "count":
        return batch_per_expert_assignment
    if per_expert_cost_type == "numtoks":
        return scales / scales.sum()
    if per_expert_cost_type == "lognumtoks":
        c = torch.log(scales + 1)
        return c / c.sum()
    if per_expert_cost_type == "count*numtoks":
        c = batch_per_expert_assignment * (scales / scales.sum())
        return c / c.sum()
    if per_expert_cost_type == "count*lognumtoks":
        ln = torch.log(scales + 1)
        c = batch_per_expert_assignment * (ln / ln.sum())
        return c / c.sum()
    raise ValueError(f"per_expert_cost_type={per_expert_cost_type} not "
                     f"supported.")


def switch_load_balance_loss(gating_prob: torch.Tensor,
                             per_expert_cost: torch.Tensor,
                             alpha: float) -> torch.Tensor:
    """Switch-Transformer aux loss: alpha * K * sum(cost * mean_gate)."""
    K = gating_prob.shape[1]
    return alpha * K * (per_expert_cost * batch_mean(gating_prob, 0)).sum()


def beta_logprob_loss(gating_prob: torch.Tensor, alpha: float,
                      beta_a: float, beta_b: float) -> torch.Tensor:
    """Beta-prior log-probability on the 2-expert gate."""
    import math

    p = gating_prob[:, 1].clamp(1e-6, 1 - 1e-6)
    betaln = math.lgamma(beta_a) + math.lgamma(beta_b) \
        - math.lgamma(beta_a + beta_b)
    log_prob = ((beta_a - 1) * torch.log(p) + (beta_b - 1) * torch.log1p(-p)
                - betaln)
    return alpha * batch_sum(log_prob)


def bounderr_loss(losses_lm: torch.Tensor, gating_prob_argmax: torch.Tensor,
                  margin: float, squared: bool) -> torch.Tensor:
    """Hinge on loss(argmax scale) - loss(largest scale); losses_lm is
    (B, K)."""
    losses_argmax = (losses_lm * gating_prob_argmax).sum(1)
    diff = (losses_argmax - losses_lm[:, -1] - margin).clamp(min=0.0)
    return batch_mean(diff.square() if squared else diff)


def lmlossaddcost_loss(losses_lm: torch.Tensor, gating_prob: torch.Tensor,
                       per_expert_cost: torch.Tensor,
                       lamb: float) -> torch.Tensor:
    """Expected (LM loss + lambda * cost) under the gate; losses_lm is
    (B, K)."""
    K = losses_lm.shape[1]
    losses = losses_lm + lamb * per_expert_cost.reshape(1, K)
    return batch_mean((losses * gating_prob).sum(1))


def argmaxcost_ema_loss(gating_prob_argmax: torch.Tensor,
                        per_expert_cost: torch.Tensor,
                        batch_argmaxcost: torch.Tensor,
                        alpha: float,
                        target_value: Optional[float],
                        numtoks_margin: Optional[float]) -> torch.Tensor:
    """Squared budget penalty with straight-through batch statistics:
    ``batch_argmaxcost`` is the (possibly EMA-smoothed) batch average cost,
    the local ``argmaxcost`` keeps the gradient path:
    ``loss = alpha * sq(clip(batch - sg(local) + local - target))``."""
    K = gating_prob_argmax.shape[1]
    argmaxcost = batch_mean((gating_prob_argmax
                             * per_expert_cost.reshape(-1, K)).sum(1))
    straight_through = batch_argmaxcost - argmaxcost.detach() + argmaxcost
    if target_value is not None:
        return alpha * (straight_through - target_value).square()
    return alpha * (straight_through - numtoks_margin).clamp(min=0.0).square()
