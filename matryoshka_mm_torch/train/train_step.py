"""M3 training step (port of ``matryoshka_mm_tpu/train/train_step.py``).

The whole multi-scale step is one forward and one backward:

* the vision tower runs ONCE per step;
* the K spliced sequences of a bucket are stacked into the batch axis, one
  LLM forward a bucket;
* every scale is spliced left-padded, so answer tokens line up at the right
  edge across scales and the distillation objectives index teacher and
  student logits directly;
* the MoE objectives are assembled from the loss library; batch statistics
  are means over the whole batch, across the data ranks inside
  ``losses.global_batch``.

The EMA state of the argmaxcost load balance is threaded explicitly
through the step (``TrainState.argmaxcost_ema``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import LlavaConfig
from ..constants import IGNORE_INDEX
from ..kvconfig import parse_kv_from_string, parse_list
from ..models.llama import embed_tokens, llama_forward, lm_head
from ..models.llava import encode_images, router_forward, splice_capacity
from ..models.projector import apply_projector
from ..ops.pooling import matryoshka_pool
from ..ops.splice import splice_multimodal
from . import losses as L


class M3Batch(NamedTuple):
    input_ids: torch.Tensor     # (B, T)
    pixel_values: torch.Tensor  # (B, 3, H, W)
    labels: torch.Tensor        # (B, T)
    attn_mask: torch.Tensor     # (B, T)
    # optional frozen text embedding for the router's `textcls` feature,
    # computed outside the differentiated graph: (B, D_text)
    text_embed: Optional[torch.Tensor] = None


def scale_buckets(cfg: LlavaConfig, text_len: int) -> list:
    """``[(capacity, [scale indices])]``: scales whose splice capacities
    lie within 5% of the bucket's first share one LLM forward at the
    largest of them, so the default [1, 9, 36, 144, 576] runs as three
    forwards: [1, 9, 36] at cap(36), [144], [576]."""
    scales = cfg.tokscale_list
    buckets, anchor = [], None
    for i in sorted(range(len(scales)), key=lambda j: scales[j]):
        cap = splice_capacity(cfg, text_len, scales[i])
        if buckets and cap <= int(anchor * 1.05):
            prev_cap, members = buckets[-1]
            buckets[-1] = (max(prev_cap, cap), members + [i])
        else:
            buckets.append((cap, [i]))
            anchor = cap
    return buckets


def _detach_tree(outs: dict) -> dict:
    return {k: v.detach() for k, v in outs.items()}


def multiscale_forward(params: dict, cfg: LlavaConfig, batch: M3Batch,
                       out_len: Optional[int] = None,
                       need_logits: bool = True,
                       frozen_vision: bool = False):
    """One forward over all K token scales.

    Returns (logits (K, B, L, V) float32 or None, labels (K, B, L),
    gating_prob (B, K) or None, losses_lm (B, K), ce (K, B, L-1),
    valid (K, B, L-1)).

    With ``need_logits=False`` the (K, B, L, V) float32 logits are never
    materialized: per-token CE is computed from hidden states in sequence
    chunks (``losses.chunked_token_cross_entropy``).  Only the distillation
    objectives need real logits.

    ``frozen_vision`` runs the tower without a graph, so no backward goes
    through it; the projector and the router keep their gradients (they
    use the features as activations)."""
    scales = cfg.tokscale_list
    if not scales:
        raise ValueError(
            "the M3 train step needs a list of token scales: set "
            "matryoshka_vis_token_scale, e.g. 'ver=v0_numtoks=[1,9,36,144,"
            "576]'")
    K = len(scales)
    B, T = batch.input_ids.shape
    buf_len = out_len or splice_capacity(cfg, T, max(scales))

    # ---- vision once ----
    if frozen_vision:
        with torch.no_grad():
            outs = encode_images(params, cfg, batch.pixel_values)
        outs = _detach_tree(outs)
    else:
        outs = encode_images(params, cfg, batch.pixel_values)
    feats = outs["patch"]
    if cfg.preset.projector_loc == "after_vision_tower":
        feats = apply_projector(params["mm_projector"], cfg.mm_projector_type,
                                feats)
    gating_prob = router_forward(params, cfg, outs,
                                 text_embed=batch.text_embed)

    # ---- scale -> buffer-length buckets ----
    # The distillation objectives need every scale in ONE left-padded
    # buffer; the per-token-CE path has no coupling between scales, so each
    # bucket runs at (nearly) its own length
    if need_logits or out_len is not None:
        buckets = [(buf_len, list(range(K)))]
    else:
        buckets = scale_buckets(cfg, T)

    # ---- pool + splice per scale, left-padded per bucket; one LLM forward
    # a bucket ----
    text = embed_tokens(params["llama"], batch.input_ids)
    lm_head_w = params["llama"].get("lm_head",
                                    params["llama"]["embed_tokens"])
    labels_all, ce_all = [None] * K, [None] * K
    valid_all, logits_all = [None] * K, [None] * K
    for cap, members in buckets:
        spliced = []
        for i in members:
            pooled = matryoshka_pool(feats, scales[i])
            if cfg.preset.projector_loc == "after_pooling":
                pooled = apply_projector(params["mm_projector"],
                                         cfg.mm_projector_type, pooled)
            spliced.append(splice_multimodal(
                batch.input_ids, text, pooled[:, None],
                labels=batch.labels, attn_mask=batch.attn_mask,
                out_len=cap, padding_side="left"))
        hidden, _ = llama_forward(
            params["llama"], cfg.llama,
            torch.cat([s.embeds for s in spliced], dim=0),
            position_ids=torch.cat([s.position_ids for s in spliced], dim=0),
            attn_valid=torch.cat([s.attn_mask for s in spliced], dim=0))
        hidden = hidden.reshape(len(members), B, cap, -1)

        # left-pad every scale's outputs back to buf_len so the stacked
        # (K, B, L) shapes do not depend on the buckets; pads carry
        # IGNORE / 0 / False, so every reduction downstream is unchanged
        lpad = buf_len - cap
        for g, i in enumerate(members):
            ce_i, valid_i = L.chunked_token_cross_entropy(
                hidden[g], lm_head_w, spliced[g].labels)
            labels_all[i] = F.pad(spliced[g].labels, (lpad, 0),
                                  value=IGNORE_INDEX)
            ce_all[i] = F.pad(ce_i, (lpad, 0))
            valid_all[i] = F.pad(valid_i, (lpad, 0))
            if need_logits:
                logits_all[i] = lm_head(params["llama"], hidden[g])

    labels = torch.stack(labels_all)   # (K, B, L)
    ce = torch.stack(ce_all)           # (K, B, L-1)
    valid = torch.stack(valid_all)
    losses_lm = torch.stack([
        L.reduce_token_losses(ce[k], valid[k], cfg.preset.lm_loss_type,
                              unreduced=True)
        for k in range(K)], dim=1)     # (B, K)
    logits = torch.stack(logits_all) if need_logits else None
    return logits, labels, gating_prob, losses_lm, ce, valid


def m3_loss(params: dict, cfg: LlavaConfig, batch: M3Batch,
            argmaxcost_ema: Optional[torch.Tensor] = None,
            uniform_buffer: bool = False,
            frozen_vision: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full M3(+MoE) objective.  Returns (loss, metrics dict); every metric
    but ``loss`` is detached.

    Some objectives *replace* the base loss (bounderr, lmlossaddcost), the
    others *add* to it (distil, the load-balance terms).

    ``uniform_buffer`` forces the single-bucket forward (every scale padded
    to the largest capacity) in place of the capacity buckets, which save
    the padding's work; both give the same loss."""
    scales = cfg.tokscale_list
    K = len(scales)
    lm_loss_type = cfg.preset.lm_loss_type

    # the distillation objectives are the only readers of raw logits; every
    # other objective derives from per-token CE
    kvs = parse_kv_from_string(cfg.preset.moe) if cfg.is_m3_moe else {}
    obj = str(kvs.get("obj", "weightedlm"))
    need_logits = obj in ("distil", "distilpickteacher")

    out_len = (splice_capacity(cfg, batch.input_ids.shape[1], max(scales))
               if uniform_buffer else None)
    logits, labels, gating_prob, losses_lm, ce, valid = multiscale_forward(
        params, cfg, batch, need_logits=need_logits, out_len=out_len,
        frozen_vision=frozen_vision)
    metrics: Dict[str, torch.Tensor] = {}

    losses_lm_reduced = L.batch_mean(losses_lm, 0)  # (K,) per scale
    for k in range(K):
        metrics[f"moe/loss_lm_{k}"] = losses_lm_reduced[k]

    if gating_prob is None:
        # plain M3: the average of the per-scale LM losses
        loss = sum(L.reduce_token_losses(ce[k], valid[k], lm_loss_type)
                   for k in range(K)) / K
        return _finish(loss, metrics)

    # ---- M3-MoE ----
    # base: gating-weighted LM loss summed over scales
    loss = sum(L.reduce_token_losses(ce[k], valid[k], lm_loss_type,
                                     weights=gating_prob[:, k].float())
               for k in range(K))

    batch_assignment = L.per_expert_assignment(gating_prob)
    for k in range(K):
        metrics[f"moe/avg_gating_prob_{k}"] = L.batch_mean(gating_prob[:, k])
        metrics[f"moe/avg_expert_assignment_{k}"] = batch_assignment[k]

    gating_prob_argmax = None
    if obj.startswith("bounderr"):
        margin = float(kvs.get("margin", 0))
        tau = float(kvs.get("tau", 1))
        gating_prob_argmax = L.compute_gating_prob_argmax(gating_prob, tau)
        loss = L.bounderr_loss(losses_lm, gating_prob_argmax, margin,
                               squared=obj == "bounderrsq")
        losses_argmax = (losses_lm * gating_prob_argmax).sum(1)
        metrics["moe_bounderr/loss_argmaxscale_avg"] = \
            L.batch_mean(losses_argmax)
        metrics["moe_bounderr/loss_maxscale_avg"] = \
            L.batch_mean(losses_lm[:, -1])
        metrics["moe_bounderr/loss_diff_avg"] = \
            L.batch_mean(losses_argmax - losses_lm[:, -1])
    elif obj.startswith("lmlossaddcost"):
        lamb = float(kvs.get("lambda", 0.0))
        cost = L.get_per_expert_cost(str(kvs.get("costt", "count")),
                                     batch_assignment, scales)
        loss = L.lmlossaddcost_loss(losses_lm, gating_prob, cost, lamb)
    elif obj in ("distil", "distilpickteacher"):
        loss = loss + _distillation_loss(kvs, obj, logits, labels, scales,
                                         metrics)

    # ---- load balance ----
    loadb = kvs.get("loadb", None)
    if loadb == "switch":
        alpha = float(kvs["alpha"])
        cost = L.get_per_expert_cost(str(kvs.get("costt", "count")),
                                     batch_assignment, scales)
        loss_switch = L.switch_load_balance_loss(gating_prob, cost, alpha)
        loss = loss + loss_switch
        metrics["moe_load/loss_switch"] = loss_switch
        for k in range(K):
            metrics[f"moe_load/cost_{k}"] = cost[k]
    elif loadb == "argmaxcost":
        alpha = float(kvs["alpha"])
        cost = L.get_per_expert_cost(str(kvs.get("costt")), batch_assignment,
                                     scales)
        target_value = kvs.get("tval", None)
        numtoks_margin = kvs.get("tmargin", None)
        if gating_prob_argmax is None:
            gating_prob_argmax = L.compute_gating_prob_argmax(
                gating_prob, float(kvs.get("tau", 1)))
        argmaxcost = L.batch_mean(
            (gating_prob_argmax * cost.reshape(-1, K)).sum(1))
        batch_cost = argmaxcost.detach()
        metrics["moe_load/argmaxcost"] = batch_cost
        new_ema = None
        if kvs.get("emaa", None):
            alpha_ema = float(kvs["emaa"])
            # argmaxcost_ema < 0 flags "uninitialized" (cost lives in [0,1])
            ema_prev = (batch_cost if argmaxcost_ema is None
                        else torch.where(argmaxcost_ema < 0, batch_cost,
                                         argmaxcost_ema.to(batch_cost)))
            new_ema = alpha_ema * batch_cost + (1 - alpha_ema) * ema_prev
            batch_cost = new_ema
            metrics["moe_load/argmaxcost_ema"] = new_ema
        loss_amc = L.argmaxcost_ema_loss(
            gating_prob_argmax, cost, batch_cost, alpha,
            float(target_value) if target_value is not None else None,
            float(numtoks_margin) if numtoks_margin is not None else None)
        loss = loss + loss_amc
        metrics["moe_load/loss_argmaxcost"] = loss_amc
        if new_ema is not None:
            metrics["_state/argmaxcost_ema"] = new_ema
        for k in range(K):
            metrics[f"moe_load/cost_{k}"] = cost[k]
    elif loadb == "betalogprob":
        if K != 2:
            raise ValueError(f"#tokscale = {K} not supported for betalogprob")
        loss_beta = L.beta_logprob_loss(gating_prob, float(kvs["alpha"]),
                                        float(kvs["ba"]), float(kvs["bb"]))
        loss = loss + loss_beta
        metrics["moe_load/loss_beta_logprob"] = loss_beta

    return _finish(loss, metrics)


def _finish(loss, metrics):
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    return loss, metrics


def _distillation_loss(kvs, obj, logits, labels, scales, metrics):
    """Cross-scale knowledge distillation.  All scales share one
    left-padded L-token buffer, so teacher and student logits align token
    for token; the labels of the largest scale mask the loss."""
    temperature = float(kvs["temp"])
    alpha = float(kvs["alpha"])
    detach_t = bool(int(kvs.get("detacht", 0)))
    tokscales_s = [int(x) for x in parse_list(kvs["tss"])]
    tokscales_t = [int(x) for x in parse_list(kvs["tst"])]
    labels_ref = labels[-1]  # largest scale

    if obj == "distil":
        loss_distil = 0.0
        for ts in tokscales_s:
            for tt in tokscales_t:
                s_id, t_id = scales.index(ts), scales.index(tt)
                loss_distil = loss_distil + L.tokenwise_kd_loss(
                    logits[t_id], logits[s_id], labels_ref, temperature,
                    detach_t)
        loss_distil = alpha * loss_distil
        metrics["moe_distill/loss_distil"] = loss_distil
        return loss_distil

    # distilpickteacher
    teacher_type = str(kvs["teachert"])
    pickby = kvs.get("pickby", None)
    t_ids = [scales.index(t) for t in tokscales_t]
    logits_t_list = [logits[i] for i in t_ids]               # [(B, L, V)]
    best = None

    if teacher_type == "best":
        if pickby in L.SCORE_FNS:
            score_fn = L.SCORE_FNS[str(pickby)]
        else:
            def score_fn(lg, lb, level):
                return torch.full((lg.shape[0],), 1.0 / len(t_ids),
                                  device=lg.device)
        scores = torch.stack([score_fn(lg, labels_ref, level="seq")
                              for lg in logits_t_list], dim=1)  # (B, n_t)
        best = scores.argmax(dim=1)                             # (B,)
        stacked = torch.stack(logits_t_list, dim=0)             # (n_t,B,L,V)
        index = best[None, :, None, None].expand(1, *stacked.shape[1:])
        logits_t_best = torch.gather(stacked, 0, index)[0]
    elif teacher_type == "besttoken":
        score_fn = L.SCORE_FNS[str(pickby)]
        scores = torch.stack([score_fn(lg, labels_ref, level="token")
                              for lg in logits_t_list], dim=0)  # (n_t,B,L-1)
        scores = F.pad(scores, (0, 1))                          # pad to L
        best = scores.argmax(dim=0)                             # (B, L)
        stacked = torch.stack(logits_t_list, dim=0)
        index = best[None, :, :, None].expand(1, *stacked.shape[1:])
        logits_t_best = torch.gather(stacked, 0, index)[0]
    elif teacher_type == "cd":
        beta = float(kvs["beta"])
        gamma = float(kvs["gamma"])
        if len(logits_t_list) != 2:
            raise ValueError("Only support contrasting two teachers for now.")
        logits_exp, logits_ama = logits_t_list[1], logits_t_list[0]
        logits_t_best = (1 + beta) * logits_exp - beta * logits_ama
        if gamma > 0:
            probs_exp = torch.softmax(logits_exp, dim=-1)
            pmax = probs_exp.amax(dim=2, keepdim=True)
            logits_t_best = torch.where(probs_exp < gamma * pmax,
                                        float("-inf"), logits_t_best)
    elif teacher_type == "avg":
        logits_t_best = torch.stack(logits_t_list).mean(0)
    else:
        raise ValueError(f"invalid teacher_type {teacher_type}")

    distil_ignore_mode = int(kvs.get("sametsdistil", 0))
    loss_total = 0.0
    for ts in tokscales_s:
        s_id = scales.index(ts)
        labels_t = labels_ref
        if distil_ignore_mode > 0 and teacher_type in ("best", "besttoken"):
            t_scales = torch.tensor(tokscales_t,
                                    device=best.device)[best]  # (B,)|(B, L)
            if distil_ignore_mode == 1:
                ignore = t_scales == ts
            elif distil_ignore_mode == 2:
                ignore = t_scales <= ts
            else:
                raise ValueError(
                    f"Invalid `distil_ignore_mode` {distil_ignore_mode}")
            if teacher_type == "best":
                ignore = ignore[:, None].expand_as(labels_ref)
            labels_t = torch.where(ignore, IGNORE_INDEX, labels_ref)
        per_student = L.tokenwise_kd_loss(
            logits_t_best, logits[s_id], labels_t, temperature, detach_t,
            reduction="seqlevel_mean")
        loss_total = loss_total + L.batch_sum(per_student)

    loss_distil = alpha * loss_total
    metrics["moe_distill/loss_distil"] = loss_distil
    return loss_distil
