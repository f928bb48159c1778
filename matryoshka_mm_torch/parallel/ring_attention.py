"""Ring attention, sequence-parallel attention over a dim of a mesh of
ranks: port of ``matryoshka_mm_tpu/parallel/ring_attention.py``.

Each rank of the ``seq`` dim holds one block of the sequence: its queries,
keys and values ``(B, H, S / n, Dh)`` and its block of ``kv_valid``.  The
K/V blocks go round the ring (``collectives.py`` ``ring_shift``,
``ring.shift`` in a profile) while each rank attends its queries to every
block in turn and merges the blocks as flash attention merges tiles:

* by default (the JAX ``ring_fn``) each step is plain block attention in
  float32 scores (:func:`_block_attention`, no kernel in the JAX package
  either), merged by running maximum and sum; causality comes from the
  blocks' absolute positions, which rotate with them.  Differentiable: the
  shift's backward sends the K/V gradients back round the ring;
* ``use_flash=True`` (the JAX ``ring_fn_flash``): each step runs the flash
  kernel (``ops/flash_attention.py`` ``flash_attention_lse``; on a CPU
  tensor its plain version) and merges by the kernel's logsumexp.  From
  the block's home rank the step is full (an earlier block, or any block
  when not causal), diagonal-causal (its own block), or skipped (a later
  block, which the JAX package computes as zeros and a logsumexp of -1e30
  that the merge ignores).  Forward only, as in the JAX package: the
  result carries no gradient.

The ring makes ``n - 1`` shifts; the JAX package makes ``n``, the last of
which brings each block home unused.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import LSE_MASKED, flash_attention_lse
from .collectives import ring_shift

NEG = -1e30


def _block_attention(q, k, v, q_pos, kv_pos, kv_valid, causal: bool):
    """Block attention returning ``(out_unnormalized, row_max, row_sum)``,
    ``out_unnormalized = exp(s - m) @ v`` with ``m`` the block's row max,
    so that blocks merge as flash-attention tiles do."""
    Dh = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * Dh ** -0.5
    mask = kv_valid[:, None, None, :]
    if causal:
        mask = mask & (kv_pos[:, None, None, :] <= q_pos[:, None, :, None])
    s = torch.where(mask, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1)                                        # (B, H, Sq)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)                                         # (B, H, Sq)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return out, m, l


def _ring(q, k, v, pos, kv_valid, causal, group, n):
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m_run = torch.full(q.shape[:3], NEG, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    blk = [k, v, pos, kv_valid]
    for step in range(n):
        out, m_blk, l_blk = _block_attention(q, blk[0], blk[1], pos, blk[2],
                                             blk[3], causal)
        m_new = torch.maximum(m_run, m_blk)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(m_blk - m_new)
        acc = acc * alpha[..., None] + out * beta[..., None]
        l_run = l_run * alpha + l_blk * beta
        m_run = m_new
        if step < n - 1:
            blk = ring_shift(blk, group, 1, "ring.shift")
    safe = torch.where(l_run == 0.0, torch.ones_like(l_run), l_run)
    return (acc / safe[..., None]).to(q.dtype)


@torch.no_grad()
def _ring_flash(q, k, v, kv_valid, causal, group, n, idx):
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_run = torch.full(q.shape[:3], LSE_MASKED, dtype=torch.float32,
                         device=q.device)
    blk = [k, v, kv_valid]
    for step in range(n):
        src = (idx - step) % n                 # the block's home rank
        if not causal or src < idx:
            diag = False
        elif src == idx:
            diag = True
        else:
            diag = None                        # a later block: nothing
        if diag is not None:
            out, lse = flash_attention_lse(q, blk[0], blk[1], causal=diag,
                                           kv_valid=blk[2])
            lse_new = torch.logaddexp(lse_run, lse)
            # -1e30 marks a row that attended nothing: its term adds zero
            w_old = torch.exp((lse_run - lse_new).clamp(max=0.0)) \
                * (lse_run > -1e29)
            w_new = torch.exp((lse - lse_new).clamp(max=0.0)) \
                * (lse > -1e29)
            acc = acc * w_old[..., None] + out.float() * w_new[..., None]
            lse_run = lse_new
        if step < n - 1:
            blk = ring_shift(blk, group, 1, "ring.shift")
    return acc.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   *, causal: bool = True,
                   kv_valid: Optional[torch.Tensor] = None,
                   seq_axis: str = "seq",
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Attention over the whole sequence for this rank's block of it.

    ``q``, ``k``, ``v``: ``(B, H, S / n, Dh)``, block ``i`` of the sequence
    on the rank at coordinate ``i`` of ``mesh``'s ``seq_axis`` dim (of
    ``n`` ranks); ``kv_valid``: its ``(B, S / n)`` block (all valid when
    None).  Returns this rank's ``(B, H, S / n, Dh)`` block of the output.
    ``use_flash`` (default False) runs each step on the flash kernel,
    forward only.  Every rank of the dim calls it."""
    dim = mesh.mesh_dim_names.index(seq_axis)
    n, idx = mesh.size(dim), mesh.get_local_rank(seq_axis)
    group = mesh.get_group(dim)
    B, _, Sl, _ = q.shape
    if kv_valid is None:
        kv_valid = torch.ones((B, Sl), dtype=torch.bool, device=q.device)
    kv_valid = kv_valid.to(torch.bool)
    if use_flash:
        return _ring_flash(q, k, v, kv_valid, causal, group, n, idx)
    pos = (idx * Sl + torch.arange(Sl, device=q.device)).expand(B, Sl)
    return _ring(q, k, v, pos, kv_valid, causal, group, n)
