"""Operations and bytes of the work the benchmark drives, counted from
shapes: the yardstick of every ``*_roofline`` and ``mfu.*`` metric.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its full 700 W
power limit (dense, no sparsity): 989 TFLOP/s in bf16 and 3.35 TB/s of
HBM.  A card set below 700 W runs slower under load; the harness prints
the card's power limit beside every share.

Conventions:

* a multiply-add is two operations;
* a roofline counts each input byte once and each output byte once, at
  the shapes a launch actually had, whatever the kernel reads again; the
  least time is the larger of operations over the peak rate and bytes
  over the peak bandwidth;
* model FLOPs (``mfu.*``) count what the model needs: the forward is
  ``2 * P`` a token for the matrix products plus attention's query-key
  pairs; a backward through a frozen base computes only the activation
  gradients (one more ``2 * P`` a token, and twice the forward's attention
  pairs), plus the LoRA products; a frozen tower runs forward only;
  recomputation is never counted.

Every function takes plain numbers (a :class:`DecoderShape` or a
:class:`VisionShape`), so the tests check them by hand at one shape.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
BF16 = 2


@dataclasses.dataclass(frozen=True)
class DecoderShape:
    layers: int
    hidden: int
    intermediate: int
    heads: int
    kv_heads: int
    vocab: int
    glu: bool = True      # SwiGLU (gate, up, down), else a plain MLP (up, down)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    def layer_matmul_params(self) -> int:
        """Weights of one layer's products: q, k, v, o and the MLP."""
        d, dh = self.hidden, self.head_dim
        attn = d * (self.heads * dh) * 2 + d * (self.kv_heads * dh) * 2
        mlp = (3 if self.glu else 2) * d * self.intermediate
        return attn + mlp

    def matmul_params(self) -> int:
        """Every product's weights, the vocabulary head included (the
        embedding lookup is no product)."""
        return self.layers * self.layer_matmul_params() \
            + self.vocab * self.hidden


@dataclasses.dataclass(frozen=True)
class VisionShape:
    layers_run: int           # encoder layers up to the select layer
    hidden: int
    intermediate: int
    image: int
    patch: int
    projector_out: int        # the projector's width (the decoder's hidden)
    projector_layers: int     # 2 for mlp2x_gelu

    @property
    def tokens(self) -> int:
        return (self.image // self.patch) ** 2 + 1


def attention_pairs_causal(length: int) -> int:
    """Query-key pairs of a causal prefill of ``length`` tokens."""
    return length * (length + 1) // 2


def decoder_forward_flops(d: DecoderShape, tokens: int, pairs: int,
                          head_rows: int) -> float:
    """Forward operations of the decoder over ``tokens`` token positions
    whose attention spans ``pairs`` query-key pairs in all, with the
    vocabulary head run on ``head_rows`` positions: ``2 P`` a token for the
    layers' products, ``4 H Dh`` a pair a layer (scores and the weighted
    sum), ``2 V D`` a head row."""
    layer = 2.0 * d.layer_matmul_params() * tokens
    attn = 4.0 * d.heads * d.head_dim * pairs
    head = 2.0 * d.vocab * d.hidden * head_rows
    return d.layers * (layer + attn) + head


def prefill_flops(d: DecoderShape, length: int) -> float:
    """One request's prefill of ``length`` spliced tokens, the last
    position through the head (what a served prefill computes)."""
    return decoder_forward_flops(d, length, attention_pairs_causal(length), 1)


def decode_token_flops(d: DecoderShape, context: int) -> float:
    """One decode token attending over ``context`` slots (itself
    included)."""
    return decoder_forward_flops(d, 1, context, 1)


def vision_flops(v: VisionShape, images: int) -> float:
    """The frozen tower's forward (patch embedding, the layers up to the
    select layer) and the projector over its patch tokens, for ``images``
    images of one tile each."""
    n = v.tokens
    patch_in = 3 * v.patch * v.patch
    embed = 2.0 * (n - 1) * patch_in * v.hidden
    layer = 2.0 * n * (4 * v.hidden ** 2 + 2 * v.hidden * v.intermediate) \
        + 4.0 * v.hidden * n * n
    proj = 2.0 * (n - 1) * (v.hidden * v.projector_out
                            + (v.projector_layers - 1) * v.projector_out
                            * v.projector_out)
    return images * (embed + v.layers_run * layer + proj)


# ---------------------------------------------------------------------------
# kernel #7: paged decode attention
# ---------------------------------------------------------------------------

def paged_attention_launch(seq_lens: Iterable[int], heads: int, kv_heads: int,
                           head_dim: int, elem: int = BF16) -> tuple:
    """``(operations, bytes)`` of one launch of the paged decode kernel over
    the active rows whose slot counts (``row_len + 1``) are ``seq_lens``:
    each row reads its query, its ``seq_len`` K and V slots and writes its
    output; two operations a slot for the scores and two for the sum, a
    query head each."""
    seq_lens = list(seq_lens)
    slots = sum(seq_lens)
    rows = len(seq_lens)
    ops = 4.0 * heads * head_dim * slots
    nbytes = (2.0 * kv_heads * head_dim * slots
              + 2.0 * rows * heads * head_dim) * elem
    return ops, nbytes


def round_paged_work(lengths: Sequence[int], budget: Sequence[int],
                     active: Sequence[bool], steps: int, layers: int,
                     heads: int, kv_heads: int, head_dim: int,
                     elem: int = BF16) -> tuple:
    """``(operations, bytes, launches, rows_steps)`` of the paged kernel over
    one decode round of ``steps`` steps: row ``b`` is live for
    ``min(steps, budget[b])`` steps if active, and at step ``s`` attends
    ``lengths[b] + s + 1`` slots; every step launches the kernel once a
    layer."""
    ops = nbytes = 0.0
    rows_steps = 0
    for s in range(steps):
        lens = [int(n) + s + 1 for n, b, a in zip(lengths, budget, active)
                if a and s < int(b)]
        rows_steps += len(lens)
        if lens:
            o, by = paged_attention_launch(lens, heads, kv_heads, head_dim,
                                           elem)
            ops += o * layers
            nbytes += by * layers
    return ops, nbytes, steps * layers, rows_steps


def roofline_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: operations at the bf16 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


# ---------------------------------------------------------------------------
# training: kernel #3 (flash backward) and the M3 LoRA step
# ---------------------------------------------------------------------------

def flash_bwd_work(lengths: Sequence[int], heads: int, kv_heads: int,
                   head_dim: int, layers: int, elem: int = BF16) -> tuple:
    """``(operations, bytes)`` of kernel #3's two launches (dQ, then dK and
    dV) over causal rows of ``lengths`` real tokens, every layer.  The
    operations are the five products a backward from the saved ``lse``
    needs (scores again, then dP, dV, dQ and dK), two a multiply-add, over
    the causal pairs; the bytes read q, k, v, the output and its gradient
    and the f32 ``lse`` once, and write dq, dk and dv once."""
    ops = nbytes = 0.0
    for n in lengths:
        pairs = n * (n + 1) / 2
        ops += 5 * 2.0 * heads * head_dim * pairs
        nbytes += n * head_dim * elem * (4 * heads + 4 * kv_heads) \
            + n * heads * 4
    return ops * layers, nbytes * layers


def train_step_flops(d: DecoderShape, v: VisionShape, rows: Sequence[int],
                     labelled: int, images: int,
                     lora_params_per_layer: int) -> float:
    """Model FLOPs of one M3 LoRA step: ``rows`` are the lengths of every
    (scale, sample) sequence, ``labelled`` the tokens the loss reads (the
    head runs forward and backward on those only), ``images`` the batch's
    images.  The frozen tower runs forward; the projector forward and its
    weight gradients; the frozen decoder forward and its activation
    gradients (``2 P`` a token each, attention's pairs once forward and
    twice backward); each LoRA pair forward, its activation gradient and
    its two weight gradients (``lora_params_per_layer`` = the sum over the
    targeted projections of ``r * (in + out)``)."""
    tokens = sum(rows)
    pairs = sum(n * (n + 1) // 2 for n in rows)
    attn = 4.0 * d.heads * d.head_dim * pairs * d.layers
    base = 2.0 * d.layers * d.layer_matmul_params() * tokens
    head = 2.0 * d.vocab * d.hidden * labelled
    lora = 2.0 * d.layers * lora_params_per_layer * tokens
    fwd = base + attn + head + lora
    bwd = base + 2 * attn + head + 3 * lora
    n_patch = v.tokens - 1
    proj_w = 2.0 * n_patch * images * (
        v.hidden * v.projector_out
        + (v.projector_layers - 1) * v.projector_out * v.projector_out)
    return fwd + bwd + vision_flops(v, images) + proj_w


def flash_fwd_work(lengths: Sequence[int], heads: int, kv_heads: int,
                   head_dim: int, layers: int, elem: int = BF16) -> tuple:
    """``(operations, bytes)`` of kernel #1 over causal rows of ``lengths``
    real tokens, every layer: scores and the weighted sum over the causal
    pairs; q, k and v read once, the output and the f32 ``lse`` written
    once."""
    ops = nbytes = 0.0
    for n in lengths:
        ops += 4.0 * heads * head_dim * n * (n + 1) / 2
        nbytes += n * head_dim * elem * (2 * heads + 2 * kv_heads) \
            + n * heads * 4
    return ops * layers, nbytes * layers
