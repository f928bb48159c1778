"""Weight-only quantized matrix products: the hand-written CUDA kernels
``csrc/quant_matmul.cu`` (with ``csrc/quant_gemv.cuh``) and their plain
PyTorch versions.

Replaces the Pallas TPU kernels ``matryoshka_mm_tpu/ops/int4_matmul.py``
``int4_matmul`` / ``int4_matmul_stacked`` (kernel ``_kernel``) and
``int8_matmul`` / ``int8_matmul_stacked`` (kernel ``_kernel8``).  The
stacked variants existed only to keep XLA from copying a layer slice; here
every layer's leaf is its own tensor.  Same function and numerics:

    out (M, N) = bf16( f32( bf16(x) @ W^T ) * scale )

with ``W`` the exact integer weight (int8, or int4 in the split-half e8m
packing of ``ops/quant.py``), products summed in f32 and the per-channel
scale applied once to the f32 sum.  The plain version computes exactly
that; it does not round the weights to bf16, so it is not
``dequantize_array`` + matmul.

What bounds it on the H100: at decode (M <= 8 rows) bytes, since each
weight byte feeds at most 16 FMAs; a byte-stream kernel reads every weight
byte once with 16-byte loads, unpacks nibbles in registers and serves all
rows from that read.  At prefill (up to 1024 rows on the main path)
arithmetic: bf16 tensor-core products (``mma.sync`` through WMMA) over a
weight tile dequantized into shared memory, exact because int4/int8 values
are exact in bf16.  Any M, N and (even, for int4) K: the kernels mask their
ragged edges, so the TPU tile padding and block-divisor rules are gone.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises on what it does not take.  The eligibility rule of
the model (bf16 rows <= 1024, outside ``disable_fused_proj()``) is applied
by ``models/llama.py`` ``proj``, as the JAX ``fused_int4_proj`` does.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .quant import Q4KEY, QKEY, unpack_int4

MAX_FUSED_ROWS = 1024   # the JAX int4_matmul_eligible row limit


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """``bf16(f32(bf16(x) @ q^T) * scale)`` for an exact integer weight
    ``q (N, K)`` (int8, or unpacked int4) and a per-channel ``scale`` of N
    elements."""
    y = torch.matmul(x.to(torch.bfloat16).float(), q.float().t())
    return (y * scale.reshape(1, -1).float()).to(torch.bfloat16)


def int4_matmul_plain(x, packed, scale) -> torch.Tensor:
    return int8_matmul_plain(x, torch.cat(unpack_int4(packed), dim=-1),
                             scale)


def _launch(name: str, bits: int, x: torch.Tensor, w: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.bfloat16)          # the TPU kernel rounds x to bf16 too
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"{name}: x {tuple(x.shape)} and the weight "
                         f"{tuple(w.shape)} must be 2-D")
    M, K = x.shape
    N, kb = w.shape
    if kb * (2 if bits == 4 else 1) != K:
        raise ValueError(f"{name}: x has K={K}, the weight {tuple(w.shape)}")
    if w.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.numel() != N:
        raise ValueError(f"{name}: weight {w.dtype}, scale {scale.dtype} "
                         f"of {scale.numel()} elements; expected int8 and "
                         f"{N} float32")
    for what, t in (("x", x), ("weight", w), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on "
                             f"{x.device}")
    if x.stride(1) != 1 or not w.is_contiguous() \
            or not scale.is_contiguous():
        raise ValueError(f"{name}: x needs unit column stride, the weight "
                         f"and scale must be contiguous")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    err = _kernels.library().m3_quant_matmul(
        bits, x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, N, K, x.stride(0), out.stride(0), _kernels.stream_ptr(x.device))
    _kernels.check("m3_quant_matmul", err)
    return out


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``x (M, K) @ dequant(packed (N, K/2), scale (N, 1)).T -> (M, N)``
    bf16.  ``int4_matmul.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: no kernel for {x.device}")
    out = _launch("int4_matmul", 4, x, packed, scale)
    int4_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``x (M, K) @ (q (N, K) * scale (N, 1)).T -> (M, N)`` bf16.
    ``int8_matmul.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for {x.device}")
    out = _launch("int8_matmul", 8, x, q, scale)
    int8_matmul.launches += 1
    return out


int4_matmul.launches = 0
int8_matmul.launches = 0


def leaf_matmul(x2: torch.Tensor, leaf: dict) -> torch.Tensor:
    """:func:`int4_matmul` or :func:`int8_matmul` on a quantized leaf."""
    if Q4KEY in leaf:
        return int4_matmul(x2, leaf[Q4KEY], leaf["scale"])
    return int8_matmul(x2, leaf[QKEY], leaf["scale"])
