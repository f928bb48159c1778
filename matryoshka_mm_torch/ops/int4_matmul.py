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
weight byte feeds at most 16 FMAs.  The decode kernel (``csrc/quant_gemv.cuh``)
runs bf16 ``mma.sync`` products with the weights as the A operand,
dequantized in registers (mantissa tricks, no integer -> float
conversions), streams every weight byte once through per-warp ``cp.async``
rings (no L2 cache policy: ``cp.async`` with one faulted on the card), and
splits K over the ``parts`` warps of a block (:func:`gemv_parts`, plain
ints; :func:`int4_matmul_split_plain` is the same blocking of the f32 sums
in PyTorch).  At prefill (M > 8, up to MAX_FUSED_ROWS rows)
operations, 2 M a weight value: the prefill kernel
(``csrc/quant_matmul.cu`` ``quant_wgmma_kernel``) runs Hopper's
asynchronous ``wgmma`` products with both operands in swizzled shared
tiles (the activations and the dequantized weights), streams the
activations and the raw weight bytes through a four-stage ring filled by
tensor copies (TMA; ``cp.async`` where rows are not 16-byte aligned) and
dequantizes the next step's weights while the tensor cores multiply this
step's; exact, because int4/int8 values are exact in bf16.  Its block
(64 x 128 or 128 x 256 outputs) comes from M and N in the launcher
(:func:`mma_tile` reports it; ``_launch(..., tile=)`` fixes it for tests
and the sweep).  Any M, N and (even, for int4) K: the kernels mask their
ragged edges, so the TPU tile padding and block-divisor rules are gone.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises on what it does not take.  The eligibility rule of
the model (bf16 rows <= ``MAX_FUSED_ROWS``, outside
``disable_fused_proj()``) is applied by ``models/llama.py`` ``proj``, as
the JAX ``fused_int4_proj`` does.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from .decode_attention import H100_SMS, _sm_count
from .quant import Q4KEY, QKEY, unpack_int4

# Rows past which a projection dequantizes and multiplies instead (the JAX
# int4_matmul_eligible rule, 1,024 rows on the TPU).  On the H100 the
# kernel beat dequantize + bf16 F.linear at 3,008 rows by 1.94-2.18x
# (int4) and 1.10-1.23x (int8), and at 8,192 rows int8 lost (0.76-0.83x):
# chip_smoke.py phase 3, qkv / gateup / down.  3,072 holds an anyres
# prefill at scale 576 (3,008 slots in generate, the batcher's 3,072-slot
# region) and leaves serving groups of 4-8 rows of 1,024 to cuBLAS
MAX_FUSED_ROWS = 3072
GEMV_MAX_ROWS = 8       # rows at or below which the decode kernel runs
GEMV_UNITS = 32         # output channels a block (16 gate/up pairs: GLU)
GEMV_CHUNK = 128        # packed weight bytes of a row a warp takes a step
GEMV_MAX_PARTS = 8      # warps a block, each a share of the row's chunks
GEMV_WARPS_PER_SM = 16  # warps of a launch an SM at the most


def gemv_parts(N: int, K: int, bits: int, sms: int = H100_SMS,
               glu: bool = False) -> int:
    """Warps of a block over which the decode kernel splits K: the largest
    power of two, at most :data:`GEMV_MAX_PARTS`, with which every warp
    keeps a chunk of :data:`GEMV_CHUNK` packed bytes a row and the launch's
    warps stay within :data:`GEMV_WARPS_PER_SM` an SM.  A block owns
    :data:`GEMV_UNITS` output channels (under ``glu``, half as many gate/up
    pairs: ``N`` is then the number of pairs).  Plain ints only (a tensor
    raises), so the decode step never syncs to pick it; it changes the
    order of the f32 sums only."""
    for name, v in (("N", N), ("K", K), ("bits", bits), ("sms", sms)):
        if not isinstance(v, int) or isinstance(v, bool):
            raise TypeError(f"gemv_parts: {name} must be an int, got "
                            f"{type(v).__name__}")
    if not isinstance(glu, bool):
        raise TypeError(f"gemv_parts: glu must be a bool, got "
                        f"{type(glu).__name__}")
    if bits not in (4, 8) or N <= 0 or K <= 0 or sms <= 0:
        raise ValueError(f"gemv_parts: N={N}, K={K}, bits={bits}, sms={sms}")
    units = GEMV_UNITS // 2 if glu else GEMV_UNITS
    blocks = -(-N // units)
    chunks = -(-(K // 2 if bits == 4 else K) // GEMV_CHUNK)
    n = 1
    while (2 * n <= GEMV_MAX_PARTS and 2 * n <= chunks
           and blocks * 2 * n <= GEMV_WARPS_PER_SM * sms):
        n *= 2
    return n


def _part_columns(K: int, bits: int, parts: int, part: int) -> torch.Tensor:
    """The logical columns of K that warp ``part`` of ``parts`` sums: the
    packed byte chunks ``part, part + parts, ...`` (int4: their low-nibble
    columns and the same columns + K/2)."""
    KB = K // 2 if bits == 4 else K
    cols = torch.arange(KB)
    cols = cols[(cols // GEMV_CHUNK) % parts == part]
    return torch.cat([cols, cols + KB]) if bits == 4 else cols


def split_sums(x: torch.Tensor, q: torch.Tensor, bits: int,
               parts: int) -> torch.Tensor:
    """``f32(bf16(x) @ q^T)`` for an exact integer weight ``q (N, K)``
    summed as the decode kernel blocks it: one f32 partial a warp over its
    chunks' columns, the partials added in warp order."""
    xb = x.to(torch.bfloat16).float()
    qf = q.float()
    total = torch.zeros((x.shape[0], q.shape[0]), dtype=torch.float32,
                        device=x.device)
    for p in range(parts):
        cols = _part_columns(q.shape[1], bits, parts, p).to(x.device)
        total = total + xb[:, cols] @ qf[:, cols].t()
    return total


def int8_matmul_split_plain(x, q, scale, parts=None) -> torch.Tensor:
    """:func:`int8_matmul_plain` with the decode kernel's blocking of the
    f32 sums (``parts`` defaults to :func:`gemv_parts`).  For tests."""
    N, K = q.shape
    parts = gemv_parts(N, K, 8) if parts is None else parts
    y = split_sums(x, q, 8, parts)
    return (y * scale.reshape(1, -1).float()).to(torch.bfloat16)


def int4_matmul_split_plain(x, packed, scale, parts=None) -> torch.Tensor:
    """The same for an int4 leaf."""
    q = torch.cat(unpack_int4(packed), dim=-1)
    N, K = q.shape
    parts = gemv_parts(N, K, 4) if parts is None else parts
    y = split_sums(x, q, 4, parts)
    return (y * scale.reshape(1, -1).float()).to(torch.bfloat16)


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


def mma_tile(bits: int, M: int, N: int) -> tuple:
    """``((rows, channels, ring stages) of a block, shared bytes)``: the
    prefill kernel's configuration at M > 8 rows and N channels, as its
    launcher picks it.  Builds and loads the kernel library."""
    tile = (ctypes.c_int * 3)()
    smem = _kernels.library().m3_quant_mma_tile(bits, M, N, tile)
    return tuple(tile), smem


def _launch(name: str, bits: int, x: torch.Tensor, w: torch.Tensor,
            scale: torch.Tensor, parts=None, tile=None) -> torch.Tensor:
    """The kernel launch; ``parts`` (1 to 8) overrides :func:`gemv_parts`
    at M <= 8, ``tile`` = (rows, channels, ring stages) of a block, the
    prefill kernel's configuration at M > 8 (one that
    ``csrc/quant_matmul.cu`` builds), for the tests and the sweeps."""
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
    if parts is None:
        parts = gemv_parts(N, K, bits, _sm_count(x.device.index or 0)) \
            if M <= GEMV_MAX_ROWS else 1
    if not 1 <= parts <= GEMV_MAX_PARTS:
        raise ValueError(f"{name}: parts={parts} is not in 1.."
                         f"{GEMV_MAX_PARTS}")
    if tile is not None:
        if M <= GEMV_MAX_ROWS:
            raise ValueError(f"{name}: tile= is for M > {GEMV_MAX_ROWS}")
        err = _kernels.library().m3_quant_mma(
            bits, x.data_ptr(), w.data_ptr(), scale.data_ptr(),
            out.data_ptr(), M, N, K, x.stride(0), out.stride(0), *tile,
            _kernels.stream_ptr(x.device))
        _kernels.check("m3_quant_mma", err)
        return out
    err = _kernels.library().m3_quant_matmul(
        bits, x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, N, K, x.stride(0), out.stride(0), parts,
        _kernels.stream_ptr(x.device))
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
    _kernels.count_launch(int4_matmul)
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
    _kernels.count_launch(int8_matmul)
    return out


int4_matmul.launches = 0
int8_matmul.launches = 0


def leaf_matmul(x2: torch.Tensor, leaf: dict) -> torch.Tensor:
    """:func:`int4_matmul` or :func:`int8_matmul` on a quantized leaf."""
    if Q4KEY in leaf:
        return int4_matmul(x2, leaf[Q4KEY], leaf["scale"])
    return int8_matmul(x2, leaf[QKEY], leaf["scale"])
