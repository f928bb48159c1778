"""Quantized decode MLP, ``down(bf16(silu(g) * u))`` with ``g, u`` the
f32 halves of ``x @ gateup^T``: the hand-written CUDA kernels
``csrc/fused_mlp.cu`` and their plain PyTorch version.

Replaces the Pallas TPU kernel ``matryoshka_mm_tpu/ops/fused_mlp.py``
``quant_mlp_stacked`` (kernel ``_mlp_kernel``), int4 or int8 weights in the
fused ``gateup_proj`` layout (gate rows, then up rows) and decode-narrow
rows.  Same single rounding point: gate and up stay f32 after their
per-channel scales, ``h = silu(g) * u`` is formed in f32 and rounded once
to bf16, then the down projection runs with the numerics of
``ops/int4_matmul.py``.

What bounds it on the H100: bytes (decode rows, each weight byte feeds at
most a few FMAs).  Blocks of a CUDA grid cannot wait on each other, so the
TPU kernel's one sequential grid becomes two launches on one stream: a
gate/up kernel in which a warp reads rows ``i`` and ``i + I`` of
``gateup`` for every activation row and writes only ``h[:, i]`` in bf16,
then the down projection through the byte stream of ``int4_matmul`` /
``int8_matmul``.  Every weight byte is read once; ``h`` makes one trip
through L2.  ``quant_mlp.launches`` counts one per call (both kernels).

Dispatch: a CPU tensor goes to :func:`quant_mlp_plain`; a CUDA tensor
launches the kernels or raises.  The model applies the JAX eligibility
rule (fused layout, bf16, rows <= 32, outside ``disable_fused_proj()``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _kernels
from .int4_matmul import int8_matmul_plain
from .quant import Q4KEY, QKEY, int_weight

MAX_ROWS = 32   # the JAX quant_mlp_eligible bound (bm <= 32)


def _key(leaf: dict, bits: int) -> str:
    key = Q4KEY if bits == 4 else QKEY
    if bits not in (4, 8) or key not in leaf:
        raise ValueError(f"quant_mlp: bits={bits} and a leaf with keys "
                         f"{sorted(leaf)}")
    return key


def quant_mlp_plain(x: torch.Tensor, gateup: dict, down: dict, bits: int,
                    i_orig: int) -> torch.Tensor:
    """Plain PyTorch version: the same formula in f32 / bf16."""
    _key(gateup, bits)
    _key(down, bits)
    xb = x.to(torch.bfloat16).float()
    gu = torch.matmul(xb, int_weight(gateup).float().t()) \
        * gateup["scale"].reshape(1, -1)
    g, u = gu[:, :i_orig], gu[:, i_orig:2 * i_orig]
    h = (F.silu(g) * u).to(torch.bfloat16)
    return int8_matmul_plain(h, int_weight(down), down["scale"])


def _launch(x, gateup, down, bits, i_orig):
    x = x.to(torch.bfloat16)
    kg, kd = _key(gateup, bits), _key(down, bits)
    gw, dw = gateup[kg], down[kd]
    M, D = x.shape
    per = 2 if bits == 4 else 1
    n_out = dw.shape[0]
    if gw.shape != (2 * i_orig, D // per) or D % per \
            or dw.shape[1] * per != i_orig:
        raise ValueError(f"quant_mlp: x {tuple(x.shape)}, gateup "
                         f"{tuple(gw.shape)}, down {tuple(dw.shape)}, "
                         f"I={i_orig}")
    gs, ds = gateup["scale"], down["scale"]
    for name, t in (("gateup", gw), ("down", dw), ("gateup scale", gs),
                    ("down scale", ds)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"quant_mlp: {name} must be contiguous on "
                             f"{x.device}")
    if gs.dtype != torch.float32 or ds.dtype != torch.float32 \
            or gs.numel() != 2 * i_orig or ds.numel() != n_out:
        raise ValueError("quant_mlp: scales must be float32, one per row")
    if x.stride(1) != 1:
        raise ValueError("quant_mlp: x needs unit column stride")
    h = torch.empty((M, i_orig), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((M, n_out), dtype=torch.bfloat16, device=x.device)
    err = _kernels.library().m3_quant_mlp(
        bits, x.data_ptr(), gw.data_ptr(), gs.data_ptr(), dw.data_ptr(),
        ds.data_ptr(), h.data_ptr(), out.data_ptr(), M, D, i_orig, n_out,
        x.stride(0), out.stride(0), _kernels.stream_ptr(x.device))
    _kernels.check("m3_quant_mlp", err)
    return out


def quant_mlp(x: torch.Tensor, gateup: dict, down: dict, bits: int,
              i_orig: int) -> torch.Tensor:
    """``x (M, D)`` -> ``(M, n_out)`` bf16 for quantized leaves ``gateup``
    (``2 * i_orig`` rows) and ``down`` (input width ``i_orig``)."""
    if x.device.type == "cpu":
        return quant_mlp_plain(x, gateup, down, bits, i_orig)
    if x.device.type != "cuda":
        raise ValueError(f"quant_mlp: no kernel for {x.device}")
    out = _launch(x, gateup, down, bits, i_orig)
    quant_mlp.launches += 1
    return out


quant_mlp.launches = 0
