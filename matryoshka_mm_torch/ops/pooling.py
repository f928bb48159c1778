"""Matryoshka token-scale pooling (port of
``matryoshka_mm_tpu/ops/pooling.py``).

A (B, H*W, D) patch grid is average-pooled to ``numtoks`` visual tokens as
the product ``P @ X @ P^T`` with the (h, H) window-weight matrix of
``adaptive_avg_pool2d`` (floor/ceil windows, so non-divisor scales match
too), computed in f32 and cast back.  Plain tensor code: the JAX package
has no kernel here either.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _pooling_matrix_np(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic adaptive-average-pool weights:
    row i averages inputs [floor(i*in/out), ceil((i+1)*in/out))."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)
        w[i, start:end] = 1.0 / (end - start)
    return w


def pooling_matrix(out_size: int, in_size: int,
                   device=None) -> torch.Tensor:
    return torch.from_numpy(_pooling_matrix_np(out_size, in_size)).to(device)


def matryoshka_pool(image_features: torch.Tensor,
                    numtoks: int) -> torch.Tensor:
    """Pool (B, H*W, D) patch features to (B, numtoks, D); ``numtoks`` must
    be a perfect square."""
    B, HW, D = image_features.shape
    H = int(math.isqrt(HW))
    if H * H != HW:
        raise ValueError(f"feature count {HW} is not a square grid")
    h = int(math.isqrt(numtoks))
    if h * h != numtoks:
        raise ValueError(f"numtoks={numtoks} is not a perfect square")
    if numtoks == HW:
        return image_features

    x = image_features.float().reshape(B, H, H, D)
    p = pooling_matrix(h, H, image_features.device)
    x = torch.einsum("hH,BHWD->BhWD", p, x)
    x = torch.einsum("wW,BhWD->BhwD", p, x)
    return x.reshape(B, numtoks, D).to(image_features.dtype)
