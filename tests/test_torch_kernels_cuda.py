"""The hand-written CUDA kernels of the PyTorch port against their plain
PyTorch versions, on the card.  Every test is marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is false.  The file imports no JAX, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: bf16 ``atol=rtol=2e-2`` (bf16 outputs, probabilities rounded
to bf16 before PV), float32 ``1e-4``; lse ``1e-3``.
"""

import pytest
import torch

from matryoshka_mm_torch.ops import decode_attention as tdec
from matryoshka_mm_torch.ops import flash_attention as tflash

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (hand-written CUDA kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("group,window,offset,causal", [
    (1, None, 0, True), (4, None, 0, True), (1, 64, 0, True),
    (2, None, 96, True), (1, None, 0, False)])
def test_flash_kernel_matches_plain(dev, dtype, Dh, group, window, offset,
                                    causal):
    B, H, Sq, Sk = 2, 8, 130, 300
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, H, Sq, Dh), generator=g, device=dev, dtype=dtype)
    # K/V as the strided (B, Hkv, S, Dh) view of a (B, S, Hkv, Dh) cache
    k = torch.randn((B, Sk, H // group, Dh), generator=g, device=dev,
                    dtype=dtype).transpose(1, 2)
    v = torch.randn((B, Sk, H // group, Dh), generator=g, device=dev,
                    dtype=dtype).transpose(1, 2)
    valid = torch.ones((B, Sk), dtype=torch.bool, device=dev)
    valid[1, :37] = False
    valid[:, 250:] = False
    kw = dict(causal=causal, kv_valid=valid, sliding_window=window,
              q_index_offset=offset)
    before = tflash.flash_attention_lse.launches
    out, lse = tflash.flash_attention_lse(q, k, v, **kw)
    assert tflash.flash_attention_lse.launches == before + 1
    want_o, want_l = tflash.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), want_o.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, want_l, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,Dh,window", [
    (1, 32, 32, 672, 128, None), (4, 32, 8, 672, 128, None),
    (3, 16, 2, 333, 64, 100), (2, 8, 1, 1000, 128, None),
    (2, 4, 2, 5, 64, None)])
def test_decode_kernel_matches_plain(dev, dtype, B, H, Hkv, S, Dh, window):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, H, Dh), generator=g, device=dev, dtype=dtype)
    k = torch.randn((3, B, S, Hkv, Dh), generator=g, device=dev, dtype=dtype)
    v = torch.randn((3, B, S, Hkv, Dh), generator=g, device=dev, dtype=dtype)
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    valid[-1, :min(17, S - 1)] = False
    kv_pos = torch.arange(S, device=dev).expand(B, S)
    q_pos = torch.full((B,), max(S - 5, 1), device=dev)
    args = (q, k[1], v[1], valid, kv_pos, q_pos)
    before = tdec.flash_decode_attention.launches
    got = tdec.flash_decode_attention(*args, sliding_window=window)
    assert tdec.flash_decode_attention.launches == before + 1
    want = tdec.decode_attention_plain(*args, sliding_window=window)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.randn((1, 2, 8, 32), device=dev)          # Dh = 32
    with pytest.raises(ValueError, match="Dh"):
        tflash.flash_attention(q, q, q)
    q = torch.randn((1, 2, 8, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        tflash.flash_attention(q, q, q)
    k = torch.randn((1, 2, 64, 8), device=dev).transpose(2, 3)   # Dh strided
    q = torch.randn((1, 2, 8, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q, k, k)
    qd = torch.randn((1, 6, 64), device=dev)
    kd = torch.randn((1, 10, 2, 64), device=dev)       # group of 3
    valid = torch.ones((1, 10), dtype=torch.bool, device=dev)
    pos = torch.arange(10, device=dev)[None]
    with pytest.raises(ValueError, match="group"):
        tdec.flash_decode_attention(qd, kd, kd, valid, pos,
                                    torch.tensor([9], device=dev))
