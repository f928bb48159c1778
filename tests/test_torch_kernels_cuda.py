"""The hand-written CUDA kernels of the PyTorch port against their plain
PyTorch versions, on the card.  Every test is marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is false.  The file imports no JAX, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: bf16 ``atol=rtol=2e-2`` (bf16 outputs, probabilities rounded
to bf16 before PV), float32 ``1e-4``; lse ``1e-3``.  The quantized matrix
products: max error at most 1e-2 of max|plain| (bf16 output, f32 sums in
another order); the quantized MLP 2e-2 (its bf16 ``h`` may round the other
way).  Paged attention: the attention tolerances, bf16 and int8 pools alike
(the int8 math is f32 in kernel and plain version); the bandwidth probes
are exact (integer checksums, a byte copy).
"""

import pytest
import torch

from matryoshka_mm_torch.ops import decode_attention as tdec
from matryoshka_mm_torch.ops import flash_attention as tflash
from matryoshka_mm_torch.ops import fused_mlp as tmlp
from matryoshka_mm_torch.ops import hbm_probe as thbm
from matryoshka_mm_torch.ops import int4_matmul as tmm
from matryoshka_mm_torch.ops import paged_attention as tpaged
from matryoshka_mm_torch.ops import quant as tq

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


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-9)).item()


def _quant_leaf(bits, N, K, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((N, K), generator=g, device=dev, dtype=torch.bfloat16)
    return (tq.quantize_array_int4 if bits == 4 else tq.quantize_array)(
        w.mul_(0.02))


# the 7B projections: qkv, o, gateup, down (K/2 = 5504 is no power-of-two
# multiple), lm_head; then ragged shapes that take the masked edges and the
# scalar byte loop
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N,K", [(12288, 4096), (4096, 4096), (22016, 4096),
                                 (4096, 11008), (32000, 4096), (100, 200),
                                 (33, 46)])
@pytest.mark.parametrize("M", [1, 4, 640])
def test_quant_matmul_kernel_matches_plain(dev, bits, N, K, M):
    leaf = _quant_leaf(bits, N, K, dev)
    x = torch.randn((M, K), device=dev, dtype=torch.bfloat16)
    fn = tmm.int4_matmul if bits == 4 else tmm.int8_matmul
    plain = tmm.int4_matmul_plain if bits == 4 else tmm.int8_matmul_plain
    w = leaf[tq.Q4KEY if bits == 4 else tq.QKEY]
    before = fn.launches
    got = fn(x, w, leaf["scale"])
    assert fn.launches == before + 1
    want = plain(x, w, leaf["scale"])
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_matmul_kernel_takes_strided_rows(dev, bits):
    """The last position of a (B, L, D) hidden state, as lm_head gets it."""
    leaf = _quant_leaf(bits, 512, 256, dev)
    h = torch.randn((3, 7, 256), device=dev, dtype=torch.bfloat16)
    x = h[:, -1, :]
    w = leaf[tq.Q4KEY if bits == 4 else tq.QKEY]
    got = tmm.leaf_matmul(x, leaf)
    want = tmm.int8_matmul_plain(x, tq.int_weight(leaf), leaf["scale"])
    torch.cuda.synchronize()
    assert x.stride(0) == 7 * 256 and w.is_contiguous()
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 4, 20])
@pytest.mark.parametrize("D,I", [(4096, 11008), (256, 520)])
def test_quant_mlp_kernel_matches_plain(dev, bits, M, D, I):
    key = tq.Q4KEY if bits == 4 else tq.QKEY
    gate, up = _quant_leaf(bits, I, D, dev, 1), _quant_leaf(bits, I, D, dev, 2)
    gateup = {key: torch.cat([gate[key], up[key]]),
              "scale": torch.cat([gate["scale"], up["scale"]])}
    down = _quant_leaf(bits, D, I, dev, 3)
    x = torch.randn((M, D), device=dev, dtype=torch.bfloat16)
    before = tmlp.quant_mlp.launches
    got = tmlp.quant_mlp(x, gateup, down, bits, I)
    assert tmlp.quant_mlp.launches == before + 1
    want = tmlp.quant_mlp_plain(x, gateup, down, bits, I)
    torch.cuda.synchronize()
    assert got.shape == (M, D) and _rel_err(got, want) < 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,Dh,window", [
    (1, 32, 32, 672, 128, None), (4, 32, 32, 673, 128, None),
    (4, 32, 8, 672, 128, None), (4, 32, 32, 673, 128, 128),
    (3, 16, 2, 333, 64, 100)])
def test_decode_kernel_int8_kv_matches_plain(dev, dtype, B, H, Hkv, S, Dh,
                                             window):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, H, Dh), generator=g, device=dev, dtype=dtype)
    kq, ks = tq._quantize_kv_slots(
        torch.randn((3, B, S, Hkv, Dh), generator=g, device=dev))
    vq, vs = tq._quantize_kv_slots(
        torch.randn((3, B, S, Hkv, Dh), generator=g, device=dev))
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    valid[-1, :min(17, S - 1)] = False
    kv_pos = torch.arange(S, device=dev).expand(B, S)
    q_pos = torch.full((B,), max(S - 5, 1), device=dev)
    args = (q, kq[1], vq[1], valid, kv_pos, q_pos)
    kw = dict(sliding_window=window, k_scale=ks[1], v_scale=vs[1])
    before = tdec.flash_decode_attention.launches
    got = tdec.flash_decode_attention(*args, **kw)
    assert tdec.flash_decode_attention.launches == before + 1
    want = tdec.decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_quant_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    leaf = _quant_leaf(4, 64, 128, dev)
    x = torch.randn((2, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K="):
        tmm.int4_matmul(x[:, :64], leaf["qint4"], leaf["scale"])
    with pytest.raises(ValueError, match="int8"):
        tmm.int4_matmul(x, leaf["qint4"].float(), leaf["scale"])
    with pytest.raises(ValueError, match="quant_mlp"):
        tmlp.quant_mlp(x, leaf, leaf, 4, 64)
    with pytest.raises(ValueError, match="int8 cache"):
        kq = torch.zeros((1, 8, 2, 128), dtype=torch.int8, device=dev)
        tdec.flash_decode_attention(
            torch.randn((1, 2, 128), device=dev), kq, kq,
            torch.ones((1, 8), dtype=torch.bool, device=dev),
            torch.arange(8, device=dev)[None], torch.tensor([7], device=dev))


def _paged_case(dev, dtype, int8, B, H, Hkv, Dh, page, P, row_len, seed=0):
    """Pools of 3 layers, scattered non-monotone page tables, one layer's
    arguments for the wrapper."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = B * P + 1
    q = torch.randn((B, H, Dh), generator=g, device=dev, dtype=dtype)
    shape = (3, n_pages, page, Hkv, Dh)
    k = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    v = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    ks = vs = None
    if int8:
        k, ks = tq._quantize_kv_slots(k)
        v, vs = tq._quantize_kv_slots(v)
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    tables = perm[:B * P].reshape(B, P).to(torch.int32)
    lens = torch.tensor(row_len, device=dev, dtype=torch.int32)
    return q, k, v, ks, vs, tables, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,H,Hkv,Dh,page,P,row_len", [
    (1, 32, 32, 128, 64, 25, [700]),
    (8, 32, 32, 128, 64, 25, [0, 63, 64, 65, 1599, 700, 5, 128]),
    (4, 32, 8, 128, 64, 25, [0, 63, 64, 1599]),
    (3, 16, 2, 64, 8, 7, [0, 7, 55]),
    (2, 8, 1, 128, 16, 3, [1, 47])])
def test_paged_kernel_matches_plain(dev, dtype, int8, B, H, Hkv, Dh, page, P,
                                    row_len):
    q, k, v, ks, vs, tables, lens = _paged_case(
        dev, dtype, int8, B, H, Hkv, Dh, page, P, row_len)
    for layer in (0, 2):
        before = tpaged.paged_decode_attention.launches
        got = tpaged.paged_decode_attention_stacked(
            q, k, v, layer, tables, lens, ks, vs)
        assert tpaged.paged_decode_attention.launches == before + 1
        want = tpaged.paged_attention_plain(
            q, k[layer], v[layer], tables, lens,
            None if ks is None else ks[layer],
            None if vs is None else vs[layer])
        torch.cuda.synchronize()
        tol = _tol(dtype)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_paged_kernel_never_reads_past_the_row(dev):
    """Table entries past ceil(seq_len / page) may be anything, and pages
    the row does not use may hold NaN."""
    q, k, v, _, _, tables, lens = _paged_case(
        dev, torch.bfloat16, False, 2, 8, 8, 128, 16, 4, [17, 3])
    want = tpaged.paged_decode_attention(q, k[1], v[1], tables, lens)
    used = {int(tables[0, 0]), int(tables[0, 1]), int(tables[1, 0])}
    k2, v2 = k[1].clone(), v[1].clone()
    for p in range(k2.shape[0]):
        if p not in used:
            k2[p] = float("nan")
            v2[p] = float("nan")
    tables2 = tables.clone()
    tables2[0, 2:] = 10 ** 6
    tables2[1, 1:] = -5
    got = tpaged.paged_decode_attention(q, k2, v2, tables2, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("bad_id", [-1, 10 ** 6])
def test_paged_kernel_poisons_a_row_with_a_used_page_outside_the_pool(
        dev, int8, bad_id):
    """Where the plain version raises an index error, the kernel reads
    nothing and returns NaN for that row; the other rows are untouched."""
    q, k, v, ks, vs, tables, lens = _paged_case(
        dev, torch.bfloat16, int8, 3, 8, 4, 128, 16, 4, [17, 40, 3])
    scales = (None, None) if ks is None else (ks[1], vs[1])
    want = tpaged.paged_decode_attention(q, k[1], v[1], tables, lens, *scales)
    tables[1, 2] = bad_id                  # row 1 uses pages 0..2
    got = tpaged.paged_decode_attention(q, k[1], v[1], tables, lens, *scales)
    torch.cuda.synchronize()
    assert torch.isnan(got[1]).all()
    torch.testing.assert_close(got[[0, 2]], want[[0, 2]], atol=0, rtol=0)


def test_paged_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    q, k, v, _, _, tables, lens = _paged_case(
        dev, torch.float32, False, 1, 6, 2, 64, 8, 2, [3])
    with pytest.raises(ValueError, match="group"):          # group of 3
        tpaged.paged_decode_attention(q, k[0], v[0], tables, lens)
    q, k, v, _, _, tables, lens = _paged_case(
        dev, torch.float32, False, 1, 4, 2, 64, 8, 2, [3])
    with pytest.raises(ValueError, match="int8 pool"):
        tpaged.paged_decode_attention(q, k[0].to(torch.int8),
                                      v[0].to(torch.int8), tables, lens)
    with pytest.raises(ValueError, match="back to back"):
        tpaged.paged_decode_attention(q, k[0][::2], v[0][::2], tables,
                                      lens)


@pytest.mark.parametrize("n,reps", [(16 * 1000, 1), (16 * 300_001, 3),
                                    (1 << 26, 2)])
def test_hbm_probe_kernels_match_plain(dev, n, reps):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-127, 128, (n,), generator=g, device=dev,
                      dtype=torch.int8)
    before = thbm.hbm_read.launches, thbm.hbm_copy.launches
    got = thbm.hbm_read(x, reps)
    y = thbm.hbm_copy(x, reps)
    assert (thbm.hbm_read.launches, thbm.hbm_copy.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, thbm.hbm_read_plain(x, reps), atol=0,
                               rtol=0)
    assert torch.equal(y, thbm.hbm_copy_plain(x))


def test_hbm_probe_rates_are_positive_and_below_twice_the_data_sheet(dev):
    r = thbm.hbm_read_gb_s(mb=256, reps=2, runs=5)
    c = thbm.hbm_copy_gb_s(mb=128, reps=2, runs=5)
    for bw in (r, c):
        assert 0 < bw.lo <= bw.median <= bw.hi < 2 * 3350
