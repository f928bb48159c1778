"""The hand-written CUDA kernels of the PyTorch port against their plain
PyTorch versions, on the card.  Every test is marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is false.  The file imports no JAX, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: bf16 ``atol=rtol=2e-2`` (bf16 outputs, probabilities rounded
to bf16 before PV), float32 ``1e-4``; lse ``1e-3``.  The flash forward's
tile-edge cases hold both designs (tensor cores in bf16, f32 FMAs in
float32) against the whole-matrix and the tiled plain versions; the decode
kernel runs at every ``n_split`` against the plain and the split plain
version.  The flash-attention
backward kernels: max error at most 2e-2 (bf16) and 2e-4 (float32) of
max|plain| (p and ds rounded to bf16 on slightly other f32; f32 sums in
another order), no NaN, and exactly 0 on masked rows and slots.  The quantized matrix
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
    (2, 4, 2, 5, 64, None),
    # ver=v2 steps: 5 scales of one row, 5 scales of 4 rows
    (5, 32, 32, 672, 128, None), (20, 32, 32, 672, 128, None)])
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
# scalar byte loop (K = 4100: no whole 64-k step, K/2 no multiple of 16).
# M up to 8 takes the decode kernel, above it the prefill kernel: around
# its 64-row tiles, the main path's prefill rows and a 1024-row admission
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N,K", [(12288, 4096), (4096, 4096), (22016, 4096),
                                 (4096, 11008), (32000, 4096), (100, 200),
                                 (33, 46), (4096, 4100)])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 9, 20, 63, 64, 65, 127,
                               129, 640, 768, 1024])
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
@pytest.mark.parametrize("B", [3, 8, 200])
def test_quant_matmul_kernel_takes_strided_rows(dev, bits, B):
    """The last position of a (B, L, D) hidden state, as lm_head gets it."""
    leaf = _quant_leaf(bits, 512, 256, dev)
    h = torch.randn((B, 7, 256), device=dev, dtype=torch.bfloat16)
    x = h[:, -1, :]
    w = leaf[tq.Q4KEY if bits == 4 else tq.QKEY]
    got = tmm.leaf_matmul(x, leaf)
    want = tmm.int8_matmul_plain(x, tq.int_weight(leaf), leaf["scale"])
    torch.cuda.synchronize()
    assert x.stride(0) == 7 * 256 and w.is_contiguous()
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 4, 8, 20, 32])
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


# the 7B shapes whose K the decode kernel splits over 8 warps (o, down),
# and gate/up; M = 640 is a prefill through the prefill kernel
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N,K", [(4096, 4096), (4096, 11008), (22016, 4096)])
@pytest.mark.parametrize("M", [1, 8, 640])
def test_quant_matmul_kernel_is_deterministic(dev, bits, N, K, M):
    """Two launches give the same bits (the decode kernel's warp partial
    sums are added in a fixed order; the prefill kernel has no K split)."""
    leaf = _quant_leaf(bits, N, K, dev)
    x = torch.randn((M, K), device=dev, dtype=torch.bfloat16)
    w = leaf[tq.Q4KEY if bits == 4 else tq.QKEY]
    fn = tmm.int4_matmul if bits == 4 else tmm.int8_matmul
    a, b = fn(x, w, leaf["scale"]), fn(x, w, leaf["scale"])
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("parts", [1, 2, 4, 8])
@pytest.mark.parametrize("N,K,M", [(4096, 11008, 8), (100, 200, 5),
                                   (33, 46, 1)])
def test_quant_matmul_kernel_at_every_split(dev, bits, parts, N, K, M):
    """The decode kernel with K split over 1 to 8 warps against the plain
    version and its split twin."""
    leaf = _quant_leaf(bits, N, K, dev)
    x = torch.randn((M, K), device=dev, dtype=torch.bfloat16)
    w = leaf[tq.Q4KEY if bits == 4 else tq.QKEY]
    split = tmm.int4_matmul_split_plain if bits == 4 \
        else tmm.int8_matmul_split_plain
    got = tmm._launch("matmul", bits, x, w, leaf["scale"], parts=parts)
    want = tmm.int8_matmul_plain(x, tq.int_weight(leaf), leaf["scale"])
    twin = split(x, w, leaf["scale"], parts)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-2 and _rel_err(got, twin) <= 1e-2


# every configuration csrc/quant_matmul.cu builds for the prefill kernel:
# (rows, channels, ring stages) of a block
MMA_TILES = [(64, 128, 4), (128, 256, 4)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("tile", MMA_TILES)
@pytest.mark.parametrize("N,K,M", [(4096, 11008, 640), (4096, 4100, 65),
                                   (100, 200, 129), (33, 46, 9)])
def test_quant_mma_kernel_at_every_tile(dev, bits, tile, N, K, M):
    """The prefill kernel at each configuration against the plain
    version, and bit-identical to the configuration the launcher picks:
    the tile decides which block sums an output, not the order of its
    sum."""
    leaf = _quant_leaf(bits, N, K, dev)
    x = torch.randn((M, K), device=dev, dtype=torch.bfloat16)
    w = leaf[tq.Q4KEY if bits == 4 else tq.QKEY]
    got = tmm._launch("matmul", bits, x, w, leaf["scale"], tile=tile)
    picked = tmm._launch("matmul", bits, x, w, leaf["scale"])
    want = tmm.int8_matmul_plain(x, tq.int_weight(leaf), leaf["scale"])
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-2
    assert torch.equal(got, picked)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("extra", [1, 8])
@pytest.mark.parametrize("M", [130, 640])
def test_quant_mma_kernel_takes_any_row_pitch(dev, bits, extra, M):
    """Rows `extra` values longer than K: tensor copies of the activations
    where the rows stay 16-byte aligned (8), cp.async with masked element
    loads where they do not (1)."""
    N, K = 4096, 4096
    leaf = _quant_leaf(bits, N, K, dev)
    x = torch.randn((M, K + extra), device=dev, dtype=torch.bfloat16)[:, :K]
    w = leaf[tq.Q4KEY if bits == 4 else tq.QKEY]
    fn = tmm.int4_matmul if bits == 4 else tmm.int8_matmul
    got = fn(x, w, leaf["scale"])
    want = tmm.int8_matmul_plain(x, tq.int_weight(leaf), leaf["scale"])
    torch.cuda.synchronize()
    assert x.stride(0) == K + extra and _rel_err(got, want) <= 1e-2


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("tile", MMA_TILES)
def test_quant_mma_kernel_reads_the_weights_in_order(dev, bits, tile):
    """x = the identity: out[m, n] = bf16(W[n, m] * scale[n]) exactly, so a
    swizzle or k order that does not match the one the wgmma descriptors
    name shows as a permutation, not as noise."""
    N, K = 256, 256
    leaf = _quant_leaf(bits, N, K, dev)
    x = torch.eye(K, device=dev, dtype=torch.bfloat16)
    w = leaf[tq.Q4KEY if bits == 4 else tq.QKEY]
    got = tmm._launch("matmul", bits, x, w, leaf["scale"], tile=tile)
    want = (tq.int_weight(leaf).float().t()
            * leaf["scale"].reshape(1, -1)).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 8])
def test_quant_mlp_kernel_is_deterministic(dev, bits, M):
    key = tq.Q4KEY if bits == 4 else tq.QKEY
    D, I = 4096, 11008
    gate, up = _quant_leaf(bits, I, D, dev, 1), _quant_leaf(bits, I, D, dev, 2)
    gateup = {key: torch.cat([gate[key], up[key]]),
              "scale": torch.cat([gate["scale"], up["scale"]])}
    down = _quant_leaf(bits, D, I, dev, 3)
    x = torch.randn((M, D), device=dev, dtype=torch.bfloat16)
    a = tmlp.quant_mlp(x, gateup, down, bits, I)
    b = tmlp.quant_mlp(x, gateup, down, bits, I)
    want = tmlp.quant_mlp_split_plain(x, gateup, down, bits, I)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and _rel_err(a, want) < 2e-2


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
    with pytest.raises(ValueError, match="tile="):
        tmm._launch("matmul", 4, x, leaf["qint4"], leaf["scale"],
                    tile=(64, 128, 4))
    with pytest.raises(RuntimeError, match="m3_quant_mma"):
        tmm._launch("matmul", 4, torch.randn((16, 128), device=dev),
                    leaf["qint4"], leaf["scale"], tile=(32, 128, 2))
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


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}


def _bwd_case(dev, dtype, Dh, B, H, Hkv, Sq, Sk, pad, seed=0):
    """Operands as the model hands them over: (B, heads, S, Dh) views of
    (B, S, heads, Dh) tensors, a left-padded first row."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def operand(heads, S):
        return torch.randn((B, S, heads, Dh), generator=g, device=dev,
                           dtype=torch.float32).to(dtype).transpose(1, 2)

    q, k, v, do = (operand(H, Sq), operand(Hkv, Sk), operand(Hkv, Sk),
                   operand(H, Sq))
    valid = torch.ones((B, Sk), dtype=torch.bool, device=dev)
    valid[0, :pad] = False
    return q, k, v, do, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("group,window,offset,causal,Sq,Sk", [
    (1, None, 0, True, 130, 130), (4, None, 0, True, 97, 97),
    (1, 48, 0, True, 200, 200), (2, None, 96, True, 70, 300),
    (1, None, 0, False, 65, 90), (1, None, 0, True, 1, 1)])
def test_flash_backward_kernels_match_plain(dev, dtype, Dh, group, window,
                                            offset, causal, Sq, Sk):
    B, H, pad = 2, 8, 0 if Sq == 1 else 11
    q, k, v, do, valid = _bwd_case(dev, dtype, Dh, B, H, H // group, Sq, Sk,
                                   pad)
    kw = dict(causal=causal, sliding_window=window, q_index_offset=offset)
    out, lse = tflash.flash_attention_lse(q, k, v, kv_valid=valid, **kw)
    args = (q, k, v, valid, out, lse, do)
    before = (tflash.flash_attention_bwd_dq.launches,
              tflash.flash_attention_bwd_dkv.launches)
    dq = tflash.flash_attention_bwd_dq(*args, **kw)
    dk, dv = tflash.flash_attention_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert (tflash.flash_attention_bwd_dq.launches,
            tflash.flash_attention_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    want = tflash.flash_attention_bwd_plain(*args, **kw)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and got.is_contiguous(), name
        assert torch.isfinite(got).all(), name
        err = (got.float() - w.float()).abs().max().item()
        # (with one query and one key dq and dk are 0 up to f32 rounding of
        # do . v - delta: the scale is at least that of the inputs, 1)
        assert err <= BWD_TOL[dtype] * max(w.float().abs().max().item(),
                                           1.0), (name, err)
    if causal and offset == 0 and pad:
        # queries that see no key, and masked slots, get exactly nothing
        assert torch.all(dq[0, :, :pad] == 0)
        assert torch.all(dk[0, :, :pad] == 0) and torch.all(dv[0, :, :pad] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_function_launches_both_kernels(dev, dtype):
    q, k, v, do, valid = _bwd_case(dev, dtype, 128, 2, 4, 2, 150, 150, 20, 1)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    counts = [fn.launches for fn in (tflash.flash_attention_lse,
                                     tflash.flash_attention_bwd_dq,
                                     tflash.flash_attention_bwd_dkv)]
    out = tflash.flash_attention(q, k, v, kv_valid=valid)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (tflash.flash_attention_lse,
                                   tflash.flash_attention_bwd_dq,
                                   tflash.flash_attention_bwd_dkv)] == \
        [c + 1 for c in counts]
    o, lse = tflash.flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                          kv_valid=valid)
    want = tflash.flash_attention_bwd_plain(q.detach(), k.detach(),
                                            v.detach(), valid, o, lse, do)
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2 * BWD_TOL[dtype] * w.float().abs().max().item()


def test_flash_backward_makes_an_unreadable_do_contiguous(dev):
    """``do`` with a strided head dim is copied, never read wrongly; a
    wrong dtype raises."""
    q, k, v, do, valid = _bwd_case(dev, torch.float32, 64, 1, 2, 2, 40, 40, 3)
    out, lse = tflash.flash_attention_lse(q, k, v, kv_valid=valid)
    wide = torch.zeros((1, 2, 40, 128), device=dev)
    wide[..., ::2] = do
    strided = wide[..., ::2]
    assert strided.stride(-1) == 2
    got = tflash.flash_attention_bwd(q, k, v, valid, out, lse, strided)
    want = tflash.flash_attention_bwd(q, k, v, valid, out, lse,
                                      do.contiguous())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="do is"):
        tflash.flash_attention_bwd(q, k, v, valid, out, lse, do.double())
    with pytest.raises(ValueError, match="Dh 64 or 128"):
        tflash.flash_attention_bwd(q[..., :32], k[..., :32], v[..., :32],
                                   valid, out[..., :32], lse, do[..., :32])


# Where a walk over 64 x 64 tiles goes wrong: (Dh, B, H, Hkv, Sq, Sk, window,
# offset, left padding of row 0)
BWD_TILE_EDGES = {
    "pad_150": (128, 2, 4, 4, 257, 257, None, 0, 150),
    "pad_70_dh64": (64, 2, 4, 2, 129, 129, None, 0, 70),
    "s63": (128, 1, 4, 4, 63, 63, None, 0, 5),
    "s64_dh64": (64, 1, 4, 4, 64, 64, None, 0, 0),
    "s65": (128, 2, 4, 4, 65, 65, None, 0, 3),
    "s129": (128, 1, 4, 4, 129, 129, None, 0, 64),
    "window_16": (128, 2, 4, 4, 300, 300, 16, 0, 7),
    "window_150_dh64": (64, 1, 4, 2, 300, 300, 150, 0, 70),
    "offset": (128, 2, 4, 4, 70, 131, None, 40, 3),
    "offset_window_dh64": (64, 1, 4, 4, 100, 260, 48, 160, 0),
    "gqa_4": (128, 2, 8, 2, 200, 200, None, 0, 66),
    "gqa_8_dh64": (64, 1, 8, 1, 131, 131, None, 0, 9),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(BWD_TILE_EDGES))
def test_flash_backward_tile_edges(dev, name, dtype):
    """Within tolerance of the whole-matrix plain versions and of the tiled
    walk, no NaN, exact zeros on masked rows and slots, and the same bits
    from two launches."""
    Dh, B, H, Hkv, Sq, Sk, window, offset, pad = BWD_TILE_EDGES[name]
    q, k, v, do, valid = _bwd_case(dev, dtype, Dh, B, H, Hkv, Sq, Sk, pad, 2)
    kw = dict(causal=True, sliding_window=window, q_index_offset=offset)
    out, lse = tflash.flash_attention_lse(q, k, v, kv_valid=valid, **kw)
    args = (q, k, v, valid, out, lse, do)
    got = tflash.flash_attention_bwd(*args, **kw)
    again = tflash.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    for want in (tflash.flash_attention_bwd_plain(*args, **kw),
                 tflash.flash_attention_bwd_tiled_plain(*args, **kw)):
        for nm, g, w in zip(("dq", "dk", "dv"), got, want):
            assert torch.isfinite(g).all(), nm
            err = (g.float() - w.float()).abs().max().item()
            assert err <= BWD_TOL[dtype] * w.float().abs().max().item(), \
                (nm, err)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    if offset == 0 and pad:
        for g in got:
            assert torch.all(g[0, :, :pad] == 0)


def _kernel_names(fn, part: str) -> list:
    """The names holding ``part`` of the kernels one call of ``fn`` ran, from
    a ``torch.profiler`` window that opens on a synchronized device and
    stays open 50 ms on each side of the call.  The profiler places the
    card's timestamps on the host's clock with an offset that moves by up
    to a few ms, and drops a kernel that lands outside the window: a window
    held open only for the call lost its one kernel in 10 of 300 tries,
    one with 50 ms on each side in none of 300
    (``scripts/diag_profiler_window.py``)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return sorted(e.key for e in prof.key_averages() if part in e.key)


def test_flash_backward_design_follows_the_dtype_alone(dev):
    """bfloat16 operands launch the tensor-core kernels, float32 operands
    the f32-FMA kernels: one launch each a call, told apart by the kernel
    names in a profile."""
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, valid = _bwd_case(dev, dtype, 128, 1, 4, 4, 130, 130, 7)
        out, lse = tflash.flash_attention_lse(q, k, v, kv_valid=valid)
        tflash.flash_attention_bwd(q, k, v, valid, out, lse, do)    # build
        counts = (tflash.flash_attention_bwd_dq.launches,
                  tflash.flash_attention_bwd_dkv.launches)
        names[dtype] = _kernel_names(
            lambda: tflash.flash_attention_bwd(q, k, v, valid, out, lse, do),
            "flash_bwd")
        assert (tflash.flash_attention_bwd_dq.launches,
                tflash.flash_attention_bwd_dkv.launches) == \
            (counts[0] + 1, counts[1] + 1)
    assert len(names[torch.bfloat16]) == len(names[torch.float32]) == 2
    assert all("_mma_kernel" in n for n in names[torch.bfloat16])
    assert not any("_mma_kernel" in n for n in names[torch.float32])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_raises_on_what_the_kernels_do_not_take(dev, dtype):
    q, k, v, do, valid = _bwd_case(dev, dtype, 96, 1, 2, 2, 40, 40, 3)
    out, lse = torch.zeros_like(q), torch.zeros((1, 2, 40), device=dev)
    with pytest.raises(ValueError, match="Dh 64 or 128"):
        tflash.flash_attention_bwd(q, k, v, valid, out, lse, do)
    q, k, v, do, valid = _bwd_case(dev, dtype, 64, 1, 2, 2, 40, 40, 3)
    out, lse = tflash.flash_attention_lse(q, k, v, kv_valid=valid)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="do is"):
        tflash.flash_attention_bwd(q, k, v, valid, out, lse, do.to(other))


# ---------------------------------------------------------------------------
# flash attention forward: the tensor-core design
# ---------------------------------------------------------------------------

# Where a walk over 64 x 64 tiles goes wrong: (Dh, B, H, Hkv, Sq, Sk, causal,
# window, offset, left padding of row 0)
FWD_TILE_EDGES = {
    "s63": (128, 1, 4, 4, 63, 63, True, None, 0, 5),
    "s64_dh64": (64, 1, 4, 4, 64, 64, True, None, 0, 0),
    "s65": (128, 2, 4, 4, 65, 65, True, None, 0, 3),
    "s129": (128, 1, 4, 4, 129, 129, True, None, 0, 64),
    "pad_70_dh64": (64, 2, 4, 2, 129, 129, True, None, 0, 70),
    "pad_150": (128, 2, 4, 4, 257, 257, True, None, 0, 150),
    "window_16": (128, 2, 4, 4, 300, 300, True, 16, 0, 7),
    "window_150_dh64": (64, 1, 4, 2, 300, 300, True, 150, 0, 70),
    "offset": (128, 2, 4, 4, 70, 131, True, None, 40, 3),
    "offset_window_dh64": (64, 1, 4, 4, 100, 260, True, 48, 160, 0),
    "gqa_4": (128, 2, 8, 2, 200, 200, True, None, 0, 66),
    "gqa_8_dh64": (64, 1, 8, 1, 131, 131, True, None, 0, 9),
    "non_causal": (128, 2, 4, 4, 65, 130, False, None, 0, 4),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(FWD_TILE_EDGES))
def test_flash_forward_tile_edges(dev, name, dtype):
    """Within tolerance of the whole-matrix and the tiled plain versions,
    no NaN, exactly 0 and lse = -1e30 on rows that see no key, the same
    bits from two launches, one count a call."""
    Dh, B, H, Hkv, Sq, Sk, causal, window, offset, pad = \
        FWD_TILE_EDGES[name]
    q, k, v, _, valid = _bwd_case(dev, dtype, Dh, B, H, Hkv, Sq, Sk, pad, 3)
    kw = dict(causal=causal, kv_valid=valid, sliding_window=window,
              q_index_offset=offset)
    before = tflash.flash_attention_lse.launches
    out, lse = tflash.flash_attention_lse(q, k, v, **kw)
    again = tflash.flash_attention_lse(q, k, v, **kw)
    assert tflash.flash_attention_lse.launches == before + 2
    torch.cuda.synchronize()
    tol = _tol(dtype)
    for want_o, want_l in (tflash.flash_attention_plain(q, k, v, **kw),
                           tflash.flash_attention_tiled_plain(q, k, v, **kw)):
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out.float(), want_o.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, want_l, atol=1e-3, rtol=1e-3)
    keyless = ~tflash._mask(B, Sq, Sk, valid, causal, window, offset,
                            dev).any(-1).expand(B, H, Sq)
    assert torch.all(out[keyless] == 0)
    assert torch.all(lse[keyless] == tflash.LSE_MASKED)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset", [0, 1536, 2560])
def test_flash_forward_at_a_chunked_prefill_offset(dev, dtype, offset):
    """A chunk of 512 queries of chunked_prefill's 3,072-token prompt at
    ``q_index_offset`` against a 3,136-slot cache: the first 41 slots
    padding, the slots past the prompt not written yet."""
    Sq, Sk, pad = 512, 3136, 41
    q, k, v, _, valid = _bwd_case(dev, dtype, 128, 1, 32, 32, Sq, Sk, pad, 5)
    valid[:, 3072:] = False
    kw = dict(kv_valid=valid, q_index_offset=offset)
    out, lse = tflash.flash_attention_lse(q, k, v, **kw)
    again = tflash.flash_attention_lse(q, k, v, **kw)
    want_o, want_l = tflash.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    keyless = ~tflash._mask(1, Sq, Sk, valid, True, None, offset,
                            dev).any(-1).expand(1, 32, Sq)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want_o.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse[~keyless], want_l[~keyless], atol=1e-3,
                               rtol=1e-3)
    assert torch.all(out[keyless] == 0)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


def test_flash_forward_design_follows_the_dtype_alone(dev):
    """bfloat16 operands launch the tensor-core kernel, float32 operands
    the f32-FMA kernel: one launch a call, told apart by the kernel names
    in a profile."""
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _, valid = _bwd_case(dev, dtype, 128, 1, 4, 4, 130, 130, 7)
        tflash.flash_attention_lse(q, k, v, kv_valid=valid)         # build
        count = tflash.flash_attention_lse.launches
        names[dtype] = _kernel_names(
            lambda: tflash.flash_attention_lse(q, k, v, kv_valid=valid),
            "flash_fwd")
        assert tflash.flash_attention_lse.launches == count + 1
    assert len(names[torch.bfloat16]) == len(names[torch.float32]) == 1
    assert "flash_fwd_mma_kernel" in names[torch.bfloat16][0]
    assert "_mma_kernel" not in names[torch.float32][0]


# ---------------------------------------------------------------------------
# decode attention: the slots split over a cluster
# ---------------------------------------------------------------------------

def _decode_case(dev, dtype, int8, B, H, Hkv, S, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, 128), generator=g, device=dev, dtype=dtype)
    k = torch.randn((2, B, S, Hkv, 128), generator=g, device=dev)
    v = torch.randn((2, B, S, Hkv, 128), generator=g, device=dev)
    kw = {}
    if int8:
        k, ks = tq._quantize_kv_slots(k)
        v, vs = tq._quantize_kv_slots(v)
        kw = dict(k_scale=ks[1], v_scale=vs[1])
    else:
        k, v = k.to(dtype), v.to(dtype)
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    kv_pos = torch.arange(S, device=dev).expand(B, S)
    q_pos = torch.full((B,), S - 1, device=dev)
    return [q, k[1], v[1], valid, kv_pos, q_pos], kw


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
def test_decode_kernel_at_every_split(dev, dtype, int8, n_split):
    """A row with its first 31 slots invalid and its last split wholly
    masked, a row with no valid slot at all (gives 0), a ragged S: within
    tolerance of the plain and the split plain version, the same bits from
    two launches, one count a call."""
    B, H, Hkv, S = 3, 16, 4, 677
    args, kw = _decode_case(dev, dtype, int8, B, H, Hkv, S)
    valid = args[3]
    valid[0, :31] = False
    valid[0, tdec.split_ranges(S, n_split)[-1][0]:] = False
    valid[1] = False
    before = tdec.flash_decode_attention.launches
    got = tdec._launch(*args, 0, n_split=n_split, **kw)
    again = tdec._launch(*args, 0, n_split=n_split, **kw)
    assert tdec.flash_decode_attention.launches == before + 2
    torch.cuda.synchronize()
    tol = _tol(dtype) if not int8 else 2e-2
    for want in (tdec.decode_attention_plain(*args, **kw),
                 tdec.decode_attention_split_plain(*args, n_split=n_split,
                                                   **kw)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    assert torch.all(got[1] == 0) and torch.isfinite(got).all()
    assert torch.equal(got, again)


def test_decode_kernel_splits_at_batch_one(dev):
    """The rule the wrapper applies on the card: the 7B model at B = 1
    (Hkv = 32, S = 672) gets n_split >= 2, and the result is that of the
    same call at n_split = 1 within the bf16 tolerance."""
    args, _ = _decode_case(dev, torch.bfloat16, False, 1, 32, 32, 672)
    n = tdec.decode_splits(1, 32, 672, tdec._sm_count(dev.index or 0))
    assert n >= 2
    got = tdec.flash_decode_attention(*args)
    one = tdec._launch(*args, 0, n_split=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), one.float(), atol=2e-2,
                               rtol=2e-2)


def test_decode_launch_raises_on_a_split_it_does_not_take(dev):
    args, _ = _decode_case(dev, torch.bfloat16, False, 1, 8, 8, 100)
    for n in (0, 9):
        with pytest.raises(ValueError, match="n_split"):
            tdec._launch(*args, 0, n_split=n)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernel_walks_as_the_unsplit_decode_kernel(dev, int8):
    """At n_split = 1 the paged kernel's ring walk reduces the same tiles
    with the same step as the dense kernel: on the same slots (one row's
    pages gathered into a dense cache, every slot valid) it gives the bits
    of the dense kernel at n_split = 1."""
    q, k, v, ks, vs, tables, lens = _paged_case(
        dev, torch.bfloat16, int8, 1, 32, 8, 128, 16, 14, [200])
    got = tpaged._launch(
        q, k[1], v[1], tables, lens, None if ks is None else ks[1],
        None if vs is None else vs[1], n_split=1)
    S = 201
    pages = tables[0].long()

    def dense(pool):
        return pool[1][pages].reshape(1, -1, *pool.shape[3:])[:, :S]

    kw = {} if not int8 else dict(k_scale=dense(ks), v_scale=dense(vs))
    want = tdec._launch(
        q, dense(k), dense(v), torch.ones((1, S), dtype=torch.bool,
                                          device=dev),
        torch.arange(S, device=dev)[None], torch.tensor([S - 1], device=dev),
        0, n_split=1, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# paged attention: the slots split over a cluster, fed through a ring
# ---------------------------------------------------------------------------

PAGED_SPLITS = (1, 2, 4, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_paged_kernel_at_every_split(dev, dtype, int8, Dh, G):
    """Rows of 0 tokens (seven empty splits at 8), one ending on a page
    boundary, ragged ones and one filling its table: at every n_split the
    kernel agrees with the split plain version at that split and with the
    plain version, two launches give the same bits, one count a call."""
    Hkv, page, P = 2, 16, 6
    q, k, v, ks, vs, tables, lens = _paged_case(
        dev, dtype, int8, 5, Hkv * G, Hkv, Dh, page, P,
        [0, 2 * page - 1, 37, P * page - 1, 70], seed=G)
    scales = (None, None) if ks is None else (ks[1], vs[1])
    args = (q, k[1], v[1], tables, lens, *scales)
    want = tpaged.paged_attention_plain(*args)
    tol = _tol(dtype)
    for n in PAGED_SPLITS:
        before = tpaged.paged_decode_attention.launches
        got = tpaged._launch(*args, n_split=n)
        again = tpaged._launch(*args, n_split=n)
        assert tpaged.paged_decode_attention.launches == before + 2
        split = tpaged.paged_attention_split_plain(*args, n_split=n)
        torch.cuda.synchronize()
        for ref in (split, want):
            torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                       rtol=tol)
        assert torch.equal(got, again)


@pytest.mark.parametrize("n_split", PAGED_SPLITS)
def test_paged_kernel_never_reads_past_the_row_at_every_split(dev, n_split):
    """Table entries past ceil(seq_len / page) may be anything, and pages
    the row does not use may hold NaN, at every split."""
    q, k, v, _, _, tables, lens = _paged_case(
        dev, torch.bfloat16, False, 2, 8, 8, 128, 16, 4, [17, 3])
    want = tpaged._launch(q, k[1], v[1], tables, lens, None, None,
                          n_split=n_split)
    used = {int(tables[0, 0]), int(tables[0, 1]), int(tables[1, 0])}
    k2, v2 = k[1].clone(), v[1].clone()
    for p in range(k2.shape[0]):
        if p not in used:
            k2[p] = float("nan")
            v2[p] = float("nan")
    tables2 = tables.clone()
    tables2[0, 2:] = 10 ** 6
    tables2[1, 1:] = -5
    got = tpaged._launch(q, k2, v2, tables2, lens, None, None,
                         n_split=n_split)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernel_poisons_the_row_from_its_last_split(dev, int8):
    """An out-of-pool id in the last used page, which only the last of 4
    splits reads, makes the whole row NaN in every head; the other rows
    keep their bits."""
    q, k, v, ks, vs, tables, lens = _paged_case(
        dev, torch.bfloat16, int8, 3, 8, 4, 128, 16, 4, [17, 60, 3])
    scales = (None, None) if ks is None else (ks[1], vs[1])
    want = tpaged._launch(q, k[1], v[1], tables, lens, *scales, n_split=4)
    tables[1, 3] = 10 ** 6                 # row 1 uses pages 0..3
    got = tpaged._launch(q, k[1], v[1], tables, lens, *scales, n_split=4)
    torch.cuda.synchronize()
    assert torch.isnan(got[1]).all()
    torch.testing.assert_close(got[[0, 2]], want[[0, 2]], atol=0, rtol=0)


def test_paged_launch_raises_on_a_split_it_does_not_take(dev):
    q, k, v, _, _, tables, lens = _paged_case(
        dev, torch.bfloat16, False, 1, 8, 8, 128, 16, 4, [40])
    for n in (0, 9):
        with pytest.raises(ValueError, match="n_split"):
            tpaged._launch(q, k[1], v[1], tables, lens, None, None,
                           n_split=n)


def test_paged_splits_rule_on_the_card(dev):
    """The wrapper's default on the card is the rule at the card's SM
    count, and its result is that of the same call at n_split = 1 within
    the bf16 tolerance."""
    q, k, v, _, _, tables, lens = _paged_case(
        dev, torch.bfloat16, False, 1, 32, 32, 128, 64, 25, [700])
    n = tpaged.paged_splits(1, 32, 25, 64, tdec._sm_count(dev.index or 0))
    assert n >= 2
    got = tpaged.paged_decode_attention(q, k[1], v[1], tables, lens)
    one = tpaged._launch(q, k[1], v[1], tables, lens, None, None, n_split=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), one.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("n", [16, 16 * 2049, 3 * 32 * 1024 + 16 * 5,
                               (1 << 22) + 48])
@pytest.mark.parametrize("reps", [1, 3])
def test_hbm_copy_is_a_byte_copy_at_ragged_sizes(dev, n, reps):
    """Sizes that are no multiple of a block's share, a chunk or a ring
    stage: the copy equals ``clone`` byte for byte."""
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randint(-127, 128, (n,), generator=g, device=dev,
                      dtype=torch.int8)
    y = thbm.hbm_copy(x, reps)
    torch.cuda.synchronize()
    assert torch.equal(y, thbm.hbm_copy_plain(x))


# ---------------------------------------------------------------------------
# the captured decode: CUDA graphs of generate's step and the serving rounds
# ---------------------------------------------------------------------------

# (llama dtype, quantized bits, KV cache dtype) of the small model
CAPTURE_CASES = {"f32": ("float32", 0, ""), "bf16": ("bfloat16", 0, ""),
                 "int4_kv8": ("bfloat16", 4, "int8")}


def _small_model(dev, dtype, bits, kv):
    """A 4-layer model with the 7B head dim (Dh = 128), random from a
    seed, on the card."""
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.models.convert import init_params

    base = LlavaConfig.tiny_debug()
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, hidden_size=256, num_attention_heads=2,
        num_key_value_heads=2, intermediate_size=512, dtype=dtype,
        kv_cache_dtype=kv))
    params = init_params(cfg, dev, seed=3)
    if bits:
        tq.quantize_llama_params(params, bits)
    return cfg, params


def _small_prompt():
    import numpy as np

    rng = np.random.default_rng(1)
    ids = rng.integers(100, 500, (2, 12)).astype(np.int32)
    ids[:, 4] = -200
    ids[1, :3] = 0
    px = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    return ids, px, ids != 0


def _counts():
    from matryoshka_mm_torch.utils.cuda_graph import launch_counters

    return [fn.launches for fn in launch_counters()]


@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_captured_generate_gives_the_eager_tokens_and_counts(dev, case):
    """generate replays its captured step by default: the eager loop's
    tokens, every launch counter moved by as much, one warm-up step and a
    replay for every other decode step."""
    import numpy as np

    from matryoshka_mm_torch.generate import GenerationConfig, generate
    from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

    cfg, params = _small_model(dev, *CAPTURE_CASES[case])
    ids, px, mask = _small_prompt()
    gen = GenerationConfig(max_new_tokens=11, decode_chunk=4,
                           eos_token_id=-1)
    runs = {}
    for graph in (False, True):
        before, replays = _counts(), CapturedStep.replays
        out = generate(params, cfg, ids, px, attention_mask=mask,
                       matryoshka_vis_token_scale="ver=v0_numtoks=4",
                       gen_cfg=gen, cuda_graph=graph)
        runs[graph] = (out, [a - b for a, b in zip(_counts(), before)],
                       CapturedStep.replays - replays)
    assert np.array_equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    assert runs[False][2] == 0 and runs[True][2] == 9


@pytest.mark.parametrize("spec", [
    "ver=v2_numtoks=[1,4,16]_betas=[0.5,0.3,0.2]_gamma=0.1",
    "ver=v2_numtoks=[1,4,16]_pickby=entropy"])
@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_captured_v2_generate_gives_the_eager_tokens_and_counts(dev, case,
                                                                spec):
    """The ver=v2 step over K * B rows, captured: the eager loop's tokens,
    every launch counter moved by as much, 9 replays."""
    import numpy as np

    from matryoshka_mm_torch.generate import GenerationConfig, generate
    from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

    cfg, params = _small_model(dev, *CAPTURE_CASES[case])
    ids, px, mask = _small_prompt()
    gen = GenerationConfig(max_new_tokens=11, decode_chunk=4,
                           eos_token_id=-1)
    runs = {}
    for graph in (False, True):
        before, replays = _counts(), CapturedStep.replays
        out = generate(params, cfg, ids, px, attention_mask=mask,
                       matryoshka_vis_token_scale=spec, gen_cfg=gen,
                       cuda_graph=graph)
        runs[graph] = (out, [a - b for a, b in zip(_counts(), before)],
                       CapturedStep.replays - replays)
    assert np.array_equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    assert runs[False][2] == 0 and runs[True][2] == 9


def test_generate_modes_on_the_card_give_the_cpu_tokens(dev):
    """float32: stream_generate, beam_generate, speculative_generate and
    chunked_prefill on the card (the kernels) against the CPU (the plain
    versions)."""
    import numpy as np

    from matryoshka_mm_torch.generate import (GenerationConfig,
                                              beam_generate, chunked_prefill,
                                              speculative_generate,
                                              stream_generate)
    from matryoshka_mm_torch.models.llama import embed_tokens

    cfg, card = _small_model(dev, *CAPTURE_CASES["f32"])
    cpu = _to_cpu(card)
    ids, px, _ = _small_prompt()
    ids, px = ids[:1], px[:1]
    repeat = np.concatenate([ids[0], ids[0, 5:], ids[0, 5:]])[None]
    gen = GenerationConfig(max_new_tokens=10, decode_chunk=4,
                           eos_token_id=-1)
    v0 = "ver=v0_numtoks=4"
    text = torch.as_tensor(np.random.default_rng(5).integers(100, 500,
                                                             (2, 256)))

    def modes(p):
        d = p["llama"]["norm"].device
        t = text.to(d)
        with torch.inference_mode():
            logits, _ = chunked_prefill(
                p, cfg, embed_tokens(p["llama"], t),
                torch.arange(256, device=d).expand(2, 256),
                torch.ones_like(t, dtype=torch.bool), 320, 64)
        return [list(stream_generate(p, cfg, ids, px, gen_cfg=gen,
                                     matryoshka_vis_token_scale=v0)),
                beam_generate(p, cfg, ids, px, num_beams=3, gen_cfg=gen,
                              matryoshka_vis_token_scale=v0),
                speculative_generate(p, cfg, repeat, px, gen_cfg=gen, k=4,
                                     matryoshka_vis_token_scale=v0),
                logits.argmax(-1).cpu().numpy()]

    got, want = modes(card), modes(cpu)
    assert len(got[0]) == len(want[0]) == 4
    for a, b in zip(got[0] + got[1:], want[0] + want[1:]):
        assert np.array_equal(a, b)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_decode_graph_gives_the_bits_of_decode_chunk(dev, case):
    """From two copies of one prefill: the captured step's tokens, last
    logits and cache bytes equal decode_chunk's."""
    from matryoshka_mm_torch.generate import (DecodeGraph, GenerationConfig,
                                              _prefill_dispatch,
                                              _select_token, decode_chunk)

    cfg, params = _small_model(dev, *CAPTURE_CASES[case])
    ids, px, mask = _small_prompt()
    gen = GenerationConfig(max_new_tokens=8, decode_chunk=7,
                           eos_token_id=-1)

    def prefill():
        logits, cache, lengths = _prefill_dispatch(
            params, cfg, torch.as_tensor(ids, dtype=torch.int64,
                                         device=dev),
            torch.as_tensor(px, device=dev), mask, 4, gen)
        return cache, _select_token(logits, gen, None), lengths

    with torch.inference_mode():
        cache_a, first, lengths = prefill()
        cache_b, _, _ = prefill()
        finished = torch.zeros_like(first, dtype=torch.bool)
        _, _, _, toks, logits = decode_chunk(
            params, cfg, gen, cache_a, first, lengths, finished, 7,
            return_logits=True)
        graph = DecodeGraph(params, cfg, gen, cache_b, first, lengths,
                            finished)
        got = graph.run(7)
        torch.cuda.synchronize()
    assert torch.equal(got, toks) and torch.equal(graph.logits, logits)
    for name in ("k", "v", "valid", "positions", "write_idx", "k_scale",
                 "v_scale"):
        a, b = getattr(cache_a, name), getattr(cache_b, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    assert cache_a.host_idx == cache_b.host_idx


def test_captured_sampling_is_seeded(dev):
    """Temperature / top-p sampling inside the graph draws from the
    generator registered with it: the same seed, the same tokens."""
    from matryoshka_mm_torch.generate import GenerationConfig, generate

    cfg, params = _small_model(dev, *CAPTURE_CASES["bf16"])
    ids, px, mask = _small_prompt()
    gen = GenerationConfig(max_new_tokens=10, decode_chunk=4, do_sample=True,
                           temperature=0.8, top_p=0.9, eos_token_id=-1)

    def run(seed):
        return generate(params, cfg, ids, px, attention_mask=mask,
                        matryoshka_vis_token_scale="ver=v0_numtoks=4",
                        gen_cfg=gen,
                        generator=torch.Generator(device=dev).manual_seed(
                            seed))

    a, b = run(7), run(7)
    assert (a == b).all() and a.shape == (2, 10)
    assert a.min() >= 0 and a.max() < cfg.llama.vocab_size


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_captured_round_gives_the_eager_round(dev, backend):
    """Two rounds of the plain pool decode against two calls of the
    captured round (the first warms up and captures, the second replays)
    from copies of one pool: the same tokens, state and pool bytes, and the
    same launch counts."""
    import functools

    import numpy as np

    from matryoshka_mm_torch.generate import GenerationConfig, prefill_text
    from matryoshka_mm_torch.serve.batching import dense_pool_decode
    from matryoshka_mm_torch.serve.paged_cache import (
        CapturedRound, PoolState, import_prefill_group, init_paged_cache,
        paged_pool_decode)

    cfg, params = _small_model(dev, *CAPTURE_CASES["bf16"])
    lc, chunk, B, page = cfg.llama, 4, 3, 16
    gen = GenerationConfig(max_new_tokens=16, decode_chunk=chunk,
                           eos_token_id=-1)
    g = torch.Generator(device=dev).manual_seed(2)
    ids = torch.randint(5, lc.vocab_size, (B, 32), generator=g, device=dev)
    mask = torch.ones((B, 32), dtype=torch.bool, device=dev)
    mask[1, :9] = False

    def pool():
        _, dense, _ = prefill_text(params, cfg, ids, mask, 32 + 2 * chunk)
        if backend == "dense":
            return dense, None
        paged = init_paged_cache(lc, 1 + 3 * B, page, device=dev)
        tables = np.arange(1, 1 + 3 * B, dtype=np.int32).reshape(B, 3)
        import_prefill_group(paged, dense, [0, 9, 0], tables, page)
        return paged, torch.as_tensor(tables, device=dev)

    def round_fn(p, tables):
        if backend == "dense":
            return functools.partial(dense_pool_decode, params["llama"], lc,
                                     gen, chunk, p)
        return functools.partial(paged_pool_decode, params["llama"], lc, gen,
                                 chunk, p, tables, use_kernel=True)

    lens = [32, 23, 32] if backend == "paged" else [32] * 3

    def t(x, dtype):
        return torch.tensor(x, dtype=dtype, device=dev)

    state = PoolState(t([7, 8, 0], torch.int32), t(lens, torch.int32),
                      t([16, 3, 0], torch.int32),
                      t([True, True, False], torch.bool))
    with torch.inference_mode():
        pool_a, tables_a = pool()
        pool_b, tables_b = pool()
        before = _counts()
        eager = round_fn(pool_a, tables_a)
        s1, t1 = eager(state)
        s2, t2 = eager(s1)
        eager_counts = [a - b for a, b in zip(_counts(), before)]
        before = _counts()
        captured = CapturedRound(round_fn(pool_b, tables_b), B, chunk, dev,
                                 cache=pool_b if backend == "dense" else None)
        c1, u1 = captured(state)
        c2, u2 = captured(c1)
        graph_counts = [a - b for a, b in zip(_counts(), before)]
        torch.cuda.synchronize()
    assert torch.equal(u1, t1) and torch.equal(u2, t2)
    for a, b in ((c1, s1), (c2, s2)):
        for x, y in zip(CapturedRound._fields(a), CapturedRound._fields(b)):
            assert torch.equal(x, y.to(x.dtype))
    assert graph_counts == eager_counts and any(eager_counts)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(pool_a, name), getattr(pool_b, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    if backend == "dense":
        assert pool_a.host_idx == pool_b.host_idx == 32 + 2 * chunk
        assert torch.equal(pool_a.write_idx, pool_b.write_idx)


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_captured_batcher_gives_the_eager_streams(dev, backend):
    """The batcher replays a captured round by default: the streams of
    cuda_graph=False, and exact decode-attention counts (a layer a decode
    step) either way."""
    import numpy as np

    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.ops.decode_attention import \
        flash_decode_attention
    from matryoshka_mm_torch.ops.paged_attention import \
        paged_decode_attention
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher
    from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

    cfg, params = _small_model(dev, *CAPTURE_CASES["bf16"])
    ids, px, _ = _small_prompt()
    gen = GenerationConfig(max_new_tokens=16, decode_chunk=4,
                           eos_token_id=-1)
    counter = paged_decode_attention if backend == "paged" \
        else flash_decode_attention
    kw = dict(page_size=16) if backend == "paged" else {}
    streams = {}
    for graph in (False, True):
        b = ContinuousBatcher(params, cfg, max_batch=2, prefill_len=64,
                              max_new_tokens=16, gen_cfg=gen, chunk=4,
                              backend=backend, cuda_graph=graph, **kw)
        before, replays = counter.launches, CapturedStep.replays
        try:
            b._hold_admission = True
            reqs = [b.submit(ids[i:i + 1, 3 * i:], px[i:i + 1], numtoks=4,
                             max_new_tokens=10 + i) for i in range(2)]
            b._hold_admission = False
            streams[graph] = [np.concatenate(list(b.stream(r))).tolist()
                              for r in reqs]
        finally:
            b.shutdown()
        assert counter.launches - before == \
            b.decode_steps * cfg.llama.num_hidden_layers
        assert (CapturedStep.replays > replays) == graph
    assert streams[True] == streams[False]
    assert [len(s) for s in streams[True]] == [10, 11]


def test_captured_batcher_sampling_is_seeded(dev):
    """Sampled rounds replay with the batcher's generator registered with
    the graph, which the eager prefills draw from too: two batchers (each
    seeded 0) give the same streams, in the vocabulary."""
    import numpy as np

    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher
    from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

    cfg, params = _small_model(dev, *CAPTURE_CASES["bf16"])
    ids, px, _ = _small_prompt()
    gen = GenerationConfig(max_new_tokens=16, decode_chunk=4, do_sample=True,
                           temperature=0.8, top_p=0.9, eos_token_id=-1)
    streams = []
    for _ in range(2):
        b = ContinuousBatcher(params, cfg, max_batch=2, prefill_len=64,
                              max_new_tokens=16, gen_cfg=gen, chunk=4,
                              backend="paged", page_size=16)
        replays = CapturedStep.replays
        try:
            b._hold_admission = True
            reqs = [b.submit(ids[i:i + 1, 3 * i:], px[i:i + 1], numtoks=4,
                             max_new_tokens=12) for i in range(2)]
            b._hold_admission = False
            streams.append([np.concatenate(list(b.stream(r))).tolist()
                            for r in reqs])
        finally:
            b.shutdown()
        assert CapturedStep.replays > replays
    assert streams[0] == streams[1]
    assert all(len(s) == 12 and 0 <= min(s) and max(s) < cfg.llama.vocab_size
               for s in streams[0])


# ---------------------------------------------------------------------------
# the Mistral-7B and MPT-7B shapes (GQA 4 with a 4,096-slot window; the
# quantized products' new N and K)

def test_flash_kernel_at_a_mistral_prefill_past_the_window(dev):
    """One 4,608-token prefill of Mistral-7B's attention (32 heads over 8
    KV heads, Dh 128, window 4,096) in bf16 against the plain version;
    the window changes the output of the rows past it."""
    B, H, Hkv, S, Dh, W = 1, 32, 8, 4608, 128, 4096
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, H, S, Dh), generator=g, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    out, lse = tflash.flash_attention_lse(q, k, v, causal=True,
                                          kv_valid=valid, sliding_window=W)
    want_o, want_l = tflash.flash_attention_plain(
        q, k, v, causal=True, kv_valid=valid, sliding_window=W)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want_o.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, want_l, atol=1e-3, rtol=1e-3)
    whole, _ = tflash.flash_attention_lse(q, k, v, causal=True,
                                          kv_valid=valid)
    assert torch.equal(whole[:, :, :W], out[:, :, :W])
    assert float((whole[:, :, W:] - out[:, :, W:]).abs().max()) > 1e-2


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,S", [(1, 672), (1, 4640), (4, 4640)])
def test_decode_kernel_at_group_4_past_the_window(dev, int8, B, S):
    """Mistral-7B decode: 32 heads over 8 KV heads, the window of 4,096 by
    position, rows of 672 and past 4,096 slots, at the split the rule
    picks, against the plain version and the split plain version."""
    H, Hkv, Dh, W = 32, 8, 128, 4096
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, H, Dh), generator=g, device=dev,
                    dtype=torch.bfloat16)
    kv = [torch.randn((B, S, Hkv, Dh), generator=g, device=dev,
                      dtype=torch.bfloat16) for _ in range(2)]
    kw = dict(sliding_window=W)
    if int8:
        (kq, ks), (vq, vs) = (tq._quantize_kv_slots(t) for t in kv)
        kv, kw = [kq, vq], dict(kw, k_scale=ks, v_scale=vs)
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    kv_pos = torch.arange(S, device=dev).expand(B, S)
    q_pos = torch.full((B,), S - 1, device=dev)
    args = (q, *kv, valid, kv_pos, q_pos)
    got = tdec.flash_decode_attention(*args, **kw)
    want = tdec.decode_attention_plain(*args, **kw)
    split = tdec.decode_attention_split_plain(
        *args, n_split=tdec.decode_splits(B, Hkv, S), **kw)
    torch.cuda.synchronize()
    for w in (want, split):
        torch.testing.assert_close(got.float(), w.float(), atol=2e-2,
                                   rtol=2e-2)
    if S > W:
        whole = tdec.flash_decode_attention(*args, **dict(
            kw, sliding_window=None))
        assert float((whole - got).abs().max()) > 1e-3


# Mistral-7B: fused qkv (N 6,144), gate/up (28,672), down (K 14,336);
# MPT-7B: up (N 16,384), down (K 16,384).  M = 1, 8 take the decode kernel,
# 640 and 3008 the prefill kernel
FAMILY_SHAPES = [(6144, 4096), (28672, 4096), (4096, 14336), (16384, 4096),
                 (4096, 16384)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N,K", FAMILY_SHAPES)
@pytest.mark.parametrize("M", [1, 8, 640, 3008])
def test_quant_matmul_kernel_at_the_family_shapes(dev, bits, N, K, M):
    leaf = _quant_leaf(bits, N, K, dev)
    x = torch.randn((M, K), device=dev, dtype=torch.bfloat16)
    w = leaf[tq.Q4KEY if bits == 4 else tq.QKEY]
    fn = tmm.int4_matmul if bits == 4 else tmm.int8_matmul
    plain = tmm.int4_matmul_plain if bits == 4 else tmm.int8_matmul_plain
    a, b = fn(x, w, leaf["scale"]), fn(x, w, leaf["scale"])
    want = plain(x, w, leaf["scale"])
    torch.cuda.synchronize()
    assert a.shape == (M, N) and torch.equal(a, b)
    assert _rel_err(a, want) <= 1e-2


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 8, 32])
def test_quant_mlp_kernel_at_mistral_width(dev, bits, M):
    """``quant_mlp`` at Mistral-7B's I = 14,336 (``i_orig`` read from the
    fused gate/up scales as the model does)."""
    key = tq.Q4KEY if bits == 4 else tq.QKEY
    D, I = 4096, 14336
    gate, up = _quant_leaf(bits, I, D, dev, 1), _quant_leaf(bits, I, D, dev, 2)
    gateup = {key: torch.cat([gate[key], up[key]]),
              "scale": torch.cat([gate["scale"], up["scale"]])}
    down = _quant_leaf(bits, D, I, dev, 3)
    x = torch.randn((M, D), device=dev, dtype=torch.bfloat16)
    i_orig = gateup["scale"].shape[0] // 2
    a = tmlp.quant_mlp(x, gateup, down, bits, i_orig)
    b = tmlp.quant_mlp(x, gateup, down, bits, i_orig)
    want = tmlp.quant_mlp_plain(x, gateup, down, bits, I)
    torch.cuda.synchronize()
    assert i_orig == I and torch.equal(a, b)
    assert _rel_err(a, want) < 2e-2


def _family_model(dev, arch, bits=0, kv=""):
    """A 4-layer model of ``arch`` with the 7B head dim (Dh = 128), random
    from a seed: Mistral with GQA 2 and a window of 8, MPT with alibi."""
    import dataclasses

    from matryoshka_mm_torch.config import LlamaConfig, LlavaConfig
    from matryoshka_mm_torch.models.convert import init_params

    extra = dict(num_key_value_heads=1, sliding_window=8) \
        if arch == "mistral" else {}
    cfg = dataclasses.replace(LlavaConfig.tiny_debug(), llama=LlamaConfig(
        arch=arch, vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=4, num_attention_heads=2, dtype="bfloat16",
        kv_cache_dtype=kv, **dict(dict(num_key_value_heads=2), **extra)))
    params = init_params(cfg, dev, seed=3)
    if bits:
        tq.quantize_llama_params(params, bits)
    return cfg, params


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("bits", [0, 4])
@pytest.mark.parametrize("arch", ["mistral", "mpt"])
def test_captured_family_generate_gives_the_eager_tokens(dev, arch, bits,
                                                         kv):
    """Each family's decode step captures as LLaMA's (MPT's alibi bias is
    made from device tensors only): the eager loop's tokens and launch
    counts; MPT launches no attention kernel, Mistral its decode kernel
    once a layer a step."""
    import numpy as np

    from matryoshka_mm_torch.generate import GenerationConfig, generate
    from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

    cfg, params = _family_model(dev, arch, bits, kv)
    ids, px, mask = _small_prompt()
    gen = GenerationConfig(max_new_tokens=11, decode_chunk=4,
                           eos_token_id=-1)
    runs = {}
    for graph in (False, True):
        before, replays = _counts(), CapturedStep.replays
        dec = tdec.flash_decode_attention.launches
        out = generate(params, cfg, ids, px, attention_mask=mask,
                       matryoshka_vis_token_scale="ver=v0_numtoks=4",
                       gen_cfg=gen, cuda_graph=graph)
        runs[graph] = (out, [a - b for a, b in zip(_counts(), before)],
                       CapturedStep.replays - replays,
                       tdec.flash_decode_attention.launches - dec)
    assert np.array_equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    assert runs[True][2] == 9
    assert runs[True][3] == (0 if arch == "mpt" else 4 * 10)


@pytest.mark.parametrize("arch", ["mistral", "mpt"])
def test_family_batcher_on_the_card_takes_the_gather_path(dev, arch):
    """The paged batcher of either family attends through the gather path
    (its captured rounds included) and launches no paged kernel; its
    tokens equal the dense backend's in float32."""
    import dataclasses

    import numpy as np

    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    cfg, params = _family_model(dev, arch)
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, dtype="float32"))
    params = {k: v for k, v in params.items()}
    params["llama"] = _float(params["llama"])
    ids, px, _ = _small_prompt()
    gen = GenerationConfig(max_new_tokens=12, decode_chunk=3,
                           eos_token_id=-1)
    out = {}
    for backend in ("paged", "dense"):
        paged = tpaged.paged_decode_attention.launches
        b = ContinuousBatcher(params, cfg, max_batch=2, prefill_len=64,
                              max_new_tokens=16, chunk=3, gen_cfg=gen,
                              backend=backend, page_size=16)
        try:
            if backend == "paged":
                assert b.use_kernel is False
            reqs = [b.submit(ids[i:i + 1, 3:], px[i:i + 1], numtoks=4,
                             max_new_tokens=12) for i in range(2)]
            out[backend] = [np.concatenate(list(b.stream(r))) for r in reqs]
        finally:
            b.shutdown()
        assert tpaged.paged_decode_attention.launches == paged
    for p, d in zip(out["paged"], out["dense"]):
        np.testing.assert_array_equal(p, d)


def _float(tree):
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


# ---------------------------------------------------------------------------
# multi-LoRA serving: the read-once deltas, the round with a pack
# ---------------------------------------------------------------------------

def _adapters(params, dev, r=8, seed=5):
    """Two adapters over ``params`` with seeded non-zero ``lora_b``."""
    from matryoshka_mm_torch.ops.lora import add_lora, extract_lora

    out = {}
    for i, name in enumerate(("alpha", "beta")):
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        tree = extract_lora(add_lora(params, gen, r=r, alpha=2.0 * r))
        for layer in tree["llama"]["layers"]:
            for mod in layer.values():
                for leaf in mod.values():
                    leaf["lora_b"].normal_(0.0, 0.02, generator=gen)
        out[name] = tree
    return out


@pytest.mark.parametrize("key", [("self_attn", "q_proj"),
                                 ("mlp", "gate_proj"), ("mlp", "down_proj")],
                         ids=lambda k: k[1])
def test_read_once_lora_delta_matches_the_gather_form(dev, key):
    """At the 7B widths, r = 128, two adapters and 8 rows of indices 0, 1,
    2: the read-once products against the gather form, both bf16, within
    2e-2 of max|float32 gather|; index 0 exactly 0."""
    from matryoshka_mm_torch.serve import multi_lora as tml

    D, I, r = 4096, 11008, 128
    g = torch.Generator(device=dev).manual_seed(0)

    def leaf(d_out, d_in):
        return {"lora_a": torch.randn((r, d_in), generator=g, device=dev)
                * 0.02,
                "lora_b": torch.randn((d_out, r), generator=g, device=dev)
                * 0.02,
                "lora_scale": torch.full((1, 1), 2.0, device=dev)}

    def adapter():
        shapes = {"q_proj": (D, D), "k_proj": (D, D), "v_proj": (D, D),
                  "o_proj": (D, D), "gate_proj": (I, D), "up_proj": (I, D),
                  "down_proj": (D, I)}
        layer = {"self_attn": {}, "mlp": {}}
        for mod, p in tml.PROJS:
            layer[mod][p] = leaf(*shapes[p])
        return {"llama": {"layers": [layer]}}

    pack, _ = tml.pack_adapters({"alpha": adapter(), "beta": adapter()},
                                dtype=torch.bfloat16)
    idx = torch.tensor([0, 1, 2, 1, 2, 2, 0, 1], device=dev)
    group = next(gr for gr, ks in tml.GROUPS.items() if key in ks)
    x = torch.randn((8, 1, pack.a[group].shape[-1]), generator=g, device=dev)
    mask = tml.row_mask(pack, idx, torch.bfloat16)
    got = tml.group_deltas(pack, 0, group, x.bfloat16(), mask)[
        tml.GROUPS[group].index(key)]
    a, b, s = pack.gather_form(0, key)
    gather = tml.lora_delta(x.bfloat16(), a, b, s, idx)
    want = tml.lora_delta(x, a.float(), b.float(), s.float(), idx)
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 2e-2 * scale
    assert float((gather.float() - want).abs().max()) <= 2e-2 * scale
    assert not got[idx == 0].any()


@pytest.mark.parametrize("bits", [0, 4])
def test_captured_round_with_a_pack_gives_the_eager_round(dev, bits):
    """Two rounds of paged_pool_decode with an adapter pack against two
    calls of the captured round from copies of one pool (rows of the base
    and both adapters), then a third after the rows' indices change in
    place: the same tokens, state and pool bytes, and the same launches.
    bits=4: the unfused int4 base, 7L + 1 int4_matmul launches a step and
    no quant_mlp."""
    import functools

    import numpy as np

    from matryoshka_mm_torch.generate import GenerationConfig, prefill_text
    from matryoshka_mm_torch.ops import fused_mlp
    from matryoshka_mm_torch.serve.multi_lora import pack_adapters
    from matryoshka_mm_torch.serve.paged_cache import (
        CapturedRound, PoolState, import_prefill_group, init_paged_cache,
        paged_pool_decode)

    cfg, params = _small_model(dev, *CAPTURE_CASES["bf16"])
    adapters = _adapters(params, dev)
    if bits:
        tq.quantize_llama_params(params, bits, fuse=False)
    pack, _ = pack_adapters(adapters, dtype=torch.bfloat16)
    lc, chunk, B, page = cfg.llama, 4, 3, 16
    gen = GenerationConfig(max_new_tokens=16, decode_chunk=chunk,
                           eos_token_id=-1)
    g = torch.Generator(device=dev).manual_seed(2)
    ids = torch.randint(5, lc.vocab_size, (B, 32), generator=g, device=dev)
    mask = torch.ones((B, 32), dtype=torch.bool, device=dev)
    tables = np.arange(1, 1 + 4 * B, dtype=np.int32).reshape(B, 4)

    def pool():
        _, dense, _ = prefill_text(params, cfg, ids, mask, 32)
        paged = init_paged_cache(lc, 1 + 4 * B, page, device=dev)
        import_prefill_group(paged, dense, [0, 0, 0], tables, page)
        return paged, torch.as_tensor(tables, device=dev)

    def t(x, dtype):
        return torch.tensor(x, dtype=dtype, device=dev)

    state = PoolState(t([7, 8, 9], torch.int32), t([32] * 3, torch.int32),
                      t([16] * 3, torch.int32), t([True] * 3, torch.bool))
    with torch.inference_mode():
        (pa, ta), (pb, tb) = pool(), pool()
        idx_a, idx_b = t([0, 1, 2], torch.int64), t([0, 1, 2], torch.int64)
        eager = functools.partial(paged_pool_decode, params["llama"], lc,
                                  gen, chunk, pa, ta, use_kernel=True,
                                  lora_pack=pack, lora_idx=idx_a)
        before = _counts()
        s1, t1 = eager(state)
        s2, t2 = eager(s1)
        eager_counts = [a - b for a, b in zip(_counts(), before)]
        mm_before, mlp_before = tmm.int4_matmul.launches, \
            fused_mlp.quant_mlp.launches
        idx_a.copy_(t([2, 0, 1], torch.int64))
        s3, t3 = eager(s2)
        mm_step = (tmm.int4_matmul.launches - mm_before) / chunk
        mlp_step = fused_mlp.quant_mlp.launches - mlp_before
        captured = CapturedRound(functools.partial(
            paged_pool_decode, params["llama"], lc, gen, chunk, pb, tb,
            use_kernel=True, lora_pack=pack, lora_idx=idx_b), B, chunk, dev)
        before = _counts()
        c1, u1 = captured(state)
        c2, u2 = captured(c1)
        graph_counts = [a - b for a, b in zip(_counts(), before)]
        idx_b.index_copy_(0, t([0, 1, 2], torch.int64),
                          t([2, 0, 1], torch.int64))
        c3, u3 = captured(c2)
        torch.cuda.synchronize()
    for u, tt in ((u1, t1), (u2, t2), (u3, t3)):
        assert torch.equal(u, tt)
    for a, b in ((c1, s1), (c2, s2), (c3, s3)):
        for x, y in zip(CapturedRound._fields(a), CapturedRound._fields(b)):
            assert torch.equal(x, y.to(x.dtype))
    assert graph_counts == eager_counts and any(eager_counts)
    for name in ("k", "v"):
        assert torch.equal(getattr(pa, name), getattr(pb, name)), name
    L = lc.num_hidden_layers
    assert mm_step == (7 * L + 1 if bits else 0) and mlp_step == 0


def test_lora_batcher_on_the_card_gives_the_eager_streams(dev):
    """The paged batcher with adapters over an unfused int4 base: captured
    rounds give the streams of cuda_graph=False; int4_matmul launches 7L +
    1 a decode step and a prefill, quant_mlp none, paged attention L a
    step."""
    import numpy as np

    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.ops import fused_mlp
    from matryoshka_mm_torch.ops.paged_attention import \
        paged_decode_attention
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    cfg, params = _small_model(dev, *CAPTURE_CASES["bf16"])
    adapters = _adapters(params, dev)
    tq.quantize_llama_params(params, 4, fuse=False)
    ids, px, _ = _small_prompt()
    gen = GenerationConfig(max_new_tokens=16, decode_chunk=4,
                           eos_token_id=-1)
    L = cfg.llama.num_hidden_layers
    streams = {}
    for graph in (False, True):
        b = ContinuousBatcher(params, cfg, max_batch=3, prefill_len=64,
                              max_new_tokens=16, gen_cfg=gen, chunk=4,
                              backend="paged", page_size=16,
                              adapters=adapters, cuda_graph=graph)
        counts = (tmm.int4_matmul.launches, fused_mlp.quant_mlp.launches,
                  paged_decode_attention.launches)
        try:
            reqs = [b.submit(ids[:1, :], px[:1], numtoks=4,
                             max_new_tokens=10, lora_id=n)
                    for n in (None, "alpha", "beta")]
            streams[graph] = [np.concatenate(list(b.stream(r))).tolist()
                              for r in reqs]
        finally:
            b.shutdown()
        mm, mlp, paged = (tmm.int4_matmul.launches - counts[0],
                          fused_mlp.quant_mlp.launches - counts[1],
                          paged_decode_attention.launches - counts[2])
        # three adapters: no two requests share a prefill
        assert b.admit_stats == {"solo": 3, "grouped": 0}
        assert paged == b.decode_steps * L and mlp == 0
        assert mm == (b.decode_steps + 3) * (7 * L + 1)
    assert streams[True] == streams[False]
    assert streams[True][0] != streams[True][1]


def test_antialiased_resize_in_bf16_matches_float32(dev):
    """The S2 tower's resize (``models/clip.py`` ``_resize``: bilinear,
    antialiased when it shrinks, computed in float32) on a bf16 feature
    grid and on bf16 pixels against the same in float32: within 2e-2 of
    max|float32|."""
    from matryoshka_mm_torch.models.clip import _resize

    g = torch.Generator(device=dev).manual_seed(0)
    for shape, size in (((1, 1024, 72, 72), 24), ((1, 1024, 48, 48), 24),
                        ((1, 3, 1008, 1008), 336), ((1, 3, 1008, 1008), 672),
                        ((1, 3, 336, 336), 672)):
        x = torch.randn(shape, generator=g, device=dev)
        want = _resize(x, size)
        got = _resize(x.bfloat16(), size)
        assert got.dtype == torch.bfloat16 and got.shape[-1] == size
        assert float((got.float() - want).abs().max()) <= \
            2e-2 * float(want.abs().max())


# tensor parallelism (parallel/tp_decode.py): the local shapes of a 7B rank
# at tp = 2 (fused qkv 6,144, o K 2,048, gate/up 11,008, down K 5,504 =
# 43 x 128, lm_head 16,000 rows) and tp = 4 (3,072, K 1,024, 5,504, K 2,752 =
# 43 x 64, 8,000)
TP_SHAPES = [(6144, 4096), (4096, 2048), (11008, 4096), (4096, 5504),
             (16000, 4096), (3072, 4096), (4096, 1024), (5504, 4096),
             (4096, 2752), (8000, 4096)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N,K", TP_SHAPES)
@pytest.mark.parametrize("M", [1, 8, 640])
def test_quant_matmul_kernel_at_the_tp_shard_shapes(dev, bits, N, K, M):
    leaf = _quant_leaf(bits, N, K, dev)
    x = torch.randn((M, K), device=dev, dtype=torch.bfloat16)
    w = leaf[tq.Q4KEY if bits == 4 else tq.QKEY]
    fn = tmm.int4_matmul if bits == 4 else tmm.int8_matmul
    plain = tmm.int4_matmul_plain if bits == 4 else tmm.int8_matmul_plain
    a, b = fn(x, w, leaf["scale"]), fn(x, w, leaf["scale"])
    want = plain(x, w, leaf["scale"])
    torch.cuda.synchronize()
    assert a.shape == (M, N) and torch.equal(a, b)
    assert _rel_err(a, want) <= 1e-2


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("I", [5504, 2752])
def test_quant_mlp_kernel_at_the_tp_widths(dev, bits, M, I):
    """``quant_mlp`` on a 7B rank's share of the MLP width at tp = 2 and 4
    (``i_orig`` read from the fused gate/up scales as the model does)."""
    key = tq.Q4KEY if bits == 4 else tq.QKEY
    D = 4096
    gate, up = _quant_leaf(bits, I, D, dev, 1), _quant_leaf(bits, I, D, dev, 2)
    gateup = {key: torch.cat([gate[key], up[key]]),
              "scale": torch.cat([gate["scale"], up["scale"]])}
    down = _quant_leaf(bits, D, I, dev, 3)
    x = torch.randn((M, D), device=dev, dtype=torch.bfloat16)
    i_orig = gateup["scale"].shape[0] // 2
    a = tmlp.quant_mlp(x, gateup, down, bits, i_orig)
    b = tmlp.quant_mlp(x, gateup, down, bits, i_orig)
    want = tmlp.quant_mlp_plain(x, gateup, down, bits, I)
    torch.cuda.synchronize()
    assert i_orig == I and torch.equal(a, b)
    assert _rel_err(a, want) < 2e-2


@pytest.mark.parametrize("H", [16, 8])
def test_attention_kernels_at_the_tp_head_counts(dev, H):
    """A 7B rank's heads at tp = 2 and 4: the flash forward at a scale-576
    prefill (640 queries against 672 slots, left-padded) and the decode
    kernel at 672 slots, bf16, against their plain versions; two launches
    give the same bits."""
    g = torch.Generator(device=dev).manual_seed(20)
    Dh, Sq, Sk, bf = 128, 640, 672, torch.bfloat16
    q = torch.randn((1, H, Sq, Dh), generator=g, device=dev, dtype=bf)
    k = torch.randn((1, Sk, H, Dh), generator=g, device=dev,
                    dtype=bf).transpose(1, 2)
    v = torch.randn((1, Sk, H, Dh), generator=g, device=dev,
                    dtype=bf).transpose(1, 2)
    valid = torch.zeros((1, Sk), dtype=torch.bool, device=dev)
    valid[0, 23:Sq] = True
    out, lse = tflash.flash_attention_lse(q, k, v, kv_valid=valid)
    again, _ = tflash.flash_attention_lse(q, k, v, kv_valid=valid)
    want_o, want_l = tflash.flash_attention_plain(q, k, v, kv_valid=valid)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), want_o.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, want_l, atol=1e-3, rtol=1e-3)

    qd = torch.randn((1, H, Dh), generator=g, device=dev, dtype=bf)
    kc = torch.randn((1, Sk, H, Dh), generator=g, device=dev, dtype=bf)
    vc = torch.randn((1, Sk, H, Dh), generator=g, device=dev, dtype=bf)
    pos = torch.arange(Sk, device=dev, dtype=torch.int32)[None]
    args = (qd, kc, vc, valid, pos, torch.tensor([Sq - 1], device=dev,
                                                 dtype=torch.int32))
    a = tdec.flash_decode_attention(*args)
    b = tdec.flash_decode_attention(*args)
    want = tdec.decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernel_on_a_slice_of_the_kv_heads(dev, int8):
    """Each of two ranks' kv heads of a 7B pool (16 of 32, a strided view
    of the pool's heads) through the paged kernel: at the whole call's
    split the same bits as those heads of the whole call, at its own split
    within the attention tolerance."""
    B, H, Hkv, Dh, page, P = 4, 32, 32, 128, 64, 12
    q, k, v, ks, vs, tables, lens = _paged_case(
        dev, torch.bfloat16, int8, B, H, Hkv, Dh, page, P, [0, 65, 700, 767])
    k, v = k[1], v[1]
    ks, vs = (None, None) if ks is None else (ks[1], vs[1])
    sms = tdec._sm_count(dev.index or 0)
    split = tpaged.paged_splits(B, Hkv, P, page, sms)
    whole = tpaged._launch(q, k, v, tables, lens, ks, vs, n_split=split)
    for r in range(2):
        hs = slice(r * 16, (r + 1) * 16)
        part = [q[:, hs], k[:, :, hs], v[:, :, hs]]
        sc = (None, None) if ks is None else (ks[:, :, hs], vs[:, :, hs])
        same = tpaged._launch(*part, tables, lens, *sc, n_split=split)
        own = tpaged.paged_decode_attention(*part, tables, lens, *sc)
        torch.cuda.synchronize()
        assert torch.equal(same, whole[:, hs])
        torch.testing.assert_close(own.float(), whole[:, hs].float(),
                                   atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("H", [16, 8])
@pytest.mark.parametrize("S", [1059, 1599])
def test_flash_kernels_at_the_sharded_train_shapes(dev, H, S):
    """A 7B training rank's heads (16 at tp = 2, 8 at tp = 4) over the
    train step's buckets (1,059 and 1,599 tokens), causal, bf16, a
    left-padded row: the flash forward and both backward kernels against
    their plain versions, at the tolerances of the tests above."""
    Dh, bf = 128, torch.bfloat16
    q, k, v, do, valid = _bwd_case(dev, bf, Dh, 1, H, H, S, S, pad=37,
                                   seed=21)
    out, lse = tflash.flash_attention_lse(q, k, v, kv_valid=valid)
    want_o, want_l = tflash.flash_attention_plain(q, k, v, kv_valid=valid)
    args = (q, k, v, valid, out, lse, do)
    dq = tflash.flash_attention_bwd_dq(*args, causal=True)
    dk, dv = tflash.flash_attention_bwd_dkv(*args, causal=True)
    want = tflash.flash_attention_bwd_plain(*args, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want_o.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, want_l, atol=1e-3, rtol=1e-3)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(got).all(), name
        err = (got.float() - w.float()).abs().max().item()
        assert err <= BWD_TOL[bf] * max(w.float().abs().max().item(), 1.0), \
            (name, err)


@pytest.mark.parametrize("block", ["full", "diagonal", "keyless"])
def test_flash_kernel_at_the_ring_blocks(dev, block):
    """One step of ring attention at 7B's attention widths (32 heads, Dh
    128, bf16, 4,096 queries a rank): an earlier rank's block (full), the
    rank's own (diagonal-causal), and a block whose keys are all padding,
    whose rows must carry lse = -1e30 and a zero output, so that the
    ring's merge adds nothing for them."""
    B, H, S, Dh, bf = 1, 32, 4096, 128, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(22)
    q, k, v = (torch.randn((B, H, S, Dh), generator=g, device=dev, dtype=bf)
               for _ in range(3))
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    if block == "keyless":
        valid[:] = False
    kw = dict(causal=block == "diagonal", kv_valid=valid)
    out, lse = tflash.flash_attention_lse(q, k, v, **kw)
    want_o, want_l = tflash.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want_o.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, want_l, atol=1e-3, rtol=1e-3)
    if block == "keyless":
        assert bool((lse == tflash.LSE_MASKED).all())
        assert not out.any()
