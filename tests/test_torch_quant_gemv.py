"""PyTorch port, the decode-narrow quantized kernel's blocking
(``csrc/quant_gemv.cuh``) on the CPU: the split rule ``gemv_parts`` as plain
ints, and the plain twins of its K split (``int4_matmul_split_plain``,
``int8_matmul_split_plain``, ``quant_mlp_split_plain``) against the Pallas
kernels they stand for, run in interpret mode (``int4_matmul`` /
``int8_matmul`` on leaves padded as the JAX ``fused_int4_proj`` pads them,
``quant_mlp_stacked``).

Tolerances, as in ``tests/test_torch_quant_kernels.py``: the matrix
products rel <= 1e-2 of max|ref| (bf16 output, f32 sums in another order);
the MLP rel < 0.02 (its bf16 ``h`` may round the other way)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.ops import quant as jq
from matryoshka_mm_tpu.ops.fused_mlp import quant_mlp_stacked
from matryoshka_mm_tpu.ops.int4_matmul import int4_matmul, int8_matmul
from matryoshka_mm_torch.models.convert import strip_padding
from matryoshka_mm_torch.ops import fused_mlp as tmlp
from matryoshka_mm_torch.ops import int4_matmul as tmm

KEYS = {4: jq.Q4KEY, 8: jq.QKEY}
PARTS = (1, 2, 4, 8)


def _quant(bits):
    return jq.quantize_array_int4 if bits == 4 else jq.quantize_array


def _pad(bits):
    return jq.pad_int4_leaf if bits == 4 else jq.pad_int8_leaf


def _to_torch(leaf):
    return {k: torch.from_numpy(np.array(v))
            for k, v in strip_padding(jax.tree.map(np.asarray, leaf)).items()}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))


def _x(rng, rows, K):
    x = jnp.asarray(rng.standard_normal((rows, K)), jnp.bfloat16)
    return x, torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()


def _pad_k(bits, leaf):
    """Packed columns padded to a multiple of 128 (the Pallas kernel's
    block width) with bytes that decode to 0."""
    key = KEYS[bits]
    q = leaf[key]
    kp = -(-q.shape[-1] // 128) * 128
    fill = jq.PAD_BYTE if bits == 4 else 0
    return {key: jnp.pad(q, ((0, 0), (0, kp - q.shape[-1])),
                         constant_values=fill), "scale": leaf["scale"]}


def _pallas_matmul(bits, x, padded, K):
    """The Pallas kernel on a padded leaf, x padded to match."""
    key = KEYS[bits]
    kp = padded[key].shape[-1]
    rows = x.shape[0]
    if bits == 4:
        z = jnp.zeros((rows, kp - K // 2), x.dtype)
        x2 = jnp.concatenate([x[:, :K // 2], z, x[:, K // 2:], z], axis=-1)
        return int4_matmul(x2, padded[key], padded["scale"], interpret=True)
    x2 = jnp.pad(x, ((0, 0), (0, kp - K)))
    return int8_matmul(x2, padded[key], padded["scale"], interpret=True)


# K = 1100: K/2 = 550 packed columns (int4), no multiple of 16 or 64;
# K = 46: one ragged chunk.  The Pallas kernel takes the leaf with its
# packed columns padded to its block width; the twin takes the leaf as is.
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N,K", [(256, 1100), (128, 46)])
@pytest.mark.parametrize("rows", [1, 8, 32])
def test_split_plain_matches_pallas(bits, N, K, rows):
    rng = np.random.default_rng(7 * bits + K + rows)
    w = jnp.asarray(rng.standard_normal((N, K)), jnp.float32) * 0.05
    exact = _quant(bits)(w)
    x, xt = _x(rng, rows, K)
    ref = np.asarray(_pallas_matmul(bits, x, _pad_k(bits, exact), K))
    leaf = _to_torch(exact)
    split = tmm.int4_matmul_split_plain if bits == 4 \
        else tmm.int8_matmul_split_plain
    for parts in PARTS:
        got = split(xt, leaf[KEYS[bits]], leaf["scale"], parts)
        assert got.dtype == torch.bfloat16 and got.shape == (rows, N)
        assert _rel(got.float().numpy(), ref) <= 1e-2
    # the rule's own split (the default)
    got = split(xt, leaf[KEYS[bits]], leaf["scale"])
    assert _rel(got.float().numpy(), ref) <= 1e-2


def _mlp_leaves(rng, D, I, bits):
    """One layer's fused gate/up and down leaves of the JAX inference
    layout (quantize, concatenate gate/up, pad), stacked as one layer."""
    quant, pad, key = _quant(bits), _pad(bits), KEYS[bits]
    wg, wu = (jnp.asarray(rng.standard_normal((I, D)), jnp.float32) * 0.05
              for _ in range(2))
    wd = jnp.asarray(rng.standard_normal((D, I)), jnp.float32) * 0.05
    gu = pad(jq._concat_quant([quant(wg), quant(wu)], key))
    dn = pad(quant(wd))

    def stack(leaf):
        out = {k: leaf[k][None] for k in (key, "scale")}
        if "orig_shape" in leaf:
            out["orig_shape"] = leaf["orig_shape"]
        return out

    return stack(gu), stack(dn)


def _layer0(leaf):
    return _to_torch({k: (v if k == "orig_shape" else v[0])
                      for k, v in leaf.items()})


# I = 1100: the down projection's K/2 = 550 is ragged
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 8, 32])
def test_mlp_split_plain_matches_pallas(bits, rows):
    rng = np.random.default_rng(bits * 10 + rows)
    D, I = 256, 1100
    gu, dn = _mlp_leaves(rng, D, I, bits)
    key = KEYS[bits]
    x, xt = _x(rng, rows, D)
    ref = np.asarray(quant_mlp_stacked(
        x, gu[key], gu["scale"], dn[key], dn["scale"], jnp.int32(0),
        bits=bits, i_orig=I, interpret=True))[:, :D]
    g, d = _layer0(gu), _layer0(dn)
    for parts in PARTS:
        got = tmlp.quant_mlp_split_plain(xt, g, d, bits, I, parts, parts)
        assert got.dtype == torch.bfloat16 and got.shape == (rows, D)
        assert _rel(got.float().numpy(), ref) < 0.02
    got = tmlp.quant_mlp_split_plain(xt, g, d, bits, I)
    assert _rel(got.float().numpy(), ref) < 0.02


# the 7B projections at 132 SMs: (N, K, glu) -> parts
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N,K,glu,want", [
    (12288, 4096, False, 4),     # qkv: 384 blocks
    (4096, 4096, False, 8),      # o: 128 blocks
    (11008, 4096, True, 2),      # gate/up: 688 blocks of 16 pairs
    (4096, 11008, False, 8),     # down
    (32000, 4096, False, 2),     # lm_head: 1000 blocks
])
def test_gemv_parts_on_the_7b_shapes(bits, N, K, glu, want):
    assert tmm.gemv_parts(N, K, bits, 132, glu=glu) == want


@pytest.mark.parametrize("N,K,bits,sms,want", [
    (10, 4096, 4, 132, 8),       # N < 16: one block, every warp a share
    (10, 2, 4, 132, 1),          # K = 2: one packed byte, one chunk
    (33, 46, 4, 132, 1),         # K/2 = 23 bytes: one chunk
    (100, 200, 8, 132, 2),       # 200 int8 bytes: two chunks
    (4096, 4096, 4, 1, 1),       # one SM: 128 blocks already exceed 16
    (1 << 20, 4096, 4, 132, 1),  # blocks alone exceed the warps an SM
])
def test_gemv_parts_on_degenerate_shapes(N, K, bits, sms, want):
    assert tmm.gemv_parts(N, K, bits, sms) == want


def test_gemv_parts_takes_plain_ints_only():
    with pytest.raises(TypeError, match="N must be an int"):
        tmm.gemv_parts(torch.tensor(4096), 4096, 4)
    with pytest.raises(TypeError, match="K must be an int"):
        tmm.gemv_parts(4096, np.int64(4096), 4)
    with pytest.raises(TypeError, match="glu"):
        tmm.gemv_parts(4096, 4096, 4, glu=torch.tensor(True))
    with pytest.raises(ValueError):
        tmm.gemv_parts(4096, 4096, 3)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,parts", [(1100, 8), (4096, 4), (46, 2),
                                     (2, 1)])
def test_split_columns_partition_k(bits, K, parts):
    """The warps' columns cover every column of K exactly once."""
    cols = torch.cat([tmm._part_columns(K, bits, parts, p)
                      for p in range(parts)])
    assert torch.equal(cols.sort().values, torch.arange(K))
