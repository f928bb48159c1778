"""PyTorch port, the plain versions of the quantized kernels against the
Pallas kernels they replace, run in interpret mode on the CPU:
``int4_matmul`` / ``int8_matmul`` (and their ``_stacked`` variants, one
layer at a time), ``quant_mlp`` against ``quant_mlp_stacked``, and the
int8-KV branch of decode attention.  Leaves padded to the TPU tiles are
bridged with ``strip_padding`` first.

Tolerances: the matrix products rel <= 1e-2 of max|ref| (bf16 output, f32
sums in another order); the MLP rel < 0.02 (its bf16 ``h`` may round the
other way); decode attention abs < 0.05 (the TPU kernel rounds q and the
scaled probabilities to bf16, the plain version keeps f32)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.models.llama import _quantize_kv_slots as jax_kv_slots
from matryoshka_mm_tpu.ops import quant as jq
from matryoshka_mm_tpu.ops.decode_attention import \
    flash_decode_attention as jax_decode
from matryoshka_mm_tpu.ops.fused_mlp import quant_mlp_stacked
from matryoshka_mm_tpu.ops.int4_matmul import (int4_matmul,
                                               int4_matmul_stacked,
                                               int8_matmul,
                                               int8_matmul_stacked)
from matryoshka_mm_torch.models.convert import strip_padding
from matryoshka_mm_torch.models.llama import proj
from matryoshka_mm_torch.ops import decode_attention as tdec
from matryoshka_mm_torch.ops import fused_mlp as tmlp
from matryoshka_mm_torch.ops import int4_matmul as tmm
from matryoshka_mm_torch.ops import quant as tq

KEYS = {4: jq.Q4KEY, 8: jq.QKEY}


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


def _port_matmul(bits, xt, leaf):
    fn = tmm.int4_matmul if bits == 4 else tmm.int8_matmul
    return fn(xt, leaf[KEYS[bits]], leaf["scale"]).float().numpy()


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 4, 20])
def test_quant_matmul_plain_matches_pallas(bits, rows):
    """Per-layer and stacked kernels on an unpadded leaf."""
    rng = np.random.default_rng(bits + rows)
    w = jnp.asarray(rng.standard_normal((3, 256, 512)), jnp.float32) * 0.05
    stack = _quant(bits)(w)
    key = KEYS[bits]
    x, xt = _x(rng, rows, 512)
    single = int4_matmul if bits == 4 else int8_matmul
    stacked = int4_matmul_stacked if bits == 4 else int8_matmul_stacked
    for i in range(3):
        layer = {key: stack[key][i], "scale": stack["scale"][i]}
        got = _port_matmul(bits, xt, _to_torch(layer))
        ref = single(x, layer[key], layer["scale"], interpret=True)
        assert _rel(got, ref) <= 1e-2
        ref_s = stacked(x, stack[key], stack["scale"], jnp.int32(i),
                        interpret=True)
        assert _rel(got, ref_s) <= 1e-2


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 4, 20])
def test_quant_matmul_plain_matches_pallas_on_a_padded_leaf(bits, rows):
    """N 2100 -> 4096 and K padded (int4: 550 -> 1024 packed columns;
    int8: 1100 -> 1536), fed to the Pallas kernel as the JAX
    ``fused_int4_proj`` feeds it; the port takes the stripped leaf."""
    rng = np.random.default_rng(10 * bits + rows)
    N, K = 2100, 1100
    w = jnp.asarray(rng.standard_normal((N, K)), jnp.float32) * 0.05
    padded = _pad(bits)(_quant(bits)(w))
    key = KEYS[bits]
    kp = padded[key].shape[-1]
    x, xt = _x(rng, rows, K)
    if bits == 4:
        z = jnp.zeros((rows, kp - K // 2), x.dtype)
        x2 = jnp.concatenate([x[:, :K // 2], z, x[:, K // 2:], z], axis=-1)
        ref = int4_matmul(x2, padded[key], padded["scale"], interpret=True)
    else:
        x2 = jnp.pad(x, ((0, 0), (0, kp - K)))
        ref = int8_matmul(x2, padded[key], padded["scale"], interpret=True)
    got = _port_matmul(bits, xt, _to_torch(padded))
    assert got.shape == (rows, N)
    assert _rel(got, ref[:, :N]) <= 1e-2


def _mlp_leaves(rng, D, I, L, bits):
    """Stacked fused gate/up and down leaves of the JAX inference layout
    (quantize, concatenate gate/up, pad)."""
    quant, pad, key = _quant(bits), _pad(bits), KEYS[bits]
    gus, dns = [], []
    for _ in range(L):
        wg, wu = (jnp.asarray(rng.standard_normal((I, D)), jnp.float32)
                  * 0.05 for _ in range(2))
        wd = jnp.asarray(rng.standard_normal((D, I)), jnp.float32) * 0.05
        gus.append(pad(jq._concat_quant([quant(wg), quant(wu)], key)))
        dns.append(pad(quant(wd)))

    def stack(ls):
        out = {k: jnp.stack([l[k] for l in ls]) for k in (key, "scale")}
        if "orig_shape" in ls[0]:
            out["orig_shape"] = ls[0]["orig_shape"]
        return out

    return stack(gus), stack(dns)


def _layer(leaf, i):
    return _to_torch({k: (v if k == "orig_shape" else v[i])
                      for k, v in leaf.items()})


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("D,I,rows", [(256, 1024, 1), (256, 1536, 4),
                                      (256, 1280, 20)])
def test_quant_mlp_plain_matches_pallas(bits, D, I, rows):
    rng = np.random.default_rng(bits * 100 + D + I)
    L = 3
    gu, dn = _mlp_leaves(rng, D, I, L, bits)
    key = KEYS[bits]
    x, xt = _x(rng, rows, D)
    for i in range(L):
        ref = quant_mlp_stacked(x, gu[key], gu["scale"], dn[key],
                                dn["scale"], jnp.int32(i), bits=bits,
                                i_orig=I, interpret=True)[:, :D]
        got = tmlp.quant_mlp(xt, _layer(gu, i), _layer(dn, i), bits, I)
        assert got.dtype == torch.bfloat16 and got.shape == (rows, D)
        assert _rel(got.float().numpy(), ref) < 0.02


@pytest.mark.parametrize("B,H,Hkv,S,n_valid,window", [
    (2, 4, 2, 64, 50, None), (2, 4, 4, 96, 90, 40), (1, 8, 2, 128, 128,
                                                     None)])
def test_int8_kv_decode_plain_matches_pallas(B, H, Hkv, S, n_valid, window):
    rng = np.random.default_rng(S + H)
    Dh = 128
    q = jnp.asarray(rng.standard_normal((B, H, Dh)), jnp.float32) * 0.3
    k = jnp.asarray(rng.standard_normal((1, B, S, Hkv, Dh)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((1, B, S, Hkv, Dh)), jnp.float32)
    kq, ks = (a[0] for a in jax_kv_slots(k))
    vq, vs = (a[0] for a in jax_kv_slots(v))
    valid = np.broadcast_to(np.arange(S)[None] < n_valid, (B, S)).copy()
    valid[-1, :3] = False
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    q_pos = np.full((B,), n_valid - 1, np.int32)
    qb = q.astype(jnp.bfloat16)
    ref = jax_decode(qb, kq, vq, jnp.asarray(valid), jnp.asarray(pos),
                     jnp.asarray(q_pos), sliding_window=window, k_scale=ks,
                     v_scale=vs, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))
    before = tdec.flash_decode_attention.launches
    got = tdec.flash_decode_attention(
        torch.tensor(np.asarray(qb.astype(jnp.float32))).bfloat16(),
        t(kq), t(vq), t(valid), t(pos), t(q_pos), sliding_window=window,
        k_scale=t(ks), v_scale=t(vs))
    assert tdec.flash_decode_attention.launches == before   # plain on CPU
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, Dh)
    err = np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max()
    assert err < 0.05


@pytest.mark.parametrize("bits", [4, 8])
def test_cpu_tensors_take_the_plain_versions(bits):
    """On the CPU the wrappers count no launch, and ``proj`` dequantizes to
    bf16 and multiplies, as the JAX package does off the TPU."""
    torch.manual_seed(0)
    w = torch.randn((64, 96)) * 0.05
    leaf = (tq.quantize_array_int4 if bits == 4 else tq.quantize_array)(w)
    x = torch.randn((2, 3, 96)).bfloat16()
    counters = (tmm.int4_matmul.launches, tmm.int8_matmul.launches,
                tmlp.quant_mlp.launches)
    got = proj(x, leaf)
    want = torch.nn.functional.linear(x, tq.dequantize_array(leaf))
    assert torch.equal(got, want)
    tmm.leaf_matmul(x[0], leaf)
    gateup = tq._concat_quant([leaf, leaf], KEYS[bits])
    down = (tq.quantize_array_int4 if bits == 4 else tq.quantize_array)(
        torch.randn((96, 64)) * 0.05)
    tmlp.quant_mlp(x[0], gateup, down, bits, 64)
    assert (tmm.int4_matmul.launches, tmm.int8_matmul.launches,
            tmlp.quant_mlp.launches) == counters
