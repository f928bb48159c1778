"""PyTorch port: tensor-parallel inference (``parallel/tp_decode.py``)
against the JAX package's ``TPEngine``, on the tiny M3-MoE config in
float32.

* ``shard_llama_tp``: every rank's leaves equal the JAX shards at tp = 2
  and 4, float32 and bf16 bit for bit, int4 and int8 by their integer
  values and scales (so the dequantized values are exact);
* one two-rank port engine (gloo ranks on the CPU) gives the JAX engine's
  greedy tokens (8-device CPU mesh) on text-only, one-image, B = 2 and
  ``gateprobargmax`` requests, the single-card port's prefill and
  teacher-forced decode logits within 1e-5 and its sampled tokens under a
  seed;
* the refusals raise the JAX exception types; calls from more threads
  than cores run one at a time, and two streams pulled from a thread pool
  take turns; ``mesh.py`` over two gloo ranks; the
  paged kernel's plain version on a slice of the kv heads against the JAX
  kernel under ``shard_map``.

The quantized engines, the loader's route, the worker and a killed
follower are in ``test_torch_tp_quant.py``."""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from matryoshka_mm_tpu.generate import GenerationConfig as JaxGenConfig
from matryoshka_mm_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.ops.quant import (quantize_llama_params_inplace,
                                         quantize_llama_params_int4)
from matryoshka_mm_tpu.parallel import tp_decode as jtp
from matryoshka_mm_torch.config import LlamaConfig, LlavaConfig
from matryoshka_mm_torch.generate import (GenerationConfig, _decode_step,
                                          generate, prefill_image)
from matryoshka_mm_torch.models.convert import init_params, params_from_jax
from matryoshka_mm_torch.ops.quant import Q4KEY, QKEY, int_weight
from matryoshka_mm_torch.parallel import tp_decode as ttp

REPO = Path(__file__).resolve().parent.parent
MOE = "t=dense_ft=cls_obj=weightedlm"
LOGIT_TOL = 1e-5      # float32: the TP sums differ in their order only
KW = dict(max_new_tokens=6, decode_chunk=5, eos_token_id=-1)


def _mesh(n=2):
    return Mesh(np.asarray(jax.devices()[:n]), axis_names=("model",))


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's tiny M3-MoE config and weights (bridged)."""
    jcfg = JaxLlavaConfig.tiny_debug(moe=MOE)
    jp = init_llava_params(jax.random.PRNGKey(0), jcfg)
    tcfg = LlavaConfig.tiny_debug(moe=MOE)
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg, device="cpu")


@pytest.fixture(scope="module")
def engines(pair):
    """One engine a side for the module; the JAX results are cached."""
    jcfg, jp, tcfg, tp = pair
    eng = ttp.TPEngine(tp, tcfg, 2)
    yield jtp.TPEngine(jp, jcfg, tp_size=2, mesh=_mesh(2)), eng
    eng.close()


def _prompt(B, image=True, seed=0, T=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 500, (B, T)).astype(np.int32)
    px = None
    if image:
        ids[:, 2] = -200
        px = rng.standard_normal((B, 3, 56, 56)).astype(np.float32)
    return ids, px


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tree(dtype=None, bits=None):
    jcfg = JaxLlavaConfig.tiny_debug()
    if dtype:
        jcfg = dataclasses.replace(jcfg, llama=dataclasses.replace(
            jcfg.llama, dtype=dtype))
    jp = init_llava_params(jax.random.PRNGKey(1), jcfg)
    if bits == 4:
        jp["llama"] = quantize_llama_params_int4(jp["llama"], min_size=1,
                                                 inplace=True, fuse=False)
    elif bits == 8:
        jp["llama"] = quantize_llama_params_inplace(jp["llama"], min_size=1,
                                                    fuse=False)
    return jcfg, jp


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _values(leaf):
    """(integer values, scale) of a quantized leaf, a float tensor as is."""
    if isinstance(leaf, dict):
        return int_weight(leaf), leaf["scale"]
    return (leaf,)


def _pick(leaf, *idx):
    """A JAX shard leaf (numpy, leading (tp, [L,]) axes) at ``idx``."""
    if isinstance(leaf, dict):
        return {k: _torch(v[idx]) for k, v in leaf.items()}
    return _torch(leaf[idx])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int4", "int8"])
def test_shards_equal_the_jax_shards(tp, kind):
    bits = {"int4": 4, "int8": 8}.get(kind)
    jcfg, jp = _jax_tree(None if bits else kind, bits)
    tcfg = dataclasses.replace(LlavaConfig.tiny_debug(), llama=LlamaConfig(
        **{f.name: getattr(jcfg.llama, f.name)
           for f in dataclasses.fields(LlamaConfig)}))
    llama = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                            device="cpu")["llama"]
    want = jax.tree.map(np.asarray, jtp.shard_llama_tp(
        jp["llama"], jcfg.llama, tp, fuse=False))
    checked = 0
    for r in range(tp):
        got = ttp.shard_llama_tp(llama, tcfg.llama, tp, r, fuse=False)
        assert set(got) == {"layers", "norm", "lm_head"}
        pairs = [(got["norm"], _pick(want["norm"], r)),
                 (got["lm_head"], _pick(want["lm_head"], r))]
        for i, layer in enumerate(got["layers"]):
            for name in ("input_layernorm", "post_attention_layernorm"):
                pairs.append((layer[name], _pick(want["layers"][name], r, i)))
            for part in ("self_attn", "mlp"):
                for name, leaf in layer[part].items():
                    pairs.append((leaf, _pick(want["layers"][part][name],
                                              r, i)))
        for a, b in pairs:
            for x, y in zip(_values(a), _values(b), strict=True):
                assert x.dtype == y.dtype and torch.equal(x, y)
                checked += 1
        # the K-shard is the whole weight's columns, value for value
        for part, name in (("self_attn", "o_proj"), ("mlp", "down_proj")):
            whole, shard = llama["layers"][0][part][name], \
                got["layers"][0][part][name]
            w = int_weight(whole) if bits else whole
            k = w.shape[1] // tp
            assert torch.equal(int_weight(shard) if bits else shard,
                               w[:, r * k:(r + 1) * k])
    k = 2 if bits else 1      # a quantized leaf: values and scales
    assert checked == tp * (1 + k + (2 + 7 * k)
                            * tcfg.llama.num_hidden_layers)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_shards_are_fused_per_rank(bits):
    from matryoshka_mm_torch.ops.quant import quantize_llama_params

    tcfg = LlavaConfig.tiny_debug()
    params = init_params(tcfg, device="cpu", seed=3)
    quantize_llama_params(params, bits, min_size=1, fuse=False)
    got = ttp.shard_llama_tp(params["llama"], tcfg.llama, 2, 1)
    a, m = got["layers"][0]["self_attn"], got["layers"][0]["mlp"]
    assert set(a) == {"qkv_proj", "o_proj"} and set(m) == {"gateup_proj",
                                                           "down_proj"}
    D, I = tcfg.llama.hidden_size, tcfg.llama.intermediate_size
    key = Q4KEY if bits == 4 else QKEY
    assert a["qkv_proj"][key].shape[0] == 3 * D // 2
    assert m["gateup_proj"]["scale"].shape == (I, 1)
    whole = params["llama"]["layers"][0]
    assert torch.equal(int_weight(a["qkv_proj"])[:D // 2],
                       int_weight(whole["self_attn"]["q_proj"])[D // 2:])
    assert torch.equal(int_weight(m["gateup_proj"])[I // 2:],
                       int_weight(whole["mlp"]["up_proj"])[I // 2:])
    fused = init_params(tcfg, device="cpu", seed=3)
    quantize_llama_params(fused, bits, min_size=1)
    with pytest.raises(ValueError, match="unfused"):
        ttp.shard_llama_tp(fused["llama"], tcfg.llama, 2, 0)


def test_local_llama_cfg_as_jax():
    for tp in (1, 2, 4):
        want = jtp.local_llama_cfg(JaxLlamaConfig.tiny_debug(), tp)
        got = ttp.local_llama_cfg(LlamaConfig.tiny_debug(), tp, axis="g")
        for f in ("num_attention_heads", "num_key_value_heads",
                  "intermediate_size", "head_dim_override", "head_dim"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.tp_axis == "g"
    for tp in (3, 8):
        with pytest.raises(ValueError, match="must divide"):
            jtp.local_llama_cfg(JaxLlamaConfig.tiny_debug(), tp)
        with pytest.raises(ValueError, match="must divide"):
            ttp.local_llama_cfg(LlamaConfig.tiny_debug(), tp)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["text_b2", "image_b1", "image_b2", "gate"])
def test_engine_greedy_tokens_equal_jax(pair, engines, case):
    jcfg, jp, tcfg, tp = pair
    jeng, eng = engines
    B = 1 if case in ("image_b1", "gate") else 2
    ids, px = _prompt(B, image=case != "text_b2", seed=B)
    mask = None
    if case == "text_b2":
        ids[1, :3] = 0
        mask = ids != 0
    spec = {"text_b2": None, "image_b1": "ver=v0_numtoks=4",
            "image_b2": "ver=v0_numtoks=16",
            "gate": "ver=v0_numtoks=gateprobargmax"}[case]
    want = np.asarray(jeng.generate(ids, px, attention_mask=mask,
                                    matryoshka_vis_token_scale=spec,
                                    gen_cfg=JaxGenConfig(**KW)))
    got = eng.generate(ids, px, attention_mask=mask,
                       matryoshka_vis_token_scale=spec,
                       gen_cfg=GenerationConfig(**KW))
    assert got.dtype == np.int32 and got.shape == (B, KW["max_new_tokens"])
    np.testing.assert_array_equal(got, want)
    solo = generate(tp, tcfg, ids, px, attention_mask=mask,
                    matryoshka_vis_token_scale=spec,
                    gen_cfg=GenerationConfig(**KW))
    np.testing.assert_array_equal(got, solo)


def test_engine_logits_sampling_and_stream(pair, engines):
    """Prefill logits and teacher-forced decode logits within LOGIT_TOL of
    one card's, sampled tokens equal one card's under the same seed, a
    stream closed early leaves the ranks ready for the next call, and
    every rank launched no kernel on the CPU."""
    _, _, tcfg, tp = pair
    eng = engines[1]
    ids, px = _prompt(2, seed=7)
    L, n = 64, 3
    want, cache, lengths = prefill_image(
        tp, tcfg, torch.as_tensor(ids, dtype=torch.int64),
        torch.as_tensor(px), None, 4, L, L + n)
    got = eng.prefill(ids, px, matryoshka_vis_token_scale="ver=v0_numtoks=4")
    assert got.shape == want.shape == (2, tcfg.llama.vocab_size)
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)
    forced = torch.randint(5, 500, (2, n), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2))
    one = [want]
    finished = torch.zeros(2, dtype=torch.bool)
    with torch.inference_mode():
        for token in forced.unbind(1):
            one.append(_decode_step(tp, tcfg, GenerationConfig(), cache,
                                    token, lengths, finished, None)[3])
            lengths = lengths + 1
    got = eng.forced_logits(ids, px, forced.numpy(),
                            matryoshka_vis_token_scale="ver=v0_numtoks=4")
    assert got.shape == (2, n + 1, tcfg.llama.vocab_size)
    torch.testing.assert_close(got, torch.stack(one, 1), rtol=0,
                               atol=LOGIT_TOL)

    sampled = GenerationConfig(do_sample=True, temperature=0.9, top_p=0.8,
                               **KW)
    spec = "ver=v0_numtoks=4"
    got = eng.generate(ids, px, matryoshka_vis_token_scale=spec,
                       gen_cfg=sampled,
                       generator=torch.Generator().manual_seed(5))
    solo = generate(tp, tcfg, ids, px, matryoshka_vis_token_scale=spec,
                    gen_cfg=sampled, generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(got, solo)

    chunked = GenerationConfig(max_new_tokens=7, decode_chunk=2,
                               eos_token_id=-1)
    outs = list(eng.stream_generate(ids, px, matryoshka_vis_token_scale=spec,
                                    gen_cfg=chunked))
    assert [o.shape[1] for o in outs] == [1, 3, 5, 7]
    stream = eng.stream_generate(ids, px, matryoshka_vis_token_scale=spec,
                                 gen_cfg=chunked)
    next(stream), next(stream)
    # a call behind a stream that is never pulled again gives up
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttp, "WAIT_S", 0.5)
        with pytest.raises(RuntimeError, match="open stream"):
            eng.prefill(ids, px)
    stream.close()
    # generate drains the same stream
    np.testing.assert_array_equal(outs[-1], eng.generate(
        ids, px, matryoshka_vis_token_scale=spec, gen_cfg=chunked))
    assert all(not any(c.values()) for c in eng.launch_counts())


@pytest.mark.parametrize("what", ["v2", "anyres", "multi_image"])
def test_refusals_raise_the_jax_types(pair, engines, what):
    jeng, eng = engines
    ids, px = _prompt(1)
    spec = "ver=v0_numtoks=4"
    if what == "v2":
        spec = "ver=v2_numtoks=[1,4]_betas=[0.5,0.5]"
    elif what == "anyres":
        px = px[:, None].repeat(3, axis=1)
    else:
        px = np.concatenate([px, px])
    errors = []
    for e in (jeng, eng):
        with pytest.raises(Exception) as info:
            e.generate(ids, px, matryoshka_vis_token_scale=spec)
        errors.append(info.type)
    assert errors[0] is errors[1] is NotImplementedError
    # no rank took part in the refused call: the next one runs
    assert eng.generate(ids, _prompt(1)[1],
                        matryoshka_vis_token_scale="ver=v0_numtoks=4",
                        gen_cfg=GenerationConfig(**KW)).shape == (1, 6)


def test_calls_from_many_threads_run_one_at_a_time(engines):
    """Threads share one engine: each call holds the ranks until it ends,
    so every thread gets the tokens of the same call made alone."""
    eng = engines[1]
    prompts = [_prompt(1, seed=s) for s in range(3)]
    gen_cfg = GenerationConfig(max_new_tokens=4, decode_chunk=2,
                               eos_token_id=-1)

    def call(i):
        ids, px = prompts[i % 3]
        return eng.generate(ids, px, gen_cfg=gen_cfg,
                            matryoshka_vis_token_scale="ver=v0_numtoks=4")

    want = [call(i) for i in range(3)]
    got = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, call(i))) for i in range((os.cpu_count() or 1) + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(got) == list(range(len(threads)))
    for i, out in got.items():
        np.testing.assert_array_equal(out, want[i % 3])


def test_interleaved_streams_from_a_thread_pool_wait_their_turn(engines):
    """The worker pulls each chunk of a stream on whichever pool thread is
    free: a second stream whose first pull lands on the thread that ran
    the first stream's waits for it, and both get their chunks made
    alone."""
    eng = engines[1]
    spec = "ver=v0_numtoks=4"
    gen_cfg = GenerationConfig(max_new_tokens=5, decode_chunk=2,
                               eos_token_id=-1)
    prompts = [_prompt(1, seed=s) for s in (11, 12)]
    want = [list(eng.stream_generate(ids, px, gen_cfg=gen_cfg,
                                     matryoshka_vis_token_scale=spec))
            for ids, px in prompts]
    a, b = (eng.stream_generate(ids, px, gen_cfg=gen_cfg,
                                matryoshka_vis_token_scale=spec)
            for ids, px in prompts)
    with ThreadPoolExecutor(2) as pool:
        got_a = [pool.submit(next, a, None).result(60)]
        # the pool hands this to its idle thread: the one that ran a
        first_b = pool.submit(next, b, None)
        while (chunk := pool.submit(next, a, None).result(60)) is not None:
            got_a.append(chunk)
        got_b = [first_b.result(60)]
        while (chunk := pool.submit(next, b, None).result(60)) is not None:
            got_b.append(chunk)
    for got, ref in ((got_a, want[0]), (got_b, want[1])):
        assert [o.shape[1] for o in got] == [1, 3, 5]
        for x, y in zip(got, ref, strict=True):
            np.testing.assert_array_equal(x, y)


def test_mpt_and_placement_refusals():
    jcfg = JaxLlavaConfig.tiny_debug()
    jcfg = dataclasses.replace(jcfg, llama=dataclasses.replace(
        jcfg.llama, arch="mpt"))
    jp = init_llava_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(NotImplementedError, match="MPT"):
        jtp.TPEngine(jp, jcfg, tp_size=2, mesh=_mesh(2))
    tcfg = dataclasses.replace(LlavaConfig.tiny_debug(),
                               llama=LlamaConfig.tiny_debug(arch="mpt"))
    params = init_params(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="MPT"):
        ttp.TPEngine(params, tcfg, 2)
    tcfg = LlavaConfig.tiny_debug()
    params = init_params(tcfg, device="cpu")
    with pytest.raises(ValueError, match="tp_size"):
        ttp.TPEngine(params, tcfg)
    with pytest.raises(ValueError, match="rank 0"):
        ttp.TPEngine(params, tcfg, 2, devices=["meta", "cpu"])
    with pytest.raises(ValueError, match="one card a rank"):
        ttp.TPEngine(params, tcfg, 2, backend="nccl")
    with pytest.raises(ValueError, match="must divide"):
        ttp.TPEngine(params, tcfg, 3)


# ---------------------------------------------------------------------------
# mesh.py over two gloo ranks
# ---------------------------------------------------------------------------

_RANK = """
import sys
sys.modules["jax"] = None
import torch
from matryoshka_mm_torch.parallel import initialize_distributed, make_mesh, put_batch
assert initialize_distributed()
import torch.distributed as dist
r = dist.get_rank()
m = make_mesh()
assert m.mesh_dim_names == ("data", "model") and tuple(m.mesh.shape) == (2, 1)
batch = {"ids": torch.arange(8).reshape(4, 2), "px": None, "n": [torch.arange(6)]}
rows = put_batch(m, batch)
assert rows["px"] is None
assert rows["ids"].tolist() == batch["ids"][2 * r:2 * r + 2].tolist()
assert rows["n"][0].tolist() == list(range(3 * r, 3 * r + 3))
m2 = make_mesh((1, 2))
assert put_batch(m2, batch)["ids"].shape == (4, 2)
try:
    make_mesh((2, 2))
except ValueError:
    pass
else:
    raise SystemExit("a 2x2 mesh over 2 ranks")
dist.destroy_process_group()
print("OK", r)
"""


def test_mesh_over_two_gloo_ranks(monkeypatch):
    from matryoshka_mm_torch.parallel import initialize_distributed

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed() is False      # one process: a no-op
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), RANK=str(r),
                   LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        env.pop("CUDA_VISIBLE_DEVICES", None)
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert sorted(o.split()[-1] for o, _ in outs) == ["0", "1"]


# ---------------------------------------------------------------------------
# the paged kernel on a slice of the kv heads
# ---------------------------------------------------------------------------

def test_paged_plain_on_a_head_slice_equals_the_sharded_jax_kernel():
    """The paged decode sharded over kv heads (the JAX kernel in interpret
    mode under shard_map) equals the port's plain version on each rank's
    heads (2e-5, the JAX test's tolerance), and those heads of the whole
    call within float32 rounding (1e-6); the card test holds the kernel
    to bit equality."""
    import jax.numpy as jnp

    from matryoshka_mm_tpu.ops.paged_attention import paged_decode_attention
    from matryoshka_mm_torch.ops.paged_attention import paged_attention_plain

    B, H, Hkv, Dh = 2, 4, 2, 128
    n_pages, page = 9, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((n_pages, page, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, Hkv, Dh)).astype(np.float32)
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    row_len = np.asarray([37, 52], np.int32)
    fn = jax.shard_map(
        paged_decode_attention, mesh=_mesh(2),
        in_specs=(P(None, "model", None), P(None, None, "model", None),
                  P(None, None, "model", None), P(None, None), P(None)),
        out_specs=P(None, "model", None), check_vma=False)
    want = np.asarray(fn(*map(jnp.asarray, (q, k, v, tables, row_len))))
    t = [torch.as_tensor(a) for a in (q, k, v, tables, row_len)]
    whole = paged_attention_plain(*t)
    hq, hk = H // 2, Hkv // 2
    for r in range(2):
        got = paged_attention_plain(
            t[0][:, r * hq:(r + 1) * hq].contiguous(),
            t[1][:, :, r * hk:(r + 1) * hk].contiguous(),
            t[2][:, :, r * hk:(r + 1) * hk].contiguous(), t[3], t[4])
        np.testing.assert_allclose(got.numpy(),
                                   want[:, r * hq:(r + 1) * hq],
                                   rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(got, whole[:, r * hq:(r + 1) * hq],
                                   rtol=0, atol=1e-6)
