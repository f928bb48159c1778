"""PyTorch port: tensor-parallel inference over quantized weights, through
the loader and the worker, and a follower that dies.

* int4 and int8 weights quantized with ``fuse=False`` (the JAX
  ``quantize_llama_params_*``, bridged): the port's two-rank engine (gloo
  ranks on the CPU, each fusing its shard) gives the JAX ``TPEngine``'s
  greedy tokens (8-device CPU mesh) on a one-image B = 2 request (the
  text-only and B = 1 paths are held in float32 in ``test_torch_tp.py``);
* ``load_pretrained_model("debug://tiny", tp_size=2)`` attaches an engine
  that ``LlavaModel.generate`` goes through, with the single-card port's
  tokens; under ``load_8bit`` the weights stay unfused;
* the worker's ``--tp-size``: the solo stream through the engine gives the
  single-card worker's chunks; with ``--continuous-batching`` both
  packages raise ``ValueError``;
* a follower killed in mid-stream makes rank 0 raise within
  ``DEAD_FOLLOWER_S``, and every later call raise at once."""

import json
import time

import jax
import numpy as np
import pytest

from matryoshka_mm_tpu.generate import GenerationConfig as JaxGenConfig
from matryoshka_mm_tpu.parallel import tp_decode as jtp
from matryoshka_mm_tpu.serve import model_worker as jmw
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.generate import GenerationConfig
from matryoshka_mm_torch.models.builder import load_pretrained_model
from matryoshka_mm_torch.models.convert import params_from_jax
from matryoshka_mm_torch.ops.quant import is_quantized
from matryoshka_mm_torch.parallel.tp_decode import TPEngine
from matryoshka_mm_torch.serve import model_worker as tmw
from tests.test_torch_tp import KW, _jax_tree, _mesh, _prompt

# a dead peer closes its sockets, and gloo fails the next collective at
# once (7 ms on the card host); the limit leaves room for a loaded machine
DEAD_FOLLOWER_S = 10.0


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_engine_greedy_tokens_equal_jax(bits):
    jcfg, jp = _jax_tree(None, bits)    # the shard tests' weights, cached
    tcfg = LlavaConfig.tiny_debug()
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jeng = jtp.TPEngine(jp, jcfg, tp_size=2, mesh=_mesh(2))
    eng = TPEngine(tp, tcfg, 2)
    try:
        ids, px = _prompt(2, seed=3)
        spec = "ver=v0_numtoks=4"
        want = np.asarray(jeng.generate(ids, px,
                                        matryoshka_vis_token_scale=spec,
                                        gen_cfg=JaxGenConfig(**KW)))
        got = eng.generate(ids, px, matryoshka_vis_token_scale=spec,
                           gen_cfg=GenerationConfig(**KW))
        np.testing.assert_array_equal(got, want)
        # each rank fused its shard: one qkv and one gate/up leaf a layer
        (layer0,) = eng.call(_layer0_names)[1:]
        assert layer0 == (["o_proj", "qkv_proj"], ["down_proj",
                                                   "gateup_proj"])
    finally:
        eng.close()


def _layer0_names(state):
    layer = state.local["layers"][0]
    return sorted(layer["self_attn"]), sorted(layer["mlp"])


@pytest.fixture(scope="module")
def tp_worker():
    w = tmw.ModelWorker("http://c", "http://w", "t", True, "debug://tiny",
                        None, None, device="cpu", tp_size=2)
    yield w
    w.model.tp_engine.close()


@pytest.fixture(scope="module")
def solo_worker():
    """The single-card worker on the same weights, loaded once."""
    return tmw.ModelWorker("http://c", "http://w", "s", True, "debug://tiny",
                           None, None, device="cpu")


def _chunks(worker, params) -> list:
    raw = b"".join(worker.generate_stream_gate(params))
    return [json.loads(c) for c in raw.split(b"\0") if c]


def test_loader_routes_generate_through_the_engine(tp_worker, solo_worker):
    model, solo = tp_worker.model, solo_worker.model
    assert isinstance(model.tp_engine, TPEngine) and model.tp_engine.tp == 2
    assert solo.tp_engine is None
    ids, px = _prompt(1, seed=5)
    kw = dict(matryoshka_vis_token_scale="ver=v0_numtoks=4",
              max_new_tokens=5, eos_token_id=-1)
    got = model.generate(ids, px, **kw)
    np.testing.assert_array_equal(got, solo.generate(ids, px, **kw))
    # the CPU takes the plain versions on every rank: no launch
    assert all(not any(c.values()) for c in model.tp_engine.launch_counts())
    # beams stay on one card, as in the JAX package
    beams = model.generate(ids, px, num_beams=2, **kw)
    assert beams.shape[0] == 1


def test_loader_keeps_quantized_weights_unfused_under_tp(monkeypatch):
    seen = {}

    class Engine:
        def __init__(self, params, cfg, tp, **kw):
            seen.update(params=params, tp=tp, kw=kw)

    import matryoshka_mm_torch.parallel.tp_decode as ttp

    monkeypatch.setattr(ttp, "TPEngine", Engine)
    _, model, _, _ = load_pretrained_model(
        "debug://tiny", device="cpu", load_8bit=True, tp_size=2,
        tp_backend="gloo")
    assert seen["tp"] == 2 and seen["kw"] == {"devices": None,
                                              "backend": "gloo"}
    a = model.params["llama"]["layers"][0]["self_attn"]
    assert set(a) == {"q_proj", "k_proj", "v_proj", "o_proj"}
    assert all(is_quantized(v) for v in a.values())


def test_worker_streams_through_the_engine(tp_worker, solo_worker):
    params = {"prompt": "USER: what is in the picture today ASSISTANT:",
              "temperature": 0.0, "max_new_tokens": 12}
    got = _chunks(tp_worker, params)
    assert got == _chunks(solo_worker, params)
    assert [c["error_code"] for c in got] == [0] * len(got) and len(got) > 1


def test_tp_with_continuous_batching_raises_as_jax():
    for mod, kw in ((jmw, {}), (tmw, {"device": "cpu"})):
        with pytest.raises(ValueError, match="continuous-batching"):
            mod.ModelWorker("http://c", "http://w", "t", True,
                            "debug://tiny", None, None, tp_size=2,
                            continuous_batching=True, **kw)
    # the port's worker also refuses a KV dtype it would pick for one card
    with pytest.raises(ValueError, match="auto"):
        tmw.ModelWorker("http://c", "http://w", "t", True, "debug://tiny",
                        None, None, tp_size=2, kv_cache_dtype="auto",
                        device="cpu")


def test_a_killed_follower_makes_rank_0_raise(tp_worker):
    eng = tp_worker.model.tp_engine
    ids, px = _prompt(1, seed=6)
    stream = eng.stream_generate(
        ids, px, matryoshka_vis_token_scale="ver=v0_numtoks=4",
        gen_cfg=GenerationConfig(max_new_tokens=9, decode_chunk=2,
                                 eos_token_id=-1))
    next(stream)
    eng._procs[0].kill()
    eng._procs[0].join(5)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="TPEngine"):
        for _ in stream:
            pass
    assert time.monotonic() - t0 < DEAD_FOLLOWER_S
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited|broken"):
        eng.generate(ids, px, matryoshka_vis_token_scale="ver=v0_numtoks=4")
    assert time.monotonic() - t0 < 1.0
