"""The captured decode of the PyTorch port, on the CPU and the tiny config.

A CUDA graph cannot be captured here, so what makes a step capturable is
held instead:

* the KV cache's write slot is a device scalar, and decoding through it
  gives the JAX ``generate`` tokens (scales 1/4/16, B=1 and B=2) and the JAX
  decode after a prefix-cache import;
* the static-buffer steps that the card captures (``DecodeGraph.step``,
  ``CapturedRound.step``), run eagerly with every host-side value frozen
  at its first call, as a replay would find it, give the plain loop's
  tokens, logits and cache bytes: a Python int for a slot baked into the
  step would write every step into the first one's slot;
* ``CapturedStep``'s launch counts, over a stand-in for the CUDA graph API:
  the change recorded at the capture, times the replays, plus the warm-up's,
  equals the count of the same steps run eagerly.

Every comparison is exact: both sides run float32 on the CPU.  Card-only
cases (captured against eager, bit for bit) are in
``tests/test_torch_kernels_cuda.py``.
"""

import contextlib
import time
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGenConfig,
                                        _decode_chunk_fn,
                                        generate as jax_generate)
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.serve.prefix_cache import _suffix_prefill_fn
from matryoshka_mm_torch import _kernels
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_torch.generate import (DecodeGraph, GenerationConfig,
                                          _prefill_dispatch, _select_token,
                                          decode_chunk)
from matryoshka_mm_torch.models.convert import params_from_jax
from matryoshka_mm_torch.models.llama import KVCache, init_kv_cache
from matryoshka_mm_torch.serve.batching import dense_pool_decode
from matryoshka_mm_torch.serve.paged_cache import (CapturedRound, PoolState,
                                                   import_prefill_group,
                                                   init_paged_cache,
                                                   paged_pool_decode)
from matryoshka_mm_torch.serve.prefix_cache import suffix_prefill
from matryoshka_mm_torch.utils import cuda_graph

STEPS = 5


@pytest.fixture(scope="module")
def models():
    jcfg = JaxLlavaConfig.tiny_debug()
    jparams = init_llava_params(jax.random.PRNGKey(0), jcfg)
    tcfg = LlavaConfig.tiny_debug()
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _prompt(batch):
    rng = np.random.default_rng(batch)
    px = rng.standard_normal((batch, 3, 56, 56)).astype(np.float32)
    ids = np.array([[1, 23, 57, IMAGE_TOKEN_INDEX, 88, 91, 14],
                    [0, 0, 1, IMAGE_TOKEN_INDEX, 301, 77, 5]],
                   np.int32)[:batch]
    return ids, px, (ids != 0 if batch > 1 else None)


def _prefill(tp, tcfg, batch, numtoks, gen_cfg, kv=""):
    """The port's prefill of ``_prompt(batch)`` -> (cache, first token,
    next positions)."""
    ids, px, mask = _prompt(batch)
    cfg = tcfg.with_kv_cache_dtype(kv) if kv else tcfg
    logits, cache, lengths = _prefill_dispatch(
        tp, cfg, torch.as_tensor(ids, dtype=torch.int64),
        torch.as_tensor(px), mask, numtoks, gen_cfg)
    return cfg, cache, _select_token(logits, gen_cfg, None), lengths


def _device_slot(cache: KVCache, want: int):
    assert isinstance(cache.write_idx, torch.Tensor)
    assert cache.write_idx.shape == () and \
        cache.write_idx.dtype == torch.int32
    assert int(cache.write_idx) == cache.host_idx == want


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("numtoks", [1, 4, 16])
def test_device_write_slot_gives_the_jax_tokens(models, numtoks, batch):
    jcfg, jp, tcfg, tp = models
    ids, px, mask = _prompt(batch)
    new = STEPS + 1
    want = np.asarray(jax_generate(
        jp, jcfg, ids, px, attention_mask=mask,
        matryoshka_vis_token_scale=f"ver=v0_numtoks={numtoks}",
        gen_cfg=JaxGenConfig(max_new_tokens=new, eos_token_id=-1)))
    gen_cfg = GenerationConfig(max_new_tokens=new, decode_chunk=STEPS,
                               eos_token_id=-1)
    cfg, cache, first, lengths = _prefill(tp, tcfg, batch, numtoks, gen_cfg)
    L = cache.host_idx
    _device_slot(cache, L)
    _, _, _, toks = decode_chunk(tp, cfg, gen_cfg, cache, first, lengths,
                                 first == -1, STEPS)
    got = torch.cat([first[:, None], toks], dim=1).numpy()
    np.testing.assert_array_equal(got, want)
    _device_slot(cache, L + STEPS)


def test_device_write_slot_after_a_prefix_import_gives_the_jax_decode(
        models):
    """A suffix prefill behind prefix KV (the prefix cache's hit path) sets
    the write slot on the device and the host; the decode behind it gives
    the JAX decode's tokens."""
    jcfg, jp, tcfg, tp = models
    lc = tcfg.llama
    n_prefix, s_suf, t_suf = 32, 64, 5
    capacity = n_prefix + s_suf + STEPS
    rng = np.random.default_rng(4)
    shape = (lc.num_hidden_layers, n_prefix, lc.num_key_value_heads,
             lc.head_dim)
    k_sel, v_sel = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(2))
    ids = np.zeros((1, s_suf), np.int32)
    ids[0, :t_suf] = rng.integers(5, lc.vocab_size, t_suf)
    valid = np.arange(s_suf)[None] < t_suf
    jlogits, jcache, jlen = _suffix_prefill_fn(jcfg, n_prefix, s_suf,
                                               capacity)(
        jp, jnp.asarray(k_sel), jnp.asarray(v_sel), jnp.asarray(ids),
        jnp.asarray(valid))
    logits, cache, lengths = suffix_prefill(
        tp, tcfg, torch.from_numpy(k_sel), torch.from_numpy(v_sel),
        torch.as_tensor(ids, dtype=torch.int64), torch.from_numpy(valid),
        capacity)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    _device_slot(cache, n_prefix + s_suf)
    assert int(jcache.write_idx) == n_prefix + s_suf

    first = logits.argmax(dim=-1).to(torch.int32)
    jgen = JaxGenConfig(max_new_tokens=STEPS + 1, eos_token_id=-1)
    _, _, _, _, jtoks = _decode_chunk_fn(jcfg, jgen, STEPS)(
        jp, jcache, jnp.asarray(first.numpy()), jlen,
        jnp.zeros((1,), bool), jax.random.PRNGKey(0))
    gen_cfg = GenerationConfig(max_new_tokens=STEPS + 1, eos_token_id=-1)
    _, _, _, toks = decode_chunk(tp, tcfg, gen_cfg, cache, first, lengths,
                                 first == -1, STEPS)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    _device_slot(cache, n_prefix + s_suf + STEPS)


def _same_cache(a: KVCache, b: KVCache):
    for name in ("k", "v", "valid", "positions", "write_idx", "k_scale",
                 "v_scale"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name
    assert a.host_idx == b.host_idx


@pytest.mark.parametrize("case", ["greedy", "int8_kv", "sampled"])
def test_static_buffer_step_with_frozen_host_values_equals_decode_chunk(
        models, case):
    """``DecodeGraph.step`` run eagerly ``STEPS`` times, the cache's host
    count put back to its first value before every call (what a replay
    finds), and the buffers advanced in place only by the step itself:
    the tokens, the last logits and the cache equal ``decode_chunk``'s."""
    _, _, tcfg, tp = models
    gen_cfg = GenerationConfig(
        max_new_tokens=STEPS + 1, decode_chunk=STEPS, eos_token_id=-1,
        do_sample=case == "sampled", temperature=0.8, top_p=0.9)
    kv = "int8" if case == "int8_kv" else ""

    def generator():
        return torch.Generator().manual_seed(5) if gen_cfg.do_sample \
            else None

    cfg, cache_a, first, lengths = _prefill(tp, tcfg, 2, 4, gen_cfg, kv)
    _, cache_b, _, _ = _prefill(tp, tcfg, 2, 4, gen_cfg, kv)
    _same_cache(cache_a, cache_b)
    finished = torch.tensor([False, True])      # row 1 is padding already
    token, lens, fin, toks, logits = decode_chunk(
        tp, cfg, gen_cfg, cache_a, first, lengths, finished, STEPS,
        generator(), return_logits=True)

    graph = DecodeGraph(tp, cfg, gen_cfg, cache_b, first, lengths, finished,
                        generator())
    frozen = cache_b.host_idx
    for _ in range(STEPS):
        cache_b.host_idx = frozen
        graph.step()
    cache_b.host_idx = frozen + STEPS
    assert torch.equal(graph.toks, toks)
    assert torch.equal(graph.logits, logits)
    assert torch.equal(graph.token, token) and \
        torch.equal(graph.lengths, lens) and torch.equal(graph.finished, fin)
    assert int(graph.col) == STEPS
    assert torch.all(toks[1] == gen_cfg.pad_token_id)
    _same_cache(cache_a, cache_b)
    with pytest.raises(ValueError, match="CUDA"):
        graph.run(1)       # no capture on the CPU


def _pool_state(batch, lengths, active, tokens, budget):
    def t(x, dtype):
        return torch.tensor(x, dtype=dtype)

    return PoolState(t(tokens, torch.int32), t(lengths, torch.int32),
                     t(budget, torch.int32), t(active, torch.bool))


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_static_round_step_with_frozen_host_values_equals_the_plain_round(
        models, backend):
    """``CapturedRound.step`` twice over its static state, the dense pool's
    host count frozen as a replay finds it, against two plain rounds: the
    same tokens, state and pool bytes.  Row 2 is idle, row 1 ends on its
    budget inside the first round."""
    _, _, tcfg, tp = models
    lc, chunk, B = tcfg.llama, 3, 3
    gen_cfg = GenerationConfig(max_new_tokens=8, decode_chunk=chunk,
                               eos_token_id=-1)
    rng = np.random.default_rng(6)
    ids = torch.as_tensor(rng.integers(5, lc.vocab_size, (B, 16)))
    mask = torch.ones((B, 16), dtype=torch.bool)
    mask[1, :5] = False
    from matryoshka_mm_torch.generate import prefill_text

    def pools():
        _, dense, _ = prefill_text(tp, tcfg, ids, mask, 16 + 2 * chunk)
        if backend == "dense":
            return dense, None
        paged = init_paged_cache(lc, 1 + B * 2, 16, device="cpu")
        tables = np.arange(1, 1 + B * 2, dtype=np.int32).reshape(B, 2)
        import_prefill_group(paged, dense, [0, 5, 0], tables, 16)
        return paged, torch.from_numpy(tables)

    def round_fn(pool, tables):
        if backend == "dense":
            return lambda s: dense_pool_decode(tp["llama"], lc, gen_cfg,
                                               chunk, pool, s)
        return lambda s: paged_pool_decode(tp["llama"], lc, gen_cfg, chunk,
                                           pool, tables, s, use_kernel=False)

    lens = [16, 11, 16] if backend == "paged" else [16, 16, 16]
    state = _pool_state(B, lens, [True, True, False], [7, 8, 0], [8, 2, 0])
    pool_a, tables_a = pools()
    plain = round_fn(pool_a, tables_a)
    s1, t1 = plain(state)
    s2, t2 = plain(s1)

    pool_b, tables_b = pools()
    captured = CapturedRound(round_fn(pool_b, tables_b), B, chunk, "cpu",
                             cache=pool_b if backend == "dense" else None)
    for dst, src in zip(captured._fields(captured.state),
                        captured._fields(state)):
        dst.copy_(src)
    frozen = getattr(pool_b, "host_idx", None)
    outs = []
    for _ in range(2):
        if backend == "dense":
            pool_b.host_idx = frozen
        captured.step()
        outs.append(captured.toks.clone())
    assert torch.equal(outs[0], t1) and torch.equal(outs[1], t2)
    assert torch.all(t1[2] == -1) and torch.all(t1[1, 2:] == -1)
    for got, want in zip(captured._fields(captured.state),
                         captured._fields(s2)):
        assert torch.equal(got.to(want.dtype), want)
    if backend == "dense":
        pool_b.host_idx = frozen + 2 * chunk
        _same_cache(pool_a, pool_b)
    else:
        assert torch.equal(pool_a.k, pool_b.k)
        assert torch.equal(pool_a.v, pool_b.v)


class _FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` that records calls; a replay
    runs nothing (the launch counts are what is checked)."""

    log: list = []

    def register_generator_state(self, gen):
        self.log.append("generator")

    def capture_begin(self, capture_error_mode="global"):
        self.log.append(f"begin {capture_error_mode}")

    def capture_end(self):
        self.log.append("end")

    def replay(self):
        self.log.append("replay")


class _FakeStream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    _FakeGraph.log = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    # a device-wide synchronize while another thread records invalidates
    # that capture: none may happen here
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: _FakeGraph.log.append(
                            "device synchronize"))
    return _FakeGraph.log


@pytest.mark.parametrize("replays", [0, 1, 7])
def test_captured_step_counts_each_replay_as_the_eager_step(fake_cuda,
                                                            replays):
    from matryoshka_mm_torch.ops import (decode_attention, fused_mlp,
                                         int4_matmul, paged_attention)

    fns = (decode_attention.flash_decode_attention, fused_mlp.quant_mlp,
           int4_matmul.int4_matmul, paged_attention.paged_decode_attention)
    per_step = (32, 32, 65, 0)
    saved = [fn.launches for fn in fns]
    host = {"slots": 0}

    def step():             # what the wrappers' counters do in one step
        for fn, n in zip(fns, per_step):
            _kernels.count_launch(fn, n)
        host["slots"] += 1

    def rewind():
        host["slots"] -= 1

    try:
        for fn in fns:
            fn.launches = 0
        for _ in range(1 + replays):
            step()
        eager = [fn.launches for fn in fns]
        for fn in fns:
            fn.launches = 0
        host["slots"] = 0
        gen = torch.Generator()
        cap = cuda_graph.CapturedStep(step, "cuda", generator=gen,
                                      rewind=rewind)
        assert [fn.launches for fn in fns] == list(per_step)   # the warm-up
        assert sorted(n for _, n in cap.counts) == sorted(
            n for n in per_step if n)
        for _ in range(replays):
            cap.replay()
            host["slots"] += 1
        assert [fn.launches for fn in fns] == eager
        assert host["slots"] == 1 + replays
        assert fake_cuda == ["generator", "begin thread_local", "end"] \
            + ["replay"] * replays
    finally:
        for fn, n in zip(fns, saved):
            fn.launches = n


def test_a_capture_keeps_the_launches_of_other_threads(fake_cuda):
    """While one thread records a step, another launches kernels (the
    serving worker's batcher beside a request's own decode): the capture
    takes back its own launches only, and its replays add only those."""
    import threading

    from matryoshka_mm_torch.ops import decode_attention, paged_attention

    mine = decode_attention.flash_decode_attention
    other = paged_attention.paged_decode_attention
    saved = mine.launches, other.launches
    calls = {"n": 0}

    def batcher_round():
        _kernels.count_launch(other, 256)

    def step():
        calls["n"] += 1
        _kernels.count_launch(mine, 32)
        if calls["n"] == 2:          # another thread launches mid-capture
            t = threading.Thread(target=batcher_round)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()

    try:
        mine.launches = other.launches = 0
        cap = cuda_graph.CapturedStep(step, "cuda")
        assert cap.counts == [(mine, 32)]
        assert (mine.launches, other.launches) == (32, 256)
        cap.replay()
        assert (mine.launches, other.launches) == (64, 256)
    finally:
        mine.launches, other.launches = saved


def test_captures_of_two_threads_do_not_overlap(fake_cuda):
    """Two threads that capture at once (two sampled requests of the
    serving worker) record one after the other."""
    import threading

    def step():
        time.sleep(0.05)

    threads = [threading.Thread(target=cuda_graph.CapturedStep,
                                args=(step, "cuda")) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert fake_cuda == ["begin thread_local", "end"] * 2


def test_a_failed_capture_raises_and_ends_the_capture(fake_cuda):
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        if calls["n"] == 2:          # the warm-up passes, the capture fails
            raise RuntimeError("operation not permitted when capturing")

    with pytest.raises(RuntimeError, match="not permitted"):
        cuda_graph.CapturedStep(step, "cuda")
    assert fake_cuda == ["begin thread_local", "end"]
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_graph.CapturedStep(step, "cpu")


def test_a_graph_is_freed_with_its_owner_and_released_under_the_lock(
        fake_cuda, monkeypatch):
    """Destroying a graph while any thread records fails ("operation not
    permitted when stream is capturing", from ``CUDAGraph::reset``) and
    invalidates that capture.  A ``CapturedStep`` keeps no reference to
    the step it recorded, so the object whose method that is forms no
    cycle with it and goes, graph and all, where it is dropped rather than
    when the cycle collector next runs, in any thread; ``release``
    destroys the graph under the capture lock."""
    import gc
    import weakref

    destroyed = []

    class Graph(_FakeGraph):
        def __del__(self):
            destroyed.append(cuda_graph._CAPTURE_LOCK.locked())

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)

    class Owner:                 # as DecodeGraph and CapturedRound hold it
        def __init__(self):
            self.graph = cuda_graph.CapturedStep(self.step, "cuda")

        def step(self):
            pass

    gc.disable()
    try:
        owner = Owner()
        ref = weakref.ref(owner)
        del owner
        assert ref() is None and destroyed == [False]
        cap = Owner().graph
        cap.release()
        assert destroyed == [False, True]
        with pytest.raises(RuntimeError, match="released"):
            cap.replay()
    finally:
        gc.enable()


def test_kv_cache_takes_an_int_write_slot_and_keeps_both_counts():
    cfg = LlavaConfig.tiny_debug().llama
    cache = init_kv_cache(cfg, 2, 8, device="cpu")
    _device_slot(cache, 0)
    cache.set_write_idx(5)
    _device_slot(cache, 5)
    again = KVCache(cache.k, cache.v, cache.valid, cache.positions, 3)
    _device_slot(again, 3)
    with pytest.raises(ValueError, match="host_idx"):
        KVCache(cache.k, cache.v, cache.valid, cache.positions,
                torch.tensor(3, dtype=torch.int32))
    assert dataclasses.replace(again, host_idx=4).host_idx == 4
