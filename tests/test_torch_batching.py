"""PyTorch port, the serving slice as a whole on the tiny config: the same
requests go through the JAX ``ContinuousBatcher`` and the port's, built
with the same options over the same (bridged) weights, and the greedy token
streams must be IDENTICAL (both run f32 on the CPU; no tolerance).  Grouping
is forced with ``_hold_admission``; nothing here asserts on wall-clock time.
"""

import dataclasses
import re
import threading

import numpy as np
import jax
import pytest
import torch

from matryoshka_mm_tpu.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_tpu.generate import (GenerationConfig as JaxGenConfig,
                                        generate as jax_generate)
from matryoshka_mm_tpu.models.builder import maybe_quantize
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.serve.batching import (
    ContinuousBatcher as JaxBatcher)
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.generate import GenerationConfig, generate
from matryoshka_mm_torch.models.convert import params_from_jax
from matryoshka_mm_torch.serve.batching import (BatchError,
                                                ContinuousBatcher)

SPEC = "ver=v0_numtoks=4"


@pytest.fixture(scope="module")
def models():
    """kind -> (JAX params, the same bridged to the port)."""
    jcfg = JaxLlavaConfig.tiny_debug()
    tcfg = LlavaConfig.tiny_debug()
    jparams = init_llava_params(jax.random.PRNGKey(0), jcfg)
    jq = maybe_quantize(jax.tree.map(lambda a: a, jparams),
                        load_8bit=False, load_4bit=True)
    bridge = lambda p: params_from_jax(jax.tree.map(np.asarray, p), tcfg,
                                       device="cpu")
    return jcfg, tcfg, {"float": (jparams, bridge(jparams)),
                        "int4": (jq, bridge(jq))}


def _inputs(seed=0, extra=0):
    """One image prompt; ``extra`` more text tokens behind it."""
    rng = np.random.default_rng(seed)
    ids = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42, 9]], np.int32)
    if extra:
        ids = np.concatenate(
            [ids, (np.arange(10, 10 + extra, dtype=np.int32) + seed)[None]],
            axis=1)
    return ids, rng.standard_normal((1, 3, 56, 56)).astype(np.float32)


def _text(seed, n=8):
    return np.random.default_rng(seed).integers(5, 100, (1, n)).astype(
        np.int32)


def _collect(batcher, req):
    chunks = list(batcher.stream(req))
    return np.concatenate(chunks) if chunks else np.zeros((0,), np.int32)


def _both(models, script, *, kind="float", kv="", gen=None, window=0, **kw):
    """Run ``script(batcher) -> list of streams`` on a JAX batcher and on
    the port's, both built with ``kw``; return ``(jax streams, port
    streams, the port's batcher after its shutdown)``."""
    jcfg, tcfg, params = models
    if kv:
        jcfg = dataclasses.replace(jcfg, llama=dataclasses.replace(
            jcfg.llama, kv_cache_dtype=kv))
        tcfg = tcfg.with_kv_cache_dtype(kv)
    if window:
        jcfg = dataclasses.replace(jcfg, llama=dataclasses.replace(
            jcfg.llama, sliding_window=window))
        tcfg = dataclasses.replace(tcfg, llama=dataclasses.replace(
            tcfg.llama, sliding_window=window))
    gen = dict(dict(max_new_tokens=8, decode_chunk=2, eos_token_id=-1),
               **(gen or {}))
    kw = dict(dict(max_batch=2, prefill_len=64, max_new_tokens=16, chunk=2),
              **kw)
    out = []
    for cls, cfg, p, g in (
            (JaxBatcher, jcfg, params[kind][0], JaxGenConfig(**gen)),
            (ContinuousBatcher, tcfg, params[kind][1],
             GenerationConfig(**gen))):
        b = cls(p, cfg, gen_cfg=g, **kw)
        try:
            out.append(script(b))
            # the port frees a row's pages before it ends the row's stream
            if cls is ContinuousBatcher and kw.get("backend") == "paged" \
                    and "n_pages" not in kw and not kw.get("prefix_cache"):
                assert len(b.alloc.free) == b.max_batch * b.pages_per_row
        finally:
            b.shutdown()
    return out[0], out[1], b


def _assert_same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


PAGED = dict(backend="paged", page_size=16)
BACKENDS = [pytest.param(dict(backend="dense"), id="dense"),
            pytest.param(PAGED, id="paged")]


def _burst(n, seeds=None, held=True, max_new=8):
    def script(b):
        b._hold_admission = held
        reqs = [b.submit(*_inputs(s, extra=s % 3), numtoks=4,
                         max_new_tokens=max_new)
                for s in (seeds or range(1, n + 1))]
        b._hold_admission = False
        return [_collect(b, r) for r in reqs]
    return script


@pytest.mark.parametrize("kw", BACKENDS)
def test_single_request_equals_jax_and_generate(models, kw):
    want, got, _ = _both(models, _burst(1), **kw)
    _assert_same(want, got)
    ids, px = _inputs(1, extra=1)
    solo = generate(models[2]["float"][1], models[1], ids, px,
                    matryoshka_vis_token_scale=SPEC,
                    gen_cfg=GenerationConfig(max_new_tokens=8, decode_chunk=2,
                                             eos_token_id=-1))[0]
    np.testing.assert_array_equal(got[0], solo)


@pytest.mark.parametrize("kw", BACKENDS)
def test_burst_of_four_admits_as_one_group(models, kw):
    want, got, b = _both(models, _burst(4), max_batch=4, **kw)
    _assert_same(want, got)
    assert b.admit_stats == {"solo": 0, "grouped": 4}


@pytest.mark.parametrize("kw", BACKENDS)
def test_mixed_burst_of_images_and_text(models, kw):
    def script(b):
        b._hold_admission = True
        reqs = [b.submit(*_inputs(s), numtoks=4, max_new_tokens=6)
                for s in (1, 2)]
        reqs += [b.submit(_text(s, 6 + s), None, max_new_tokens=6)
                 for s in (3, 4)]
        b._hold_admission = False
        return [_collect(b, r) for r in reqs]

    want, got, b = _both(models, script, max_batch=4, **kw)
    _assert_same(want, got)
    assert b.admit_stats["grouped"] == 4


@pytest.mark.parametrize("kw", BACKENDS)
def test_late_joiners(models, kw):
    """Requests that join while another row is mid-decode."""
    def script(b):
        r1 = b.submit(*_inputs(1), numtoks=4, max_new_tokens=14)
        it = b.stream(r1)
        head = [next(it), next(it)]         # r1 is decoding now
        r2 = b.submit(*_inputs(2), numtoks=4, max_new_tokens=8)
        t2 = _collect(b, r2)
        r3 = b.submit(_text(3), None, max_new_tokens=5)
        return [np.concatenate(head + list(it)), t2, _collect(b, r3)]

    want, got, _ = _both(models, script, **kw)
    _assert_same(want, got)
    assert [len(t) for t in got] == [14, 8, 5]


@pytest.mark.parametrize("kw", BACKENDS)
def test_more_requests_than_slots(models, kw):
    want, got, _ = _both(models, _burst(6, held=False), **kw)
    _assert_same(want, got)
    assert all(len(t) == 8 for t in got)


def test_page_growth_across_page_boundaries(models):
    want, got, _ = _both(models, _burst(2, max_new=24), backend="paged",
                         page_size=8, max_new_tokens=40, chunk=4,
                         gen=dict(max_new_tokens=24, decode_chunk=4))
    _assert_same(want, got)
    assert all(len(t) == 24 for t in got)


def test_dense_pool_reset_continues_streams(models):
    """A 12-token write region forces resets inside a 40-token request."""
    want, got, _ = _both(models, _burst(2, max_new=40), backend="dense",
                         max_new_tokens=12, gen=dict(max_new_tokens=40))
    _assert_same(want, got)
    assert all(len(t) == 40 for t in got)


def test_page_pressure_at_admission_retries_at_the_front(models):
    """42-token prompts need 3 of the 4 allocatable pages: one row at a
    time, the others wait at the front of the line."""
    def script(b):
        b.events = []
        reqs = [b.submit(*_inputs(s, extra=34), numtoks=4, max_new_tokens=8)
                for s in range(3)]
        out = [_collect(b, r) for r in reqs]
        assert b._retry == []
        assert any(kind == "retry_pages" for _, kind, _ in b.events)
        return out

    want, got, _ = _both(models, script, max_batch=3, n_pages=5, **PAGED)
    _assert_same(want, got)
    assert all(len(t) == 8 for t in got)


@pytest.mark.parametrize("pipelined", [True, False])
def test_page_pressure_mid_decode_requeues_the_row(models, pipelined):
    """Two rows admitted into a pool that cannot hold both to their ends:
    one is freed mid-decode and resumes from prompt + generated."""
    def script(b):
        b.events = []
        b._hold_admission = True
        reqs = [b.submit(*_inputs(s), numtoks=4, max_new_tokens=30)
                for s in (1, 2)]
        b._hold_admission = False
        out = [_collect(b, r) for r in reqs]
        assert any(kind == "requeue" for _, kind, _ in b.events)
        return out

    want, got, b = _both(models, script, backend="paged", page_size=8,
                         max_new_tokens=32, n_pages=8,
                         pipeline_rounds=pipelined,
                         gen=dict(max_new_tokens=30))
    _assert_same(want, got)
    assert all(len(t) == 30 for t in got)
    assert len(b.alloc.free) == 7


def test_out_of_pages_for_good_is_a_batch_error(models):
    _, tcfg, params = models
    b = ContinuousBatcher(
        params["float"][1], tcfg, max_batch=1, prefill_len=64,
        max_new_tokens=48, chunk=2, n_pages=4, **PAGED,
        gen_cfg=GenerationConfig(max_new_tokens=48, decode_chunk=2,
                                 eos_token_id=-1))
    try:
        req = b.submit(*_inputs(0), numtoks=4, max_new_tokens=48)
        toks = []
        with pytest.raises(BatchError, match="pages"):
            for chunk in b.stream(req):
                toks.append(chunk)
        assert sum(t.size for t in toks) > 0
    finally:
        b.shutdown()


@pytest.mark.parametrize("kw", BACKENDS)
def test_cancel_mid_flight_leaves_the_other_stream_alone(models, kw):
    def script(b):
        r1 = b.submit(*_inputs(1), numtoks=4, max_new_tokens=64)
        r2 = b.submit(*_inputs(2), numtoks=4, max_new_tokens=12)
        n = 0
        for chunk in b.stream(r1):
            n += chunk.size
            if n >= 4:
                b.cancel(r1)
                break
        for _ in b.stream(r1):      # whatever is still emitted
            pass
        return [_collect(b, r2)]

    want, got, _ = _both(models, script, max_new_tokens=64,
                         gen=dict(max_new_tokens=64), **kw)
    _assert_same(want, got)
    assert len(got[0]) == 12


@pytest.mark.parametrize("kw", BACKENDS)
def test_budget_of_one_emits_one_token(models, kw):
    want, got, _ = _both(models, _burst(2, max_new=1), **kw)
    _assert_same(want, got)
    assert [len(t) for t in got] == [1, 1]


@pytest.mark.parametrize("held", [True, False])
@pytest.mark.parametrize("kw", BACKENDS)
def test_eos_as_first_token_ends_the_stream(models, kw, held):
    """EOS = the request's own first greedy token: the stream is that one
    token, and a second request next to it runs on."""
    first = int(_both(models, _burst(1, seeds=[1]), **kw)[1][0][0])

    def script(b):
        b._hold_admission = held
        r1 = b.submit(*_inputs(1, extra=1), numtoks=4, max_new_tokens=8)
        r2 = b.submit(_text(7), None, max_new_tokens=8)
        b._hold_admission = False
        return [_collect(b, r1), _collect(b, r2)]

    want, got, _ = _both(models, script, gen=dict(eos_token_id=first), **kw)
    _assert_same(want, got)
    assert got[0].tolist() == [first]


@pytest.mark.parametrize("kw", BACKENDS)
def test_int8_kv_pool(models, kw):
    want, got, _ = _both(models, _burst(3), kv="int8", **kw)
    _assert_same(want, got)


@pytest.mark.parametrize("kw", BACKENDS)
def test_load_4bit_weights(models, kw):
    want, got, _ = _both(models, _burst(3), kind="int4", **kw)
    _assert_same(want, got)


@pytest.mark.parametrize("kw", BACKENDS)
def test_sliding_window_config_equals_jax(models, kw):
    """A window shorter than the rows: prefill and decode mask the slots
    older than it in both backends (the paged one on its gather path), and
    the tokens are not those of the unwindowed model."""
    want, got, _ = _both(models, _burst(3), window=6, **kw)
    _assert_same(want, got)
    _, whole, _ = _both(models, _burst(3), **kw)
    assert any(g.tolist() != w.tolist() for g, w in zip(got, whole))


def test_sliding_window_config_refuses_the_paged_kernel(models):
    _, tcfg, params = models
    tcfg = dataclasses.replace(tcfg, llama=dataclasses.replace(
        tcfg.llama, sliding_window=6))
    with pytest.raises(ValueError, match="gather path"):
        ContinuousBatcher(params["float"][1], tcfg, max_batch=2,
                          prefill_len=64, max_new_tokens=16, use_kernel=True,
                          **PAGED)


def test_load_4bit_with_int8_pool(models):
    want, got, _ = _both(models, _burst(2), kind="int4", kv="int8", **PAGED)
    _assert_same(want, got)


@pytest.mark.parametrize("kv", ["", "int8"])
def test_prefix_cache_hits_give_the_same_tokens(models, kv):
    """The same long prompt three times: the later admissions reuse the
    cached pages and prefill only the suffix."""
    def script(b):
        ids, px = _inputs(1, extra=30)
        out = [_collect(b, b.submit(ids, px, numtoks=4, max_new_tokens=8))
               for _ in range(3)]
        assert b.stats["prefix_hits"] == 2
        assert b.stats["prefix_pages_reused"] == 8
        return out

    want, got, _ = _both(models, script, page_size=8, backend="paged",
                         prefix_cache=True, kv=kv)
    _assert_same(want, got)
    if not kv:          # an int8 hit re-reads dequantized pages
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], got[2])


def test_prefix_cache_hit_with_another_suffix_equals_generate(models):
    """A prompt that shares only its first pages with a cached one.  Held
    against ``generate`` of both packages: on this case the JAX batcher's
    own hit path leaves its ``generate``."""
    jcfg, tcfg, params = models
    gen = dict(max_new_tokens=8, decode_chunk=2, eos_token_id=-1)
    ids, px = _inputs(1, extra=30)
    ids2 = ids.copy()
    ids2[0, -3:] += 7
    b = _port_batcher(models, page_size=8, backend="paged",
                      prefix_cache=True)
    try:
        _collect(b, b.submit(ids, px, numtoks=4, max_new_tokens=8))
        got = _collect(b, b.submit(ids2, px, numtoks=4, max_new_tokens=8))
        assert b.stats["prefix_hits"] == 1
        assert b.stats["prefix_pages_reused"] == 4
    finally:
        b.shutdown()
    np.testing.assert_array_equal(got, generate(
        params["float"][1], tcfg, ids2, px, matryoshka_vis_token_scale=SPEC,
        gen_cfg=GenerationConfig(**gen))[0])
    np.testing.assert_array_equal(got, np.asarray(jax_generate(
        params["float"][0], jcfg, ids2, px, matryoshka_vis_token_scale=SPEC,
        gen_cfg=JaxGenConfig(**gen)))[0])


def test_prefix_cache_under_pressure_flushes_and_retries(models):
    def script(b):
        reqs = [b.submit(*_inputs(s, extra=34), numtoks=4, max_new_tokens=8)
                for s in range(3)]
        out = [_collect(b, r) for r in reqs]
        assert b.stats["admit_retries"] >= 1
        return out

    want, got, _ = _both(models, script, max_batch=3, n_pages=5,
                         prefix_cache=True, **PAGED)
    _assert_same(want, got)


@pytest.mark.parametrize("k", [2, 4])
def test_speculative_k_gives_the_plain_greedy_tokens(models, k):
    script = _burst(3, held=False, max_new=12)
    want, got, b = _both(models, script, speculative_k=k,
                         gen=dict(max_new_tokens=12), **PAGED)
    _assert_same(want, got)
    plain = _both(models, script, gen=dict(max_new_tokens=12), **PAGED)[1]
    _assert_same(plain, got)
    assert b.spec_stats["verify_steps"] > 0
    # the tiny model repeats itself, so some drafts must have been accepted
    assert b.spec_stats["tokens_emitted"] > b.spec_stats["verify_steps"]


def _toy_vocab(v):
    pieces = ["A", "B", "C", "D", "yes", "no", " really", "0", "1", "2",
              "3", ".", " ", "x"]
    return ["<pad>", "<s>", "</s>"] + [pieces[i % len(pieces)]
                                       for i in range(v - 3)]


@pytest.mark.parametrize("pattern", [r"(yes|no)( really)?", r"(A|B)(C|D)",
                                     r"\d{1,3}\.\d"])
def test_constraint_regex_output_full_matches(models, pattern):
    vocab = _toy_vocab(models[1].llama.vocab_size)

    def script(b):
        r1 = b.submit(*_inputs(0), numtoks=4, max_new_tokens=10,
                      constraint_regex=pattern)
        r2 = b.submit(_text(0), None, max_new_tokens=10)
        return [_collect(b, r1), _collect(b, r2)]

    gen = dict(max_new_tokens=10, eos_token_id=2, pad_token_id=0)
    want, got, _ = _both(models, script, page_size=8, backend="paged",
                         fsm_vocab=vocab, gen=gen)
    _assert_same(want, got)
    toks = got[0].tolist()
    assert toks[-1] == 2
    assert re.fullmatch(pattern, "".join(vocab[t] for t in toks[:-1]))
    # the unconstrained neighbour decodes as without any DFA tables
    base = _both(models, lambda b: [_collect(b, b.submit(
        _text(0), None, max_new_tokens=10))], page_size=8, backend="paged",
        gen=gen)[1]
    np.testing.assert_array_equal(got[1], base[0])


def _port_batcher(models, **kw):
    _, tcfg, params = models
    kw = dict(dict(max_batch=2, prefill_len=64, max_new_tokens=16, chunk=2,
                   gen_cfg=GenerationConfig(max_new_tokens=8, decode_chunk=2,
                                            eos_token_id=-1)), **kw)
    return ContinuousBatcher(params["float"][1], tcfg, **kw)


def test_pipelined_rounds_equal_serial_rounds(models):
    streams = {}
    for pipelined in (False, True):
        b = _port_batcher(models, pipeline_rounds=pipelined, **PAGED)
        try:
            r1 = b.submit(*_inputs(1), numtoks=4, max_new_tokens=10)
            r2 = b.submit(*_inputs(2), numtoks=4, max_new_tokens=6)
            t2 = _collect(b, r2)
            r3 = b.submit(*_inputs(3), numtoks=4, max_new_tokens=8)
            streams[pipelined] = [_collect(b, r1), t2, _collect(b, r3)]
            assert len(b.alloc.free) == b.max_batch * b.pages_per_row
        finally:
            b.shutdown()
    _assert_same(streams[False], streams[True])


@pytest.mark.parametrize("kw", BACKENDS)
def test_sampling_is_reproducible_and_in_vocab(models, kw):
    gen = GenerationConfig(max_new_tokens=8, decode_chunk=2, eos_token_id=-1,
                           do_sample=True, temperature=0.9, top_p=0.9)
    runs = []
    for _ in range(2):
        b = _port_batcher(models, gen_cfg=gen, **kw)
        try:
            runs.append(_collect(b, b.submit(*_inputs(1), numtoks=4,
                                             max_new_tokens=8)))
        finally:
            b.shutdown()
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].size == 8 and runs[0].min() >= 0 \
        and runs[0].max() < models[1].llama.vocab_size


@pytest.mark.parametrize("kw", BACKENDS)
def test_scheduler_death_ends_every_stream(models, kw):
    b = _port_batcher(models, **kw)

    def boom(*a, **k):
        raise RuntimeError("injected scheduler fault")

    try:
        b._hold_admission = True
        reqs = [b.submit(*_inputs(s), numtoks=4, max_new_tokens=8)
                for s in range(3)]
        b._prefill = boom
        b._hold_admission = False
        for r in reqs:
            assert list(b.stream(r)) == []      # ends, does not hang
        assert isinstance(b.error, RuntimeError)
        late = b.submit(*_inputs(9), numtoks=4, max_new_tokens=8)
        assert list(b.stream(late)) == []       # fails fast after the death
    finally:
        b.shutdown()


def test_shutdown_keeps_the_state_of_a_thread_that_does_not_end(models):
    b = _port_batcher(models, **PAGED)
    real = b._thread
    release = threading.Event()
    stuck = threading.Thread(target=release.wait, daemon=True)
    stuck.start()
    b._thread = stuck
    try:
        with pytest.raises(RuntimeError, match="did not end"):
            b.shutdown(timeout=0.05)
        assert b.params is not None and b.paged is not None
    finally:
        release.set()
        stuck.join()
        b._thread = real
        b.shutdown()
    assert b.params is None and b.paged is None


def test_warmup_runs_requests_and_returns_seconds(models):
    b = _port_batcher(models, max_batch=4, **PAGED)
    try:
        secs = b.warmup(numtoks=4, batch_sizes=(2,))
        assert secs > 0
        assert b.admit_stats == {"solo": 1, "grouped": 2}
        assert len(b.alloc.free) == b.max_batch * b.pages_per_row
    finally:
        b.shutdown()


def test_occupancy_and_event_log(models):
    b = _port_batcher(models, **PAGED)
    try:
        b.events = []
        _burst(2)(b)
        kinds = {kind for _, kind, _ in b.events}
        assert {"submit", "admit_group", "decode_round"} <= kinds
        occ = b.occupancy
        assert occ["rounds"] > 0
        assert 0 < occ["active_rows"] <= occ["rounds"] * b.max_batch
    finally:
        b.shutdown()


def test_submit_rejects_what_the_pool_cannot_take(models):
    b = _port_batcher(models, **PAGED)
    try:
        with pytest.raises(ValueError, match="prefill region"):
            b.submit(np.ones((1, 70), np.int32), None)
        with pytest.raises(ValueError, match="fsm_vocab"):
            b.submit(np.ones((1, 4), np.int32), None, constraint_regex="A+")
        ids = np.array([[5, IMAGE_TOKEN_INDEX, 7, IMAGE_TOKEN_INDEX]],
                       np.int32)
        with pytest.raises(ValueError, match="multi-image"):
            b.submit(ids, np.zeros((2, 3, 56, 56), np.float32), numtoks=4)
        # an anyres stack counts its merge (flat here: 5 tiles x 16 tokens)
        with pytest.raises(ValueError, match="prefill region"):
            b.submit(*_inputs(0)[:1], np.zeros((5, 3, 56, 56), np.float32),
                     numtoks=16, image_size=(100, 60))
        with pytest.raises(KeyError, match="LoRA"):
            b.submit(*_inputs(0), numtoks=4, lora_id="a")
    finally:
        b.shutdown()


def test_multi_lora_raises_naming_what_is_missing(models):
    """Multi-LoRA serving is ported (tests/test_torch_multi_lora.py); on the
    dense backend both packages refuse it with the same ``ValueError``,
    naming the backend it needs."""
    jcfg, tcfg, params = models
    errors = []
    for cls, cfg, p in ((JaxBatcher, jcfg, params["float"][0]),
                        (ContinuousBatcher, tcfg, params["float"][1])):
        with pytest.raises(ValueError) as err:
            cls(p, cfg, adapters={"a": {}})
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "paged backend" in errors[1]


def test_unported_options_raise(models):
    _, tcfg, params = models
    p = params["float"][1]
    with pytest.raises(ValueError, match="requires the paged backend"):
        ContinuousBatcher(p, tcfg, adapters={"a": {}})
    # every decoder family is served (tests/test_torch_families_serving.py)
    mistral = dataclasses.replace(tcfg, llama=dataclasses.replace(
        tcfg.llama, arch="mistral"))
    ContinuousBatcher(p, mistral).shutdown()
    with pytest.raises(ValueError, match="arch"):
        dataclasses.replace(tcfg.llama, arch="gpt2")
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(p, tcfg, backend="dense", speculative_k=2)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(p, tcfg, backend="dense", fsm_vocab=["a"])
    with pytest.raises(ValueError, match="backend"):
        ContinuousBatcher(p, tcfg, backend="ring")


def test_the_batcher_lives_on_the_device_of_its_params(models):
    b = _port_batcher(models, **PAGED)
    try:
        assert b.device.type == "cpu" and b.use_kernel is False
        assert b.paged.k.device.type == "cpu"
        assert b.tokens.dtype == torch.int32
    finally:
        b.shutdown()
