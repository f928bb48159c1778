"""PyTorch port, anyres requests through the ``ContinuousBatcher`` on the
tiny anyres config of ``tests/test_torch_anyres.py``: the same requests go
through the JAX batcher and the port's, built with the same options over
the same (bridged) weights, and the greedy streams must be identical (both
float32 on the CPU), and equal to the port's solo ``generate``.  This
mirrors ``tests/test_batching.py``'s anyres tests on both backends."""

import numpy as np
import jax
import pytest

from matryoshka_mm_tpu.constants import IMAGE_TOKEN_INDEX
from matryoshka_mm_tpu.generate import GenerationConfig as JaxGenConfig
from matryoshka_mm_tpu.serve.batching import ContinuousBatcher as JaxBatcher
from matryoshka_mm_torch.generate import GenerationConfig, generate
from matryoshka_mm_torch.models.convert import params_from_jax
from matryoshka_mm_torch.serve.batching import ContinuousBatcher
from tests.test_torch_anyres import _cfgs, jax_init

SQUARE = (500, 500)     # 5 tiles: 16 + 8 x 9 = 88 tokens at numtoks 16
WIDE = (300, 120)       # 3 tiles
PAGED = dict(backend="paged", page_size=16)
BACKENDS = [pytest.param(dict(backend="dense"), id="dense"),
            pytest.param(PAGED, id="paged")]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jp = jax_init(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _anyres(seed, size):
    n = 5 if size == SQUARE else 3
    ids = np.array([[5 + seed, 17, IMAGE_TOKEN_INDEX, 42]], np.int32)
    px = np.random.default_rng(seed).standard_normal(
        (n, 3, 56, 56)).astype(np.float32)
    return ids, px


def _single(seed):
    ids = np.array([[5, 17, IMAGE_TOKEN_INDEX, 42, 9 + seed]], np.int32)
    return ids, np.random.default_rng(10 + seed).standard_normal(
        (1, 3, 56, 56)).astype(np.float32)


def _collect(batcher, req):
    chunks = list(batcher.stream(req))
    return np.concatenate(chunks) if chunks else np.zeros((0,), np.int32)


def _both(models, script, gen=None, **kw):
    """``script(batcher) -> streams`` on a JAX batcher and on the port's,
    both built with ``kw``; returns ``(JAX streams, port streams, the port's
    batcher after its shutdown)``."""
    jcfg, jp, tcfg, tp = models
    gen = dict(dict(max_new_tokens=6, decode_chunk=2, eos_token_id=-1),
               **(gen or {}))
    kw = dict(dict(max_batch=2, prefill_len=128, max_new_tokens=16, chunk=2),
              **kw)
    out = []
    for cls, cfg, p, g in ((JaxBatcher, jcfg, jp, JaxGenConfig(**gen)),
                           (ContinuousBatcher, tcfg, tp,
                            GenerationConfig(**gen))):
        b = cls(p, cfg, gen_cfg=g, **kw)
        try:
            out.append(script(b))
        finally:
            b.shutdown()
    return out[0], out[1], b


def _assert_same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _solo(models, ids, px, size, new=6):
    _, _, tcfg, tp = models
    return generate(tp, tcfg, ids, px[None], image_sizes=[size],
                    matryoshka_vis_token_scale="ver=v0_numtoks=16",
                    gen_cfg=GenerationConfig(max_new_tokens=new,
                                             decode_chunk=2,
                                             eos_token_id=-1))[0]


@pytest.mark.parametrize("kw", BACKENDS)
def test_anyres_streams_equal_jax_and_generate(models, kw):
    """Two anyres requests and two single tiles land in one admission: the
    tile stacks admit solo, the single tiles as a group."""
    def script(b):
        b._hold_admission = True
        reqs = [b.submit(*_anyres(s, size), numtoks=16, max_new_tokens=6,
                         image_size=size)
                for s, size in ((4, SQUARE), (5, WIDE))]
        reqs += [b.submit(*_single(s), numtoks=4, max_new_tokens=6)
                 for s in (1, 2)]
        b._hold_admission = False
        return [_collect(b, r) for r in reqs]

    want, got, b = _both(models, script, max_batch=4, **kw)
    _assert_same(want, got)
    assert b.admit_stats == {"solo": 2, "grouped": 2}
    for i, (s, size) in enumerate(((4, SQUARE), (5, WIDE))):
        np.testing.assert_array_equal(got[i],
                                      _solo(models, *_anyres(s, size), size))
    if kw["backend"] == "paged":
        assert len(b.alloc.free) == b.max_batch * b.pages_per_row


def test_spliced_len_counts_the_anyres_merge(models):
    _, _, tcfg, tp = models
    b = ContinuousBatcher(tp, tcfg, max_batch=1, prefill_len=128,
                          max_new_tokens=8, chunk=2)
    try:
        ids, px = _anyres(4, SQUARE)
        assert b.spliced_len(ids, 16, px, SQUARE) == 3 + 88
        assert b.fits(ids, 16, px, SQUARE)
        assert b.spliced_len(ids, 16) == 3 + 16        # a single tile
    finally:
        b.shutdown()


@pytest.mark.parametrize("kw", [
    pytest.param(dict(backend="dense", max_new_tokens=12), id="dense reset"),
    pytest.param(dict(PAGED, n_pages=14), id="paged requeue")])
def test_a_requeued_anyres_row_keeps_its_image_size(models, kw):
    """Dense: a 12-slot write region resets the pool inside 24-token
    requests.  Paged: two 91-token rows that cannot both grow to their
    ends in 13 pages, so one resumes from prompt + generated.  Either way
    the continuation re-splices the same anyres merge."""
    def script(b):
        b.events = []
        b._hold_admission = True
        reqs = [b.submit(*_anyres(s, SQUARE), numtoks=16, max_new_tokens=24,
                         image_size=SQUARE) for s in (4, 6)]
        b._hold_admission = False
        out = [_collect(b, r) for r in reqs]
        if kw["backend"] == "paged":
            assert any(kind == "requeue" for _, kind, _ in b.events)
        return out

    want, got, _ = _both(models, script, gen=dict(max_new_tokens=24), **kw)
    _assert_same(want, got)
    assert all(len(t) == 24 for t in got)
    np.testing.assert_array_equal(
        got[0], _solo(models, *_anyres(4, SQUARE), SQUARE, new=24))


def test_anyres_prefix_cache_hit_equals_its_miss(models):
    """A repeated anyres request hits its cached pages; its tokens equal
    the miss's and the JAX batcher's."""
    def script(b):
        # spliced: 20 text + 88 anyres + 30 text = 138; the image ends at
        # 108, inside 8 full 16-token pages
        ids = np.array([[7] * 20 + [IMAGE_TOKEN_INDEX] + [9] * 30], np.int32)
        px = _anyres(4, SQUARE)[1]
        out = []
        for hits in (0, 1):
            out.append(_collect(b, b.submit(ids, px, numtoks=16,
                                             max_new_tokens=4,
                                             image_size=SQUARE)))
            assert b.stats["prefix_hits"] == hits
        assert b.stats["prefix_pages_reused"] == 8
        return out

    want, got, _ = _both(models, script, prefill_len=192,
                         gen=dict(max_new_tokens=4), prefix_cache=True,
                         **PAGED)
    _assert_same(want, got)
    np.testing.assert_array_equal(got[0], got[1])


def test_submit_rejects_a_multi_image_stack_and_an_oversize_merge(models):
    _, _, tcfg, tp = models
    b = ContinuousBatcher(tp, tcfg, max_batch=1, prefill_len=64,
                          max_new_tokens=8, chunk=2, **PAGED)
    try:
        ids = np.array([[5, IMAGE_TOKEN_INDEX, 7, IMAGE_TOKEN_INDEX]],
                       np.int32)
        with pytest.raises(ValueError, match="multi-image"):
            b.submit(ids, np.zeros((2, 3, 56, 56), np.float32), numtoks=16)
        # 3 + 88 merged tokens outgrow 64 slots; numtoks alone would fit
        ids, px = _anyres(4, SQUARE)
        assert b.fits(ids, 16)
        with pytest.raises(ValueError, match=r"\(91 spliced tokens\)"):
            b.submit(ids, px, numtoks=16, image_size=SQUARE)
    finally:
        b.shutdown()
