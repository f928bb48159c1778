"""PyTorch port: the paged KV cache against the JAX package on the tiny
config.  Allocators: the same tables and free lists over a scripted
sequence.  Imports: the pools' bytes at every page a row owns are EQUAL to
JAX's (bf16 -> bf16, int8 -> int8, bf16 -> int8).  One decode step from the
same pool state (carried across with ``paged_cache_from_jax``): logits
within ``atol=2e-3`` of JAX's in float32, and the single-token branch (the
kernel's plain version on the CPU) equals the gather branch within
``2e-4``."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from matryoshka_mm_tpu.models import llama as jl
from matryoshka_mm_tpu.models.llava import (LlavaConfig as JaxLlavaConfig,
                                            init_llava_params)
from matryoshka_mm_tpu.serve import paged_cache as jpc
from matryoshka_mm_tpu.serve import prefix_cache as jpx
from matryoshka_mm_torch.config import LlavaConfig
from matryoshka_mm_torch.generate import GenerationConfig
from matryoshka_mm_torch.models import llama as tl
from matryoshka_mm_torch.models.convert import (page_allocator_from_jax,
                                                paged_cache_from_jax,
                                                params_from_jax)
from matryoshka_mm_torch.serve import paged_cache as tpc
from matryoshka_mm_torch.serve import prefix_cache as tpx

PAGE = 8


@pytest.fixture(scope="module")
def models():
    jcfg = JaxLlavaConfig.tiny_debug()
    jparams = init_llava_params(jax.random.PRNGKey(0), jcfg)
    tcfg = LlavaConfig.tiny_debug()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg.llama, jparams["llama"], tcfg.llama, tparams["llama"]


def _same_allocators(a, b):
    np.testing.assert_array_equal(a.tables, b.tables)
    np.testing.assert_array_equal(a.n_alloc, b.n_alloc)
    assert [int(p) for p in a.free] == [int(p) for p in b.free]


def test_page_allocator_equals_jax_over_a_script():
    kw = dict(n_pages=12, page_size=8, max_rows=3, max_pages_per_row=4)
    ja, ta = jpc.PageAllocator(**kw), tpc.PageAllocator(**kw)
    assert 0 not in ta.free and ta.n_allocatable == 11
    script = [("allocate_row", 0, 17, 0), ("allocate_row", 1, 9, 3),
              ("extend_row", 0), ("extend_row", 0), ("allocate_row", 2, 30),
              ("free_row", 1), ("allocate_row", 2, 30), ("extend_row", 2),
              ("allocate_row", 1, 33), ("free_row", 0), ("extend_row", 1),
              ("allocate_row", 0, 1), ("capacity", 0), ("capacity", 2),
              ("free_row", 2), ("free_row", 0), ("free_row", 1)]
    for op, *args in script:
        assert getattr(ja, op)(*args) == getattr(ta, op)(*args), (op, args)
        _same_allocators(ja, ta)
    assert sorted(ta.free) == list(range(1, 12))


def test_refcount_allocator_equals_jax_over_a_script():
    kw = dict(n_pages=10, page_size=4, max_rows=3, max_pages_per_row=4)
    ja, ta = jpx.RefcountAllocator(**kw), tpx.RefcountAllocator(**kw)
    for a in (ja, ta):
        assert a.allocate_row(0, 10)
        a.pin(a.tables[0, :2].tolist())
    _same_allocators(ja, ta)
    shared = ta.tables[0, :2].tolist()
    for a in (ja, ta):
        assert a.allocate_row(1, 12, headroom=2, shared=shared)
        a.free_row(0)
        assert a.extend_row(1) is False     # row 1 holds 4 pages already
        a.free_row(1)
    _same_allocators(ja, ta)
    assert ja.cached == ta.cached == set(shared)
    np.testing.assert_array_equal(ja.ref, ta.ref)
    for a in (ja, ta):
        assert not a.allocate_row(2, 17, shared=())   # 5 pages > 4 a row
        assert a.allocate_row(2, 9, shared=shared[:1])
    _same_allocators(ja, ta)
    assert ja.flush_cached() == ta.flush_cached()
    _same_allocators(ja, ta)
    assert ja.pinned == ta.pinned


def test_refcount_allocator_takes_a_stale_shared_page_off_the_free_list():
    a = tpx.RefcountAllocator(n_pages=8, page_size=4, max_rows=2,
                              max_pages_per_row=4)
    assert a.allocate_row(0, 8)
    shared = [int(a.tables[0, 0])]
    a.pin(shared)
    a.free_row(0)
    assert shared[0] in a.flush_cached() and shared[0] in a.free
    assert a.allocate_row(1, 8, shared=shared)
    assert shared[0] not in a.free and a.ref[shared[0]] == 1
    assert a.allocate_row(0, 8)
    assert shared[0] not in a.tables[0, :2].tolist()


def test_prefix_index_and_hashes_equal_jax():
    ids = np.array([[5, 17, -200, 42, 9, 3, 3, 8, 1, 2, 4]], np.int32)
    for numtoks, h in ((None, None), (4, 1234567), (16, 99)):
        jk, jr = jpx.build_key_seq(ids, numtoks, h, -200)
        tk, tr = tpx.build_key_seq(ids, numtoks, h, -200)
        np.testing.assert_array_equal(jk, tk)
        assert jr == tr
        for salt in ("", "adapter"):
            assert jpx.chain_hashes(jk, 4, salt) == tpx.chain_hashes(
                tk, 4, salt)
    hashes = tpx.chain_hashes(tk, 4)
    ji, ti = jpx.PrefixIndex(), tpx.PrefixIndex()
    for idx in (ji, ti):
        idx.register(hashes[:3], [7, 3, 5])
        assert idx.lookup(hashes) == [7, 3, 5]
        idx.drop_pages([3])
        assert idx.lookup(hashes) == [7]
        assert idx.lookup(hashes[1:]) == []


def _dense_pair(cfg, G, S, dtype, seed):
    """The same random dense prefill cache for both packages; ``dtype`` is
    "bf16" or "int8" (quantized by the JAX package's own rule)."""
    rng = np.random.default_rng(seed)
    L, n_kv, Dh = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                   cfg.head_dim)
    k = rng.standard_normal((L, G, S, n_kv, Dh)).astype(np.float32)
    v = rng.standard_normal((L, G, S, n_kv, Dh)).astype(np.float32)
    jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (k, v))
    ks = vs = None
    if dtype == "int8":
        jk, ks = jl._quantize_kv_slots(jk)
        jv, vs = jl._quantize_kv_slots(jv)
        ks, vs = ks.reshape(L, G, S * n_kv), vs.reshape(L, G, S * n_kv)
    jdense = jl.KVCache(jk, jv, jnp.ones((G, S), bool),
                        jnp.zeros((G, S), jnp.int32), jnp.int32(S), ks, vs)

    def t(x):
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
                torch.bfloat16)
        return torch.from_numpy(np.asarray(x))

    tdense = tl.KVCache(
        t(jk), t(jv), torch.ones((G, S), dtype=torch.bool),
        torch.zeros((G, S), dtype=torch.int32), S,
        None if ks is None else t(ks).reshape(L, G, S, n_kv),
        None if vs is None else t(vs).reshape(L, G, S, n_kv))
    return jdense, tdense


def _same_pool_bytes(jpaged, tpaged, pages):
    pages = np.asarray(sorted(set(int(p) for p in pages) - {0}))
    assert pages.size

    def bits(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()

    def jbits(x):
        if x.dtype == jnp.bfloat16:
            return np.asarray(x).view(np.int16)
        return np.asarray(x)

    for name in ("k", "v"):
        np.testing.assert_array_equal(
            bits(getattr(tpaged, name))[:, pages],
            jbits(getattr(jpaged, name))[:, pages], err_msg=name)
    if tpaged.k_scale is not None:
        for name in ("k_scale", "v_scale"):
            got = getattr(tpaged, name).numpy()[:, pages]
            np.testing.assert_array_equal(
                got.reshape(got.shape[0], got.shape[1], -1),
                np.asarray(getattr(jpaged, name))[:, pages], err_msg=name)


IMPORTS = [("bf16", "bf16"), ("int8", "int8"), ("bf16", "int8")]


def _pools(jcfg, tcfg, pool, n_pages):
    jd = jnp.bfloat16 if pool == "bf16" else jnp.int8
    td = torch.bfloat16 if pool == "bf16" else torch.int8
    return (jpc.init_paged_cache(jcfg, n_pages, PAGE, dtype=jd),
            tpc.init_paged_cache(tcfg, n_pages, PAGE, device="cpu",
                                 dtype=td))


@pytest.mark.parametrize("dense,pool", IMPORTS)
def test_import_prefill_pools_equal_jax_bytes(models, dense, pool):
    jcfg, _, tcfg, _ = models
    S, pad = 32, 11                       # 21 tokens -> 3 pages
    jdense, tdense = _dense_pair(tcfg, 1, S, dense, seed=1)
    jpaged, tpaged = _pools(jcfg, tcfg, pool, 9)
    alloc = tpc.PageAllocator(9, PAGE, 2, 4)
    assert alloc.allocate_row(0, 3) and alloc.allocate_row(1, S - pad, 2)
    row, n_p = alloc.tables[1], int(alloc.n_alloc[1])
    jpaged = jpc.import_prefill(jpaged, jdense, pad, row, n_p, PAGE)
    out = tpc.import_prefill(tpaged, tdense, pad, row, n_p, PAGE)
    assert out is tpaged                  # updated in place
    _same_pool_bytes(jpaged, tpaged, row[:n_p])
    # the other row's page was not touched
    assert not tpaged.k[:, alloc.tables[0, 0]].any()


@pytest.mark.parametrize("dense,pool", IMPORTS)
def test_import_prefill_group_pools_equal_jax_bytes(models, dense, pool):
    jcfg, _, tcfg, _ = models
    G, S = 3, 32
    pads = [0, 13, 27]
    jdense, tdense = _dense_pair(tcfg, G, S, dense, seed=2)
    jpaged, tpaged = _pools(jcfg, tcfg, pool, 14)
    alloc = tpc.PageAllocator(14, PAGE, G, 5)
    for g in range(G):
        assert alloc.allocate_row(g, S - pads[g], headroom=3)
    jpaged = jpc.import_prefill_group(jpaged, jdense, pads, alloc.tables, PAGE)
    tpc.import_prefill_group(tpaged, tdense, pads, alloc.tables, PAGE)
    _same_pool_bytes(jpaged, tpaged, alloc.tables.reshape(-1))


def test_import_dense_cache_and_dtype_check(models):
    jcfg, _, tcfg, _ = models
    jdense, tdense = _dense_pair(tcfg, 1, 16, "int8", seed=3)
    jpaged, tpaged = _pools(jcfg, tcfg, "int8", 6)
    row = np.array([4, 2, 0, 0], np.int32)
    jpaged = jpc.import_dense_cache(jpaged, jdense, row, PAGE)
    tpc.import_dense_cache(tpaged, tdense, row, PAGE)
    _same_pool_bytes(jpaged, tpaged, row)
    float_pool = _pools(jcfg, tcfg, "bf16", 6)[1]
    with pytest.raises(ValueError, match="int8 dense KV cache"):
        tpc.import_dense_cache(float_pool, tdense, row, PAGE)


def test_import_page_range_equals_jax_bytes(models):
    jcfg, _, tcfg, _ = models
    jdense, tdense = _dense_pair(tcfg, 1, 40, "bf16", seed=4)
    for pool in ("bf16", "int8"):
        jpaged, tpaged = _pools(jcfg, tcfg, pool, 8)
        ids = np.array([6, 1, 3], np.int32)
        jpaged = jpx.import_page_range(jpaged, jdense, 2, 3, ids, PAGE)
        tpx.import_page_range(tpaged, tdense, 2, 3, ids, PAGE)
        _same_pool_bytes(jpaged, tpaged, ids)


def _prefilled(models, kv, B=2, S=16, seed=0, window=0):
    """Both packages prefill the same prompt into a dense cache; the JAX
    cache is imported into a JAX pool through scrambled tables and that pool
    state is carried across to the port."""
    jcfg, jp, tcfg, tp = models
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv, sliding_window=window)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv, sliding_window=window)
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 100, (B, S)).astype(np.int32)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    dense = jl.init_kv_cache(jcfg, B, S, dtype=None if kv else jnp.float32)
    hidden, dense = jl.llama_forward(
        jp, jcfg, jl.embed_tokens(jp, jnp.asarray(ids)), position_ids=pos,
        attn_valid=jnp.ones((B, S), bool), cache=dense)
    tok = np.asarray(jnp.argmax(jl.lm_head(jp, hidden[:, -1:])[:, 0], -1),
                     np.int32)
    n_pages = 14
    jpaged = jpc.init_paged_cache(jcfg, n_pages, PAGE,
                                  dtype=None if kv else jnp.float32)
    alloc = jpc.PageAllocator(n_pages, PAGE, B, 5)
    for b in range(B):                    # interleave: scattered tables
        assert alloc.allocate_row(b, PAGE)
    for b in range(B):
        while alloc.capacity(b) < S + 9:
            assert alloc.extend_row(b)
    jpaged = jpc.import_prefill_group(jpaged, dense, [0] * B, alloc.tables,
                                      PAGE)
    tpaged = paged_cache_from_jax(*(None if x is None else np.asarray(x)
                                    for x in jpaged), device="cpu")
    talloc = page_allocator_from_jax(alloc.tables, alloc.n_alloc, alloc.free,
                                     n_pages, PAGE)
    return jcfg, tcfg, jpaged, alloc, tpaged, talloc, tok, S


@pytest.mark.parametrize("kv", ["", "int8"])
def test_decode_steps_from_the_same_pool_state_equal_jax(models, kv):
    _, jp, _, tp = models
    jcfg, tcfg, jpaged, alloc, tpaged, talloc, tok, S = _prefilled(models, kv)
    _same_allocators(alloc, talloc)
    assert tpaged.k.shape == tuple(jpaged.k.shape)
    if kv:
        assert tpaged.k_scale.shape == tpaged.k.shape[:4]
    B = tok.shape[0]
    kpaged = tpc.PagedKVCache(*(None if x is None else x.clone() for x in (
        tpaged.k, tpaged.v, tpaged.k_scale, tpaged.v_scale)))
    tables = torch.from_numpy(talloc.tables.copy())
    active = torch.ones((B,), dtype=torch.bool)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for step in range(3):
        jpaged, jlogits = jpc.paged_decode_step(
            jp, jcfg, jpaged, jnp.asarray(alloc.tables),
            jnp.full((B,), S + step, jnp.int32), jtok, jnp.ones((B,), bool),
            PAGE, use_kernel=False)
        row_len = torch.full((B,), S + step, dtype=torch.int32)
        out, gather = tpc.paged_decode_step(tp, tcfg, tpaged, tables, row_len,
                                            ttok, active, PAGE,
                                            use_kernel=False)
        assert out is tpaged
        _, kernel = tpc.paged_decode_step(tp, tcfg, kpaged, tables, row_len,
                                          ttok, active, PAGE, use_kernel=True)
        np.testing.assert_allclose(gather.numpy(), np.asarray(jlogits),
                                   atol=2e-3)
        np.testing.assert_allclose(kernel.numpy(), gather.numpy(), atol=2e-4)
        np.testing.assert_array_equal(gather.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jlogits, -1)))
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        ttok = gather.argmax(-1).to(torch.int32)
    if not kv:          # the float pools went through the same writes
        np.testing.assert_allclose(tpaged.k.numpy(), np.asarray(jpaged.k),
                                   atol=1e-5)


@pytest.mark.parametrize("window", [5, 12])
def test_sliding_window_gather_path_equals_jax_and_kernel_refuses(models,
                                                                  window):
    """A sliding-window config masks the slots older than the window on the
    gather path, as the JAX gather path does (logits within 2e-3, same
    argmax), and is refused where it would reach the paged kernel, which
    attends the whole row."""
    _, jp, _, tp = models
    jcfg, tcfg, jpaged, alloc, tpaged, talloc, tok, S = _prefilled(
        models, "", window=window)
    assert tcfg.sliding_window == window
    B = tok.shape[0]
    whole = tpc.PagedKVCache(tpaged.k.clone(), tpaged.v.clone())
    tables = torch.from_numpy(talloc.tables.copy())
    active = torch.ones((B,), dtype=torch.bool)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for step in range(3):
        jpaged, jlogits = jpc.paged_decode_step(
            jp, jcfg, jpaged, jnp.asarray(alloc.tables),
            jnp.full((B,), S + step, jnp.int32), jtok, jnp.ones((B,), bool),
            PAGE, use_kernel=False)
        row_len = torch.full((B,), S + step, dtype=torch.int32)
        for use_kernel in (None, False):   # None: CPU tensors, the gather path
            pool = tpaged if use_kernel is False else tpc.PagedKVCache(
                tpaged.k.clone(), tpaged.v.clone())
            _, logits = tpc.paged_decode_step(tp, tcfg, pool, tables, row_len,
                                              ttok, active, PAGE,
                                              use_kernel=use_kernel)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       atol=2e-3)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jlogits, -1)))
        # the window changes the result: the same step over the whole row
        _, full = tpc.paged_decode_step(
            tp, dataclasses.replace(tcfg, sliding_window=0), whole, tables,
            row_len, ttok, active, PAGE, use_kernel=False)
        assert (full - logits).abs().max() > 1e-2
        with pytest.raises(ValueError, match="gather path"):
            tpc.paged_decode_step(tp, tcfg, tpaged, tables, row_len, ttok,
                                  active, PAGE, use_kernel=True)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        ttok = logits.argmax(-1).to(torch.int32)
    # the JAX rule: a window config takes the gather path on the card too
    assert tpc._resolve_use_kernel(None, tcfg, torch.device("cuda", 0)) \
        is False
    assert tpc._resolve_use_kernel(None, tcfg, torch.device("cpu")) is False


def test_a_retired_row_with_a_recycled_table_cannot_clobber_a_live_row(
        models):
    """Row 1 is retired; its stale table lists the pages row 0 now owns.
    Its write goes to the trash page, so row 0's pages end up exactly as in
    a run where row 1's table is empty."""
    _, _, tcfg, tp = models
    for use_kernel in (False, True):
        pools = []
        for stale in (False, True):
            paged = tpc.init_paged_cache(tcfg, 6, PAGE, device="cpu",
                                         dtype=torch.float32)
            paged.k[:, 1:] = 0.25
            paged.v[:, 1:] = -0.5
            alloc = tpc.PageAllocator(6, PAGE, 2, 2)
            assert alloc.allocate_row(0, 10)
            if stale:
                alloc.tables[1] = alloc.tables[0]
            tpc.paged_decode_step(
                tp, tcfg, paged, torch.from_numpy(alloc.tables.copy()),
                torch.tensor([9, 9], dtype=torch.int32),
                torch.tensor([5, 7], dtype=torch.int32),
                torch.tensor([True, False]), PAGE, use_kernel=use_kernel)
            pools.append(paged)
        np.testing.assert_array_equal(pools[0].k[:, 1:].numpy(),
                                      pools[1].k[:, 1:].numpy())
        np.testing.assert_array_equal(pools[0].v[:, 1:].numpy(),
                                      pools[1].v[:, 1:].numpy())
        # and the live row did write its slot (page 2 of its table, offset 1)
        page = int(alloc.tables[0, 1])
        assert (pools[1].k[0, page, 1] != 0.25).any()


def test_inactive_rows_leave_their_own_pages_alone(models):
    _, _, tcfg, tp = models
    paged = tpc.init_paged_cache(tcfg, 8, PAGE, device="cpu",
                                 dtype=torch.float32)
    alloc = tpc.PageAllocator(8, PAGE, 2, 2)
    alloc.allocate_row(0, 8)
    alloc.allocate_row(1, 8)
    tpc.paged_decode_step(
        tp, tcfg, paged, torch.from_numpy(alloc.tables.copy()),
        torch.zeros((2,), dtype=torch.int32),
        torch.tensor([5, 7], dtype=torch.int32),
        torch.tensor([True, False]), PAGE)
    assert not paged.k[:, int(alloc.tables[1, 0])].any()
    assert paged.k[:, int(alloc.tables[0, 0]), 0].any()


def test_pool_decode_equals_single_steps_and_stops_on_budget(models):
    _, _, _, tp = models
    _, tcfg, _, _, tpaged, talloc, tok, S = _prefilled(models, "")
    B = tok.shape[0]
    single = tpc.PagedKVCache(tpaged.k.clone(), tpaged.v.clone())
    tables = torch.from_numpy(talloc.tables.copy())
    gen = GenerationConfig(max_new_tokens=8, eos_token_id=-1, pad_token_id=0)
    state = tpc.PoolState(torch.from_numpy(tok),
                          torch.full((B,), S, dtype=torch.int32),
                          torch.tensor([5, 2], dtype=torch.int32),
                          torch.ones((B,), dtype=torch.bool))
    new, toks = tpc.paged_pool_decode(tp, tcfg, gen, 4, tpaged, tables, state,
                                      use_kernel=True)
    want, t = [], torch.from_numpy(tok)
    for step in range(4):
        _, logits = tpc.paged_decode_step(
            tp, tcfg, single, tables,
            torch.full((B,), S + step, dtype=torch.int32), t,
            torch.ones((B,), dtype=torch.bool), PAGE)
        t = logits.argmax(-1).to(torch.int32)
        want.append(t)
    want = torch.stack(want, 1)
    assert toks[0].tolist() == want[0].tolist()
    assert toks[1].tolist() == want[1, :2].tolist() + [-1, -1]
    assert new.active.tolist() == [True, False]
    assert new.lengths.tolist() == [S + 4, S + 2]
    assert new.budget.tolist() == [1, 0]
    assert state.lengths.tolist() == [S, S]     # the old state is untouched


def test_spec_verify_accepts_the_greedy_prefix(models):
    _, _, _, tp = models
    _, tcfg, _, _, tpaged, talloc, tok, S = _prefilled(models, "")
    B, k = tok.shape[0], 3
    tables = torch.from_numpy(talloc.tables.copy())
    gen = GenerationConfig(max_new_tokens=8, eos_token_id=-1, pad_token_id=0)
    ref = tpc.PagedKVCache(tpaged.k.clone(), tpaged.v.clone())

    def fresh():
        return tpc.PoolState(torch.from_numpy(tok),
                             torch.full((B,), S, dtype=torch.int32),
                             torch.full((B,), 8, dtype=torch.int32),
                             torch.ones((B,), dtype=torch.bool))

    _, greedy = tpc.paged_pool_decode(tp, tcfg, gen, k + 1, ref, tables,
                                      fresh(), use_kernel=False)
    drafts = greedy[:, :k].clone().to(torch.int32)
    drafts[1, 1] = (drafts[1, 1] + 1) % tcfg.vocab_size  # row 1: 2nd is wrong
    new, out, n_emit = tpc.paged_spec_verify(tp, tcfg, gen, k, tpaged, tables,
                                             fresh(), drafts)
    assert n_emit.tolist() == [k + 1, 2]
    assert out[0].tolist() == greedy[0].tolist()
    assert out[1].tolist() == greedy[1, :2].tolist() + [-1, -1]
    assert new.lengths.tolist() == [S + k + 1, S + 2]
    assert new.tokens.tolist() == [int(greedy[0, k]), int(greedy[1, 1])]


def test_what_the_decode_does_not_take_raises(models):
    _, _, tcfg, tp = models
    paged = tpc.init_paged_cache(tcfg, 4, PAGE, device="cpu")
    args = (torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32),
            torch.ones((1,), dtype=torch.bool))
    with pytest.raises(ValueError, match="page_size"):
        tpc.paged_decode_step(tp, tcfg, paged, *args, PAGE * 2)
    # MPT's alibi has no place in the paged kernel: an explicit kernel
    # request raises (its gather path: tests/test_torch_families_serving.py)
    with pytest.raises(ValueError, match="gather path"):
        tpc.paged_decode_step(tp, dataclasses.replace(tcfg, arch="mpt"),
                              paged, *args, PAGE, use_kernel=True)
