"""Exact global sharded SA (parallel/global_sa.py) on the 8-way CPU mesh.

The invariant under test is strict: the sharded build must produce THE
suffix array of the whole text — byte-identical to the single-device
doubling engine and to the naive oracle — including zero-pad handling,
cross-shard rank propagation, and the distributed bitonic sort.
"""

import jax
import numpy as np
import pytest

import stringsearch_tpu as st
from stringsearch_tpu.harness.corpus import enwik_like, regression_corpus
from stringsearch_tpu.parallel.global_sa import build_global
from stringsearch_tpu.parallel.mesh import make_mesh

from tests.conftest import naive_suffix_array


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return make_mesh(8, batch_axis=1, devices=devs)


@pytest.fixture(scope="module")
def mesh4():
    devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.skip("needs 4 virtual CPU devices")
    return make_mesh(4, batch_axis=1, devices=devs)


def test_global_exact_small(mesh8):
    text = b"banana band bandana ban bananas in pajamas"
    g = build_global(text, mesh8)
    np.testing.assert_array_equal(g.suffix_array(), naive_suffix_array(text))


def test_global_exact_vs_engine(mesh8):
    text = enwik_like(3000, seed=3)
    g = build_global(text, mesh8)
    want = np.asarray(st.build_suffix_array(text).sa)
    np.testing.assert_array_equal(g.suffix_array(), want)


@pytest.mark.parametrize("name", ["period2", "fibonacci", "sparse-alpha",
                                  "all-zero-64", "random-4k", "shruggy"])
def test_global_regression_corpus(mesh8, name):
    text = regression_corpus()[name]
    g = build_global(text, mesh8)
    np.testing.assert_array_equal(g.suffix_array(), naive_suffix_array(text))


def test_global_sharded_verify_ok(mesh8):
    for text in (enwik_like(5000, seed=9), b"banana" * 100,
                 regression_corpus()["fibonacci"]):
        build_global(text, mesh8).verify()


def test_global_sharded_verify_catches_corruption(mesh8):
    from jax.sharding import NamedSharding, PartitionSpec as P

    text = enwik_like(4000, seed=11)
    g = build_global(text, mesh8)
    g.verify()
    sharding = NamedSharding(mesh8, P("parts"))

    # corrupt the SA shards: swap two entries — inverse check must trip
    sa = np.asarray(jax.device_get(g._sa_sharded)).copy()
    sa[100], sa[200] = sa[200], sa[100]
    good_sa = g._sa_sharded
    g._sa_sharded = jax.device_put(sa, sharding)
    with pytest.raises(st.NotSorted):
        g.verify()
    g._sa_sharded = good_sa

    # corrupt rank into a non-permutation
    rank = np.asarray(jax.device_get(g.rank)).copy()
    rank[5] = rank[6]
    g.rank = jax.device_put(rank, sharding)
    with pytest.raises(st.NotSorted, match="permutation"):
        g.verify()

    # consistent swap of BOTH rank and sa (still a permutation and a
    # consistent inverse, but not suffix order) — adjacency must trip
    # with a concrete failing pair
    g2 = build_global(text, mesh8)
    rank = np.asarray(jax.device_get(g2.rank)).copy()
    sa = np.asarray(jax.device_get(g2._sa_sharded)).copy()
    a, b = int(sa[300]), int(sa[301])
    rank[a], rank[b] = rank[b], rank[a]
    sa[300], sa[301] = sa[301], sa[300]
    g2.rank = jax.device_put(rank, sharding)
    g2._sa_sharded = jax.device_put(sa, sharding)
    with pytest.raises(st.NotSorted):
        g2.verify()


def test_global_non_divisible_lengths(mesh4):
    rng = np.random.default_rng(5)
    for n in (1, 2, 3, 5, 17, 101, 1003):
        text = bytes(rng.integers(0, 8, n, dtype=np.uint8))
        g = build_global(text, mesh4)
        np.testing.assert_array_equal(
            g.suffix_array(), naive_suffix_array(text), err_msg=f"n={n}"
        )


def test_global_query_api(mesh8):
    text = b"the quick brown fox jumps over the lazy dog; the fox again"
    g = build_global(text, mesh8)
    idx = g.to_suffix_array_index()
    m = idx.longest_substring_match(b"the fox jumps")
    assert text[m.start : m.start + m.len] == b"the fox jumps"[: m.len]
    assert m.len == len(b"the fox ")  # diverges at "again" in the text


def test_global_distributed_query(mesh8):
    text = b"it is time, gentlemen; time to go home, time to sleep, time flies"
    g = build_global(text, mesh8)
    full = st.build_suffix_array(text)
    needles = [b"time to", b"gentle", b"sleep, time flies away", b"zzz",
               b"t", b"\x00weird", text[-7:] + b"overrun"]
    got = g.longest_substring_match_batch(needles)
    want = full.longest_substring_match_batch(needles)
    for nd, a, b in zip(needles, got, want):
        assert a.len == b.len, nd
        assert text[a.start : a.start + a.len] == nd[: a.len]
    single = g.longest_substring_match(b"time fl")
    assert single.as_bytes() == b"time fl"


def test_global_query_executable_cached(mesh8):
    """A second query batch with the same shapes must not re-trace
    (VERDICT r2: the build path cached its jits, the query path did
    not). The factory is lru-cached and the jit compiles once."""
    from stringsearch_tpu.parallel.global_sa import _jit_query

    text = b"caching the query path means tracing it exactly once" * 2
    g = build_global(text, mesh8)
    _jit_query.cache_clear()
    g.longest_substring_match_batch([b"query", b"trace"])
    info1 = _jit_query.cache_info()
    assert info1.misses == 1
    g.longest_substring_match_batch([b"once!", b"again"])
    info2 = _jit_query.cache_info()
    assert info2.misses == 1 and info2.hits >= 1


def test_global_i64_index_mode(mesh8):
    """idx=jnp.int64 (the multi-host 64-bit mode, ref
    c-sources/divsufsort_private.h:63-84) must produce int64 output equal
    to the i32 build on the same text."""
    import jax.numpy as jnp

    text = bytes(
        np.random.default_rng(42).integers(0, 16, 777, dtype=np.uint8)
    )
    want = build_global(text, mesh8).suffix_array()
    with jax.enable_x64():
        g64 = build_global(text, mesh8, idx=jnp.int64)
        got = g64.suffix_array()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def test_global_rounds_are_batched(mesh8):
    """Deep initial keys + blocked dispatch: text-like input resolves in
    at most one dispatch block of rounds (VERDICT r1 item 4)."""
    from stringsearch_tpu.parallel.global_sa import ROUNDS_PER_DISPATCH

    g = build_global(enwik_like(4096), mesh8)
    assert g.rounds_run <= ROUNDS_PER_DISPATCH, g.rounds_run


def test_global_query_sharded_text_mode(mesh8):
    """text_mode='sharded' (all-to-all window fetches, no replicated text)
    must agree with the replicated query exactly."""
    text = (b"the time traveller (for so it will be convenient to speak "
            b"of him) was expounding a recondite matter to us; time, time")
    g = build_global(text, mesh8)
    needles = [b"time tr", b"recondite matters", b"zzz-not-here", b"t",
               text[-9:] + b"\x00tail", b"e"]
    rep = g.longest_substring_match_batch(needles)
    shd = g.longest_substring_match_batch(needles, text_mode="sharded")
    for nd, a, b in zip(needles, rep, shd):
        assert a.len == b.len, (nd, a.len, b.len)
        assert text[b.start : b.start + b.len] == nd[: b.len]


def _oracle_search(text: bytes, needle: bytes):
    from stringsearch_tpu import oracle

    return oracle.search(text, needle, oracle.build(text))


def test_global_sa_search_matches_oracle(mesh8):
    """Distributed sa_search must be slot-exact vs the C oracle's
    flat-SA search (ref: c-sources/utils.c:244-325) — the global index
    IS the SA of the whole text, so counts AND left slots agree."""
    text = enwik_like(3000, seed=21)
    g = build_global(text, mesh8)
    rng = np.random.default_rng(5)
    needles = [bytes(text[s : s + int(rng.integers(1, 24))])
               for s in rng.integers(0, len(text) - 24, 12)]
    needles += [b"zzzzzz-not-present", b"\x00", b"a", text[:1]]
    got = g.sa_search_batch(needles)
    for nd, (count, left) in zip(needles, got):
        wc, wl = _oracle_search(text, nd)
        assert count == wc, (nd, count, wc)
        if count:
            assert left == wl, (nd, left, wl)


def test_global_sa_search_pad_and_nul_edges(mesh8):
    """Needles that could falsely extend into the zero pad, and NUL
    needles that must match real NULs but never pad bytes."""
    text = b"ab\x00\x00ab" * 9 + b"ab"  # length 56: pads on the 8-mesh
    g = build_global(text, mesh8)
    for nd in (b"ab", b"ab\x00", b"\x00", b"\x00\x00", b"\x00\x00a", b"b"):
        wc, wl = _oracle_search(text, nd)
        got = g.sa_search(nd)
        assert got[0] == wc, (nd, got, (wc, wl))
        if got[0]:
            assert got[1] == wl, (nd, got, (wc, wl))


def test_global_sa_search_sharded_text_mode(mesh8):
    text = enwik_like(2000, seed=31)
    g = build_global(text, mesh8)
    needles = [text[100:110], b"missing!", text[40:41]]
    rep = g.sa_search_batch(needles, text_mode="replicated")
    sh = g.sa_search_batch(needles, text_mode="sharded")
    assert rep == sh
    for nd, got in zip(needles, rep):
        assert got[0] == _oracle_search(text, nd)[0]


def test_global_simplesearch(mesh8):
    from stringsearch_tpu import oracle

    text = enwik_like(1500, seed=41)
    g = build_global(text, mesh8)
    osa = oracle.build(text)
    for c in (ord("a"), ord(" "), 0, 255):
        count, left = g.sa_simplesearch(c)
        wc, wl = oracle.simplesearch(text, c, osa)
        assert count == wc, (c, count, wc)
        if count:
            assert left == wl


def test_global_distributed_compaction(mesh8):
    """Adversarial inputs (tiny alphabets, repeats) must route through
    the COMPACTED rounds (per-round collective volume bounded by the live tied
    population) and still produce THE suffix array; compaction=False
    pins the full-width path for differential comparison."""
    rng = np.random.default_rng(11)
    cases = [
        bytes(rng.integers(0, 2, 700, dtype=np.uint8)),
        (b"xyxz" * 200)[:777],
        bytes(rng.integers(0, 256, 900, dtype=np.uint8)),
    ]
    compacted_somewhere = False
    for text in cases:
        g = build_global(text, mesh8, depth=8, fan=3)
        want = naive_suffix_array(text)
        np.testing.assert_array_equal(g.suffix_array(), want)
        g.verify()
        g2 = build_global(text, mesh8, depth=8, fan=3, compaction=False)
        np.testing.assert_array_equal(g2.suffix_array(), want)
        compacted_somewhere |= g.compact_rounds_run > 0
    assert compacted_somewhere, "no case exercised the compacted rounds"


def test_global_compaction_giant_group_falls_back(mesh8):
    """A single giant tie group (all-equal text) must overflow every
    compacted capacity and fall back to full-width rounds — correctness
    over optimization."""
    text = bytes([9]) * 513
    g = build_global(text, mesh8, depth=4, fan=2)
    np.testing.assert_array_equal(g.suffix_array(),
                                  naive_suffix_array(text))
    g.verify()
