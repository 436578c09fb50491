"""Differential conformance vs the C++ oracle (ref: divsuftest crosscheck,
crates/divsuftest/src/main.rs:82-113) + oracle self-tests."""

import numpy as np
import pytest

import stringsearch_tpu as st
from stringsearch_tpu import oracle
from tests.conftest import naive_suffix_array


def test_oracle_parity_vs_naive(corpus):
    for name, data in corpus.items():
        if len(data) > 2048:
            continue
        sa = oracle.build(data)
        assert np.array_equal(sa, naive_suffix_array(data)), name


def test_engine_vs_oracle_crosscheck(corpus):
    """The heart of the reference's test strategy: two independent engines,
    byte-exact equality (the SA of a text is unique)."""
    for name, data in corpus.items():
        dev_sa = np.asarray(st.build_suffix_array(data, engine="doubling").sa)
        c_sa = oracle.build(data)
        assert np.array_equal(dev_sa, c_sa), f"engines disagree on {name!r}"


def test_engine_vs_oracle_random_large():
    rng = np.random.default_rng(77)
    for n, alpha in [(20000, 256), (20000, 2), (50000, 4)]:
        data = bytes(rng.integers(0, alpha, n, dtype=np.uint8))
        dev_sa = np.asarray(st.build_suffix_array(data).sa)
        c_sa = oracle.build(data)
        assert np.array_equal(dev_sa, c_sa), (n, alpha)


def test_sufcheck_accepts_and_rejects():
    data = b"the theme of the thesis"
    sa = oracle.build(data)
    assert oracle.sufcheck(data, sa) == 0
    bad = sa.copy()
    bad[[0, 1]] = bad[[1, 0]]
    assert oracle.sufcheck(data, bad) != 0
    assert oracle.sufcheck(data, np.zeros_like(sa)) != 0


def test_oracle_search_matches_device_search():
    rng = np.random.default_rng(123)
    data = bytes(rng.integers(0, 6, 800, dtype=np.uint8))
    idx = st.build_suffix_array(data)
    c_sa = oracle.build(data)
    for _ in range(20):
        m = int(rng.integers(1, 8))
        needle = bytes(rng.integers(0, 6, m, dtype=np.uint8))
        c_cnt, c_left = oracle.search(data, needle, c_sa)
        t_cnt, t_left = idx.search(needle)
        assert c_cnt == t_cnt, needle
        if c_cnt > 0:
            assert c_left == t_left, needle


def test_version_string():
    assert "SA-IS" in oracle.version()
