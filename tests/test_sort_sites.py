"""The doubling engine's sort call sites against numpy `lexsort`.

Every engine sort is a plain `jax.lax.sort`; these cases drive the call
sites themselves — `_pack4_keys` plus the initial sort, the fan round
sort with its negative past-the-end markers, the rank invert, and the
sentinel-keyed extraction — and compare each ordering and head-slot
ranking with an independent numpy formulation. Each case runs on the
CPU and, marked `gpu`, on the GPU, where XLA may lower a sort to a
library radix sort instead of its own sort kernel: both must keep
`lax.sort`'s stable order.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stringsearch_tpu.engines import doubling as D

_SENT = np.iinfo(np.int32).max


def _packed_keys(text: np.ndarray, depth: int) -> list[np.ndarray]:
    """depth/4 big-endian words of the zero-padded text at every position."""
    n = len(text)
    pad = np.concatenate([text, np.zeros(depth, np.uint8)]).astype(np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(pad, depth)[:n]
    words = win.reshape(n, depth // 4, 4)
    w = (words[:, :, 0] << 24) | (words[:, :, 1] << 16) | (words[:, :, 2] << 8) \
        | words[:, :, 3]
    return [w[:, k] for k in range(depth // 4)]


def _shifted(rank: np.ndarray, s: int) -> np.ndarray:
    """rank[i+s], or the marker -(i+1) where i+s runs past the end."""
    n = len(rank)
    i = np.arange(n, dtype=np.int64)
    src = np.minimum(i + s, n - 1)
    return np.where(i + s >= n, -(i + 1), rank[src])


def _sorted_state(keys: list[np.ndarray]):
    """(sa_s, rank_s, count) of a stable multi-key sort, numpy only."""
    n = len(keys[0])
    j = np.arange(n)
    order = np.lexsort([j] + keys[::-1])  # lexsort: last key is primary
    rows = np.stack([k[order] for k in keys], axis=1)
    new = np.ones(n, bool)
    new[1:] = np.any(rows[1:] != rows[:-1], axis=1)
    rank_s = np.maximum.accumulate(np.where(new, j, 0))
    size = np.bincount(rank_s, minlength=n)
    count = int(np.sum(size[rank_s] >= 2))
    return order, rank_s, count


def _initial(text: np.ndarray, depth: int):
    f = jax.jit(partial(D._initial_sorted, depth=depth))
    got = f(jnp.asarray(text))
    return got, _sorted_state(_packed_keys(text, depth))


def _case_kv_random(rng):
    """The invert: random (permutation key, value) pairs."""
    n = 3000
    sa = rng.permutation(n).astype(np.int32)
    vals = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
    got = jax.jit(D._scatter_to_text_order)(jnp.asarray(sa), jnp.asarray(vals))
    return [got], [vals[np.lexsort([sa])]]


def _case_high_bit(rng):
    """Initial sort over packed words with the top bit set (uint32 keys)."""
    text = rng.choice(np.arange(0xF0, 0x100, dtype=np.uint8), 2500)
    (sa_s, rank_s, count), want = _initial(text, 12)
    return [sa_s, rank_s, count], list(want)


def _case_multikey_payload(rng):
    """Fan-3 round sort: rank plus two shifted keys, position payload."""
    n = 2000
    rank = rng.integers(0, 40, n).astype(np.int32)
    h = 7
    sa_s, rank_s, count = jax.jit(
        partial(D._full_round_sorted, fan=3))(jnp.asarray(rank), h)
    keys = [rank.astype(np.int64), _shifted(rank, h), _shifted(rank, 2 * h)]
    return [sa_s, rank_s, count], list(_sorted_state(keys))


def _case_six_keys(rng):
    """Depth-24 initial sort: six packed key words."""
    text = rng.integers(0, 3, 1500).astype(np.uint8)
    (sa_s, rank_s, count), want = _initial(text, 24)
    return [sa_s, rank_s, count], list(want)


def _case_all_equal(rng):
    """All-equal bytes: only the zero padding past the end splits keys."""
    text = np.full(1024, ord("a"), np.uint8)
    (sa_s, rank_s, count), want = _initial(text, 12)
    return [sa_s, rank_s, count], list(want)


def _case_sentinels(rng):
    """Past-the-end markers (h beyond n/2) and int32-max extraction keys."""
    n = 1800
    rank = rng.integers(0, 6, n).astype(np.int32)
    h = n // 2 + 17
    sa_s, rank_s, count = jax.jit(
        partial(D._full_round_sorted, fan=2))(jnp.asarray(rank), h)
    want = _sorted_state([rank.astype(np.int64), _shifted(rank, h)])
    # extraction of the tied members: untied slots carry the sentinel key
    m = n // 2
    g, pos = jax.jit(partial(D._extract, m=m, method="sort"))(rank_s, sa_s)
    w_sa, w_rank = want[0], want[1]
    j = np.arange(n)
    nxt = np.append(w_rank[1:], -1)
    key = np.where((w_rank != j) | (nxt == w_rank), w_rank, _SENT)
    order = np.lexsort([j, key])
    w_g = key[order][:m]
    w_pos = np.where(w_g == _SENT, n, w_sa[order][:m])
    return [sa_s, rank_s, count, g, pos], list(want) + [w_g, w_pos]


CASES = {
    "kv_random": _case_kv_random,
    "high_bit": _case_high_bit,
    "multikey_payload": _case_multikey_payload,
    "six_keys": _case_six_keys,
    "all_equal": _case_all_equal,
    "sentinels": _case_sentinels,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_call_site(case, device):
    rng = np.random.default_rng(sorted(CASES).index(case))
    with jax.default_device(device):
        got, want = CASES[case](rng)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.devices() == {device}
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.gpu
@pytest.mark.parametrize("alphabet,depth", [(2, 16), (4, 8)])
def test_extract_variants_identical_on_gpu(alphabet, depth, gpu_device):
    """On the GPU, where both the extraction's 1-key sort and its top_k
    lower to a library radix sort, the "sort" and "topk" variants give
    the same (g, pos) in the same order: both keep tied-group members in
    sorted-slot order, as they do on the CPU."""
    rng = np.random.default_rng(alphabet)
    text = rng.integers(0, alphabet, 4096).astype(np.uint8)
    with jax.default_device(gpu_device):
        sa_s, rank_s, count = jax.jit(partial(D._initial_sorted, depth=depth))(
            jnp.asarray(text))
        m = 1024
        assert 0 < int(count) <= m
        out = {method: jax.jit(partial(D._extract, m=m, method=method))(
                   rank_s, sa_s)
               for method in ("sort", "topk")}
    for g_sort, g_topk in zip(out["sort"], out["topk"]):
        assert g_sort.devices() == {gpu_device}
        np.testing.assert_array_equal(np.asarray(g_sort), np.asarray(g_topk))
