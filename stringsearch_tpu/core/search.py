"""SA queries: longest-common-substring match and exact pattern search.

Capability parity:
- `longest_substring_match` (ref: crates/sacabase/src/lib.rs:39-99): for a
  needle, find the longest *prefix of the needle* occurring anywhere in the
  indexed text (bsdiff-style LCS semantics — the reference compares the
  needle against the entire remaining suffix, sacabase/src/lib.rs:91).
- `sa_search` (ref: c-sources/utils.c:244-325): (count, leftmost SA index)
  of exact occurrences of the needle.

Data-parallel design: the reference's halving loop is a scalar binary search
with data-dependent byte compares. Here the search is *batched over
needles*: every step gathers a fixed-width window of the text at each
lane's probe position and decides all lanes with one vectorized
lexicographic compare — ceil(log2(n+1)) steps total, no scalar loops.
Sentinels (see core/compare.py) make "suffix ran out of text" and "needle
ran out" order correctly without branches.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from stringsearch_tpu.core import compare as cmp
from stringsearch_tpu.core.types import (
    BytesLike,
    LongestCommonSubstring,
    SuffixArray,
    as_text_array,
)


def _ceil_log2(n: int) -> int:
    return max(1, int(n - 1).bit_length()) if n > 1 else 1


def _needle_batch_to_windows(needles: Sequence[BytesLike]) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad a list of needles to a shared pow2 window width (min 16)."""
    arrs = []
    for nd in needles:
        if isinstance(nd, (bytes, bytearray, memoryview)):
            arrs.append(np.frombuffer(bytes(nd), dtype=np.uint8))
        else:
            a = np.asarray(nd)
            if a.dtype != np.uint8:
                raise TypeError(f"needle must be uint8 bytes, got {a.dtype}")
            arrs.append(a)
    maxm = max((len(a) for a in arrs), default=1)
    width = 16
    while width < maxm:
        width *= 2
    out = np.full((len(arrs), width), cmp.PAST_NEEDLE_END, dtype=np.int32)
    lens = np.zeros((len(arrs),), dtype=np.int32)
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a.astype(np.int32)
        lens[i] = len(a)
    return out, lens, width


def lcs_loop(windows_at, n_sa: int, needles, steps: int):
    """Batched LCS binary search with a pluggable suffix-window fetch.

    windows_at(pos [B]) -> (text_start [B], window [B, M] int32 with
    PAST_TEXT_END sentinels) for SA-slice positions `pos` (callers clamp).
    This is the loop both the single-device kernel (local gathers) and
    the text-sharded distributed query (all-to-all gathers inside
    shard_map, parallel/gather.py) share.
    """
    b = needles.shape[0]
    lo = jnp.zeros((b,), jnp.int32)
    hi = jnp.full((b,), n_sa, jnp.int32)

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) // 2
        _, suff = windows_at(mid)
        less = cmp.lex_less(suff, needles)  # suffix < needle
        active = lo < hi
        lo = jnp.where(active & less, mid + 1, lo)
        hi = jnp.where(active & (~less), mid, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))

    # Longest common prefix is achieved at an insertion-point neighbor.
    left, right = lo - 1, lo
    start_l, win_l = windows_at(left)
    start_r, win_r = windows_at(right)
    lcp_l = cmp.prefix_match_len(win_l, needles)
    lcp_r = cmp.prefix_match_len(win_r, needles)
    lcp_l = jnp.where(left >= 0, lcp_l, -1)
    lcp_r = jnp.where(right <= n_sa - 1, lcp_r, -1)
    take_left = lcp_l >= lcp_r
    start = jnp.where(take_left, start_l, start_r)
    length = jnp.maximum(jnp.where(take_left, lcp_l, lcp_r), 0)
    return start, length


@partial(jax.jit, static_argnames=("steps",))
def lcs_kernel(text, sa, needles, steps: int):
    """Batched LCS query. needles: int32 [B, M] padded with PAST_NEEDLE_END.

    Returns (start [B], length [B]) int32 — position in text of the longest
    needle-prefix match and its length. `sa` may be a sorted SLICE of a
    larger suffix array (the sharded global index searches per-shard
    slices); bounds come from sa's length, window gathers from the text.
    """
    n_sa = sa.shape[0]
    m_width = needles.shape[-1]

    def windows_at(pos):
        starts = jnp.take(sa, jnp.clip(pos, 0, n_sa - 1))
        return starts, cmp.gather_window(text, starts, m_width)

    return lcs_loop(windows_at, n_sa, needles, steps)


def sa_search_loop(cmp_at, n_sa: int, b: int, steps: int):
    """Batched double binary search with a pluggable probe compare.

    cmp_at(pos [B]) -> int32 [B]: three-way compare of the suffix-prefix
    at SA-slice position `pos` against each lane's needle (callers clamp
    positions and handle needle-length masking). Returns
    (lo [B], up [B]): the lower and upper bound insertion points of the
    needle in the length-`n_sa` sorted slice — count = up - lo, leftmost
    occurrence slot = lo. This is the loop the single-device kernel and
    the distributed per-shard search (parallel/global_sa.py) share, like
    `lcs_loop` for the LCS query.
    """
    lo_l = jnp.zeros((b,), jnp.int32)
    hi_l = jnp.full((b,), n_sa, jnp.int32)
    lo_u = jnp.zeros((b,), jnp.int32)
    hi_u = jnp.full((b,), n_sa, jnp.int32)

    def body(_, state):
        lo_l, hi_l, lo_u, hi_u = state
        mid_l = (lo_l + hi_l) // 2
        c_l = cmp_at(mid_l)
        act = lo_l < hi_l
        less = c_l < 0
        lo_l = jnp.where(act & less, mid_l + 1, lo_l)
        hi_l = jnp.where(act & (~less), mid_l, hi_l)

        mid_u = (lo_u + hi_u) // 2
        c_u = cmp_at(mid_u)
        act = lo_u < hi_u
        leq = c_u <= 0
        lo_u = jnp.where(act & leq, mid_u + 1, lo_u)
        hi_u = jnp.where(act & (~leq), mid_u, hi_u)
        return lo_l, hi_l, lo_u, hi_u

    lo_l, _, lo_u, _ = jax.lax.fori_loop(
        0, steps, body, (lo_l, hi_l, lo_u, hi_u)
    )
    return lo_l, lo_u


def needle_mask_cmp(needles, lens):
    """Build `windows -> cmp` that compares only each lane's first
    len(needle) bytes (the rest neutralized to equal sentinels)."""
    m_width = needles.shape[-1]
    offs = jnp.arange(m_width, dtype=jnp.int32)
    within = offs[None, :] < lens[:, None]  # [B, M]

    def compare(suff):
        suff_m = jnp.where(within, suff, cmp.PAST_NEEDLE_END)
        return cmp.lex_cmp(suff_m, needles)  # -1/0/+1 vs needle prefix

    return compare


@partial(jax.jit, static_argnames=("steps",))
def sa_search_kernel(text, sa, needles, lens, steps: int):
    """Batched exact-occurrence search: returns (count [B], left [B]).

    `left` is the SA index of the leftmost occurrence (the lower bound —
    matching the reference's `sa_search` *idx out-param,
    c-sources/utils.c:244-325).
    """
    n = text.shape[0]
    m_width = needles.shape[-1]
    b = needles.shape[0]
    compare = needle_mask_cmp(needles, lens)

    def cmp_at(pos):
        starts = jnp.take(sa, jnp.clip(pos, 0, n - 1))
        return compare(cmp.gather_window(text, starts, m_width))

    lo, up = sa_search_loop(cmp_at, n, b, steps)
    return up - lo, lo


@jax.jit
def simplesearch_kernel(text, sa, chars):
    """Single-character occurrence search, batched over chars [B].

    Returns (count [B], left [B]). The SA's first-character column is
    nondecreasing, so both bounds are one vectorized searchsorted each
    (ref: c-sources/utils.c:328-381 `sa_simplesearch`).
    """
    first = jnp.take(text, sa).astype(jnp.int32)  # nondecreasing [n]
    c = chars.astype(jnp.int32)
    left = jnp.searchsorted(first, c, side="left").astype(jnp.int32)
    right = jnp.searchsorted(first, c, side="right").astype(jnp.int32)
    return right - left, left


def sa_simplesearch(index: SuffixArray, c: int) -> tuple[int, int]:
    """(count, leftmost SA index) of suffixes starting with byte `c`."""
    n = len(index)
    if n == 0:
        return 0, 0
    count, left = simplesearch_kernel(
        index.text, index.sa, jnp.asarray([c], dtype=jnp.int32)
    )
    return int(np.asarray(count)[0]), int(np.asarray(left)[0])


# ---------------------------------------------------------------------------
# host-facing wrappers
# ---------------------------------------------------------------------------

def longest_substring_match_batch(
    index: SuffixArray, needles: Sequence[BytesLike]
) -> list[LongestCommonSubstring]:
    if not needles:
        return []
    n = len(index)
    if n == 0:
        host = index.text_bytes()
        return [LongestCommonSubstring(host, 0, 0) for _ in needles]
    padded, _lens, _w = _needle_batch_to_windows(needles)
    steps = _ceil_log2(n + 1) + 1
    start, length = lcs_kernel(index.text, index.sa, jnp.asarray(padded), steps)
    # one device->host transfer for both results
    both = np.asarray(jnp.stack([start, length]))
    start, length = both[0], both[1]
    host = index.text_bytes()
    return [
        LongestCommonSubstring(host, int(start[i]), int(length[i]))
        for i in range(len(needles))
    ]


def longest_substring_match(index: SuffixArray, needle: BytesLike) -> LongestCommonSubstring:
    return longest_substring_match_batch(index, [needle])[0]


def sa_search_batch(
    index: SuffixArray, needles: Sequence[BytesLike]
) -> list[tuple[int, int]]:
    if not needles:
        return []
    n = len(index)
    if n == 0:
        return [(0, 0) for _ in needles]
    padded, lens, _w = _needle_batch_to_windows(needles)
    steps = _ceil_log2(n + 1) + 1
    count, left = sa_search_kernel(
        index.text, index.sa, jnp.asarray(padded), jnp.asarray(lens), steps
    )
    both = np.asarray(jnp.stack([count, left]))  # one host fetch
    count, left = both[0], both[1]
    return [(int(count[i]), int(left[i])) for i in range(len(needles))]


def sa_search(index: SuffixArray, needle: BytesLike) -> tuple[int, int]:
    return sa_search_batch(index, [needle])[0]
