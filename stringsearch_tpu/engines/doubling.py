"""Prefix-doubling SACA with tied-group compaction — the flagship engine.

Capability parity: exact suffix-array construction for u8 text, the role
played by divsufsort in the reference (ref: crates/divsufsort/src/lib.rs:20-29
`sort_in_place` / `sort`). The *algorithm* is deliberately different — the
reference's trsort already contains a rank-doubling loop over B* suffixes
(ref: crates/divsufsort/src/trsort.rs:1347-1411 doubling via
`ISAd += ISAd - ISA`); here that idea is generalized to the whole text and
re-expressed with data-parallel primitives only. The build is ONE jitted
program with no host round-trips:

  1. initial ranks from a `depth`-byte packed radix key (depth/4 raw-byte
     uint32 keys, one multi-key sort; default depth 24) — the analog of
     divsufsort's 2-char bucket radix placement
     (ref: crates/divsufsort/src/divsufsort.rs:127-161), taken much deeper
     on the bet that one extra sort key costs less than a full extra
     doubling round, since every avoided round saves 2 full-width sorts
     (`harness/microbench.py ops` measures the key-count curve).
     Measured tied fractions on enwik-class text at n=2^24: 58.8% at
     depth 12, 23.7% at 16, 0.72% at 24, 0 at 48 — so at depth 24 the
     build is typically ONE full-width sort plus small compacted
     rounds, while the memory-constrained large-n configs (depth 12-16,
     see `_auto_depth`) rely on full-width rounds to finish;
  2. full-width fan rounds — sort by (rank[i], rank[i+h], ..,
     rank[i+(fan-1)h]), each key a depth-h class, so one round
     multiplies the depth by `fan` (default 4) instead of 2; head-slot
     ranks from a neighbor-diff + cumulative max — inside a
     lax.while_loop, only while more than n/levels[0] positions remain
     tied (adversarial inputs: long runs, tiny alphabets);
  3. cascaded compaction (Larsson–Sadakane, data-parallel): tied
     group members move to a static n/4-capacity array, then through
     progressively smaller levels (n/32, n/256 by default) as groups
     resolve; each level's rounds run only while the tied count exceeds
     the next level's capacity, so round cost tracks the live tied
     population. Rounds sort only the compacted members, scattering
     rank/SA updates back into the full arrays — the analog of trsort's
     sorted-run skipping via negative ISA sentinels
     (ref: crates/divsufsort/src/trsort.rs:1363-1410).

Initial keys pack four RAW bytes per uint32 word with ZERO padding past
the text end. Zero padding is order-safe: the pad byte 0 is minimal, so
a padded (ended) suffix never sorts after a continuing one at the same
prefix. It does conflate "suffix ended" with "real 0x00 byte", so
initial ranks are not exact depth-`depth` classes for suffixes shorter
than `depth`; the doubling rounds repair this with the past-the-end
marker rank -(i+1) (`_shift_ranks`): negative (below every real rank)
and strictly decreasing in i, so any set of ended suffixes splits
completely — shortest first — at the first round that reaches them.
Because of the conflation the loops must not stop at h >= n on a count
basis alone would suggest; `h` saturates at n, where a final marker
round always resolves every remaining tie.

Ranks are "head-slot" ranks — the SA slot index of the group's first
element — so a compacted element's global SA slot is
`group_head_rank + offset_within_group`. Head-slot ranks are
order-isomorphic to dense ranks and equal the final ISA once all groups
are singletons.

Indexes default to int32 (n < 2^31, the reference's Idx=i32,
ref: crates/divsufsort/src/common.rs:4); pass idx=jnp.int64 (with jax
x64 enabled) for the 64-bit mode (ref: c-sources/divsufsort_private.h:63-84
BUILD_DIVSUFSORT64). All shapes are static under jit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from stringsearch_tpu.core.types import SuffixArray, as_text_array

_I32 = jnp.int32


def _sent(idx) -> jnp.ndarray:
    return jnp.asarray(np.iinfo(np.dtype(idx)).max, idx)


def _pack4_keys(text: jnp.ndarray, depth: int) -> tuple:
    """depth/4 uint32 keys of four RAW text bytes each, zero-padded.

    Raw-byte packing (vs. the 9-bit-biased alternative) fits 4 bytes per
    word; the zero pad is order-safe (see module docstring). uint32 keeps
    byte 0 in the top bits from flipping the sign under lax.sort.
    """
    n = text.shape[0]
    t = jnp.concatenate([text.astype(jnp.uint32),
                         jnp.zeros((depth,), jnp.uint32)])
    keys = []
    for k in range(depth // 4):
        o = 4 * k
        keys.append(
            (t[o : o + n] << 24)
            | (t[o + 1 : o + 1 + n] << 16)
            | (t[o + 2 : o + 2 + n] << 8)
            | t[o + 3 : o + 3 + n]
        )
    return tuple(keys)


def _scatter_to_text_order(sa, rank_s):
    """rank[sa] = rank_s as a 1-key sort instead of an XLA scatter.

    `sa` is a permutation of 0..n-1, so sorting (sa, rank_s) by sa places
    rank_s[j] at text position sa[j]. Sort versus random-access scatter
    (`.at[sa].set`) was chosen on the original accelerator, not yet
    measured on the H100 (`harness/microbench.py ops`: scatter_set vs
    scatter_via_sort).
    """
    with jax.named_scope("rank_invert"):
        _, rank = jax.lax.sort((sa, rank_s), num_keys=1)
    return rank


def _shift_ranks(rank, h):
    """rank_h[i] = rank[i+h], or the marker -(i+1) past the end.

    The marker is negative (an ended suffix sorts before every continuing
    one) and strictly decreasing in i (two suffixes that both end within
    the window split immediately, shorter first) — required because the
    zero-padded raw-byte initial keys conflate "suffix ended" with "real
    0x00 byte" (see module docstring). h is traced; the concat +
    dynamic-slice form keeps the shift a contiguous copy instead of the
    index-driven gather of the `jnp.take(rank, iota+h)` form.
    """
    n = rank.shape[0]
    j = jnp.arange(n, dtype=rank.dtype)
    n_i = jnp.asarray(n, rank.dtype)
    # fan rounds pass shifts k*h that may exceed n: clamp the slice
    # start (XLA would clamp it anyway, silently corrupting the tail
    # markers) and force markers wherever i + h >= n afterwards — a
    # no-op elementwise select when h < n, fused into the consumer sort
    h_c = jnp.minimum(jnp.asarray(h, rank.dtype), n_i)
    # tail slot k (global index n+k) is read by i = n+k-h: marker -(i+1)
    tail = -(n_i + j - h_c + 1)
    ext = jnp.concatenate([rank, tail])
    out = jax.lax.dynamic_slice_in_dim(ext, h_c, n)
    return jnp.where(j + h_c >= n_i, -(j + 1), out)


def _heads_and_tied(new_flag_bool, j):
    """head[j] = slot index of j's group head; tied[j] = group size >= 2."""
    head = jax.lax.cummax(jnp.where(new_flag_bool, j, -1))
    nxt_head = jnp.concatenate([head[1:], jnp.full((1,), -1, head.dtype)])
    tied = (head != j) | (nxt_head == head)
    return head, tied


def _ranks_sorted_only(out, idx):
    """Head-slot ranking of a sorted (keys..., payload) tuple — SORTED
    order only, no inverse permutation. Returns (sa_s, rank_s, count).

    The text-order rank is deliberately NOT computed here: rounds invert
    lazily (each round inverts its PREDECESSOR's ranks just before the
    shifted-key fetch), so the final round of a build that resolves never
    pays the inverse-permutation sort at all — on 256 MB enwik-like text
    that is the difference between two and three full-width sort passes
    after the initial (tied@48B is 0, so the last round's invert had no
    consumer besides the optional ISA return).
    """
    sa_s = out[-1]
    n = sa_s.shape[0]
    j = jnp.arange(n, dtype=idx)
    diff = jnp.zeros((max(n - 1, 0),), bool)
    for ks in out[:-1]:
        diff = diff | (ks[1:] != ks[:-1])
    new_flag = jnp.concatenate([jnp.ones((min(n, 1),), bool), diff])
    rank_s, tied = _heads_and_tied(new_flag, j)
    return sa_s, rank_s, jnp.sum(tied.astype(idx))


def _ranks_from_sorted(out, idx):
    """Shared head-slot ranking for a sorted (keys..., payload) tuple.

    Returns (rank_text_order, sa_s, rank_s, count_tied)."""
    sa_s, rank_s, count = _ranks_sorted_only(out, idx)
    rank = _scatter_to_text_order(sa_s, rank_s)
    return rank, sa_s, rank_s, count


def _initial_sorted(text, idx=_I32, depth: int = 24):
    """`depth`-byte initial sort, sorted-order state only.

    Returns (sa_s, rank_s, count_tied) — no inverse permutation (see
    `_ranks_sorted_only`)."""
    n = text.shape[0]
    keys = _pack4_keys(text, depth)
    j = jnp.arange(n, dtype=idx)
    with jax.named_scope("initial_sort"):
        out = jax.lax.sort(keys + (j,), num_keys=len(keys))
    return _ranks_sorted_only(out, idx)


def _initial_full(text, idx=_I32, depth: int = 24):
    """`depth`-byte initial sort. Returns (rank, sa_s, rank_s, count_tied)."""
    sa_s, rank_s, count = _initial_sorted(text, idx, depth)
    rank = _scatter_to_text_order(sa_s, rank_s)
    return rank, sa_s, rank_s, count


def _full_round(rank, h, idx=_I32, fan: int = 2):
    """One full-width round with head-slot ranks + tied count.

    `fan` generalizes doubling: the sort keys are
    (rank[i], rank[i+h], ..., rank[i+(fan-1)h]), each a depth-h class, so
    one round multiplies the resolved depth by `fan` instead of 2 — the
    caller advances h *= fan. Each extra key is one more n-length sort
    operand, traded against a whole extra full-width round (sort + rank
    scatter); see harness/microbench.py. The
    past-the-end marker protocol (`_shift_ranks`) is per-key: a suffix
    ending within segment k gets the distinct negative marker -(i+1) at
    key k+1, so ended suffixes still split shortest-first at the first
    key that reaches past them.
    """
    sa_s, rank_s, count = _full_round_sorted(rank, h, idx, fan)
    rank = _scatter_to_text_order(sa_s, rank_s)
    return rank, sa_s, rank_s, count


def _full_round_sorted(rank, h, idx=_I32, fan: int = 2):
    """`_full_round` without the trailing inverse permutation.

    Takes TEXT-order ranks, returns (sa_s, rank_s, count) in sorted
    order — the lazy-invert round body (see `_ranks_sorted_only`)."""
    n = rank.shape[0]
    j = jnp.arange(n, dtype=idx)
    # k*h can overflow idx for huge n: cap h at n//k + 1 first (static n),
    # so the product is <= n + k and _shift_ranks clamps the rest
    keys = (rank,) + tuple(
        _shift_ranks(
            rank, jnp.minimum(h, jnp.asarray(n // k + 1, idx)) * k
        )
        for k in range(1, fan)
    )
    with jax.named_scope("round_sort"):
        out = jax.lax.sort(keys + (j,), num_keys=fan)
    return _ranks_sorted_only(out, idx)


def _extract(rank_s, sa_s, m: int, idx=_I32, method: str = "topk"):
    """Compact the members of all tied groups into capacity-m arrays.

    Returns (g [m], pos [m]): group-head ranks and text positions, sorted
    by g (groups contiguous). Pad slots carry g = sentinel, pos = n.

    Two implementations with identical outputs: `lax.sort` is stable by
    default and `lax.top_k` breaks value ties by ascending index, so both
    keep tied-group members in sorted-slot order:
      - "topk": lax.top_k of the negated masked key — cost scales with m
        (`harness/microbench.py extract` measures both);
      - "sort": full-width 1-key sort.
    """
    n = rank_s.shape[0]
    j = jnp.arange(n, dtype=idx)
    nxt_head = jnp.concatenate([rank_s[1:], jnp.full((1,), -1, idx)])
    tied = (rank_s != j) | (nxt_head == rank_s)
    key = jnp.where(tied, rank_s, _sent(idx))
    if method == "topk":
        with jax.named_scope("extract_topk"):
            negv, idxs = jax.lax.top_k(-key, m)
        g = -negv
        pos = jnp.where(g == _sent(idx), jnp.asarray(n, idx),
                        jnp.take(sa_s, idxs))
        return g, pos
    with jax.named_scope("extract_sort"):
        ks, pos = jax.lax.sort((key, sa_s), num_keys=1)
    g = ks[:m]
    pos = jnp.where(g == _sent(idx), n, pos[:m])
    return g, pos


def _compact_round(g, pos, rank, sa, h, idx=_I32, fan: int = 2):
    """One compacted round over the tied groups only.

    g/pos: [m] group-head ranks + positions (pads g=sentinel, pos=n);
    rank/sa: full [n] state updated by scatter. Returns
    (g', pos', rank', sa', count) with resolved entries blanked to pads.
    `fan` as in `_full_round`: keys (g, rank[pos+h], ..,
    rank[pos+(fan-1)h]) advance the depth to fan*h in one round. Every
    rank in the full array has depth >= h (resolved entries are final),
    so each shifted key is a valid depth-h class for its segment.
    """
    n = rank.shape[0]
    m = g.shape[0]
    sent = _sent(idx)
    j = jnp.arange(m, dtype=idx)
    shift_keys = []
    for k in range(1, fan):
        # overflow guard as in _full_round: k*h capped near n.  The
        # past-end test is written as pos >= n - s_k (never pos + s_k,
        # whose sum can exceed idx range for n > 2^30 with large h); the
        # ph sum below is only formed where the test already passed, so
        # it stays < n
        s_k = jnp.minimum(h, jnp.asarray(n // k + 1, idx)) * k
        past = pos >= jnp.asarray(n, idx) - s_k
        ph = jnp.where(past, 0, pos + s_k)
        # past-the-end marker -(pos+1): distinct and decreasing, so
        # suffixes ending within the window split immediately (shorter
        # first) — same protocol as _shift_ranks
        shift_keys.append(jnp.where(past, -(pos + 1), jnp.take(rank, ph)))
    with jax.named_scope("compact_sort"):
        out = jax.lax.sort((g, *shift_keys, pos), num_keys=fan + 1)
    g_s, pos_s = out[0], out[-1]
    group_f = jnp.concatenate([jnp.ones((1,), bool), g_s[1:] != g_s[:-1]])
    kdiff = jnp.zeros((max(m - 1, 0),), bool)
    for ks in out[1:-1]:
        kdiff = kdiff | (ks[1:] != ks[:-1])
    run_f = group_f | jnp.concatenate([jnp.ones((min(m, 1),), bool), kdiff])
    ghead = jax.lax.cummax(jnp.where(group_f, j, -1))
    rhead = jax.lax.cummax(jnp.where(run_f, j, -1))
    valid = g_s != sent
    slot = jnp.where(valid, g_s + (j - ghead), n)
    new_g = jnp.where(valid, g_s + (rhead - ghead), sent)
    rank = rank.at[jnp.where(valid, pos_s, n)].set(new_g, mode="drop")
    sa = sa.at[slot].set(pos_s, mode="drop")
    nxt_rhead = jnp.concatenate([rhead[1:], jnp.full((1,), -1, idx)])
    tied = valid & ((rhead != j) | (nxt_rhead == rhead))
    count = jnp.sum(tied.astype(idx))
    g_next = jnp.where(tied, new_g, sent)
    pos_next = jnp.where(tied, pos_s, n)
    return g_next, pos_next, rank, sa, count


def _shrink(g, pos, m2: int):
    """Re-compact level-1 arrays into level-2 capacity (pads sort last).

    Caller guarantees the live (non-pad) count is <= m2; resolved entries
    were already blanked to (sent, n) pads by `_compact_round`.
    """
    with jax.named_scope("shrink_sort"):
        g2, p2 = jax.lax.sort((g, pos), num_keys=2)
    return g2[:m2], p2[:m2]


@partial(jax.jit, static_argnames=("idx", "depth", "levels", "fan",
                                   "extract", "adaptive"))
def build_with_isa(text: jnp.ndarray, idx=_I32, depth: int = 24,
                   levels: tuple = (4, 16, 64, 512), fan: int = 4,
                   extract: str = "auto", adaptive: bool = True):
    """Jittable fused SA construction. Returns (sa, isa) `idx`-typed [n].

    One device program: a `depth`-byte initial sort, full doubling rounds
    in a while_loop only while more than n/levels[0] positions stay tied,
    then a cascade of compaction levels with capacities n/levels[i]
    (Larsson-Sadakane re-expressed; default n/4 -> n/32 -> n/256): each
    level's rounds run only while the tied count exceeds the next
    level's capacity, so round cost tracks the actual tied population
    instead of the first level's worst case. On text-like input the
    full-round loop never executes and rounds start at the deepest level
    that fits, so the build is one deep sort + one rank scatter + one
    extraction + small compacted rounds. `isa` (the final head-slot
    ranks = inverse suffix array) comes for free and feeds verification
    and LCP work.
    """
    n = text.shape[0]
    if depth % 4 or depth < 4:
        raise ValueError("depth must be a positive multiple of 4")
    if fan < 2:
        # fan=1 would make h_n == h so the while_loops never advance
        raise ValueError("fan must be >= 2")
    sa_s0, rank_s0, count0 = _initial_sorted(text, idx, depth)
    h0 = jnp.minimum(jnp.asarray(depth, idx), jnp.asarray(n, idx))
    return _refine(sa_s0, rank_s0, count0, h0, idx, levels, fan,
                   extract, adaptive, want_isa=True)


@partial(jax.jit, static_argnames=("idx", "depth", "levels", "fan",
                                   "extract", "adaptive"))
def build_sa(text: jnp.ndarray, idx=_I32, depth: int = 24,
             levels: tuple = (4, 16, 64, 512), fan: int = 4,
             extract: str = "auto", adaptive: bool = True):
    """`build_with_isa` without the ISA: skips the final inverse-
    permutation sort when the build resolves inside the full-round loop
    (the common case on text: one full-width sort fewer). The headline
    `sort()` path uses this."""
    n = text.shape[0]
    if depth % 4 or depth < 4:
        raise ValueError("depth must be a positive multiple of 4")
    if fan < 2:
        raise ValueError("fan must be >= 2")
    sa_s0, rank_s0, count0 = _initial_sorted(text, idx, depth)
    h0 = jnp.minimum(jnp.asarray(depth, idx), jnp.asarray(n, idx))
    sa, _ = _refine(sa_s0, rank_s0, count0, h0, idx, levels, fan,
                    extract, adaptive, want_isa=False)
    return sa


def _refine(sa_s0, rank_s0, count0, h0, idx, levels, fan,
            extract: str = "auto", adaptive: bool = True,
            want_isa: bool = True):
    """Doubling rounds + cascaded compaction from a sorted initial state.

    The post-initial-sort core of `build_with_isa`, shared with the
    int-sequence build (`build_ints_with_isa`) that the B*-reduction
    engine runs on its reduced string. Returns (sa, isa_or_alias).

    LAZY INVERTS: the state between rounds is sorted-order only
    (sa_s, rank_s); each full round inverts its predecessor's ranks to
    text order just before the shifted-key fetch. A build that resolves
    inside the full-round loop therefore never pays the final
    inverse-permutation sort unless `want_isa` (one full-width pass
    fewer; with want_isa=False the second return value is an alias of
    `sa`).

    `extract` = "sort" | "topk" | "auto": auto picks top_k only for
    capacities <= n/32 and the full-width sort above. The n/32 threshold
    was chosen on the original accelerator, not yet measured on the H100
    (`harness/microbench.py extract`).
    """
    n = sa_s0.shape[0]
    n_i = jnp.asarray(n, idx)
    caps = [max(min(n, max(n // d, 64)), 1) for d in levels]
    # enforce non-increasing capacities after the n/64-floor clamps
    for i in range(1, len(caps)):
        caps[i] = min(caps[i], caps[i - 1])

    def cond1(st):
        _sa_s, _rank_s, h, count = st
        # no `h < n` guard: conflated initial ranks (raw-byte zero pad)
        # mean short suffixes may need the h == n marker round to split;
        # that round always zeroes the count, so this terminates
        return count > caps[0]

    def body1(st):
        sa_s, rank_s, h, _count = st
        rank = _scatter_to_text_order(sa_s, rank_s)  # predecessor's invert
        sa_s, rank_s, count = _full_round_sorted(rank, h, idx, fan)
        h_n = jnp.minimum(jnp.minimum(h, n_i // fan + 1) * fan, n_i)
        return sa_s, rank_s, h_n, count

    sa_s, rank_s, h, count = jax.lax.while_loop(
        cond1, body1, (sa_s0, rank_s0, h0, count0)
    )

    def resolved(args):
        sa_s, rank_s, _h, _count = args
        if want_isa:
            return sa_s, _scatter_to_text_order(sa_s, rank_s)
        return sa_s, sa_s

    def compact_tail(args):
        sa_s, rank_s, h, count = args
        # the compact rounds' shifted-key gathers read text-order ranks
        rank = _scatter_to_text_order(sa_s, rank_s)

        def body(st):
            g, pos, rank, sa, h, _count = st
            g, pos, rank, sa, count = _compact_round(
                g, pos, rank, sa, h, idx, fan
            )
            h_n = jnp.minimum(jnp.minimum(h, n_i // fan + 1) * fan, n_i)
            return g, pos, rank, sa, h_n, count

        def pyramid(i, args):
            """Extract at level i's capacity, then run levels i..deepest."""
            rank, sa, rank_s, h, count = args
            method = extract
            if method == "auto":
                method = "topk" if caps[i] * 32 <= n else "sort"
            g, pos = _extract(rank_s, sa, caps[i], idx, method)
            for nxt in caps[i + 1:]:
                def cond_level(st, nxt=nxt):
                    return st[5] > nxt

                g, pos, rank, sa, h, count = jax.lax.while_loop(
                    cond_level, body, (g, pos, rank, sa, h, count)
                )
                g, pos = _shrink(g, pos, nxt)

            def cond_last(st):
                return st[5] > 0

            _g, _pos, rank, sa, _h, _count = jax.lax.while_loop(
                cond_last, body, (g, pos, rank, sa, h, count)
            )
            return sa, rank

        args = (rank, sa_s, rank_s, h, count)
        if not adaptive or len(caps) == 1:
            return pyramid(0, args)
        # adaptive entry: extract straight into the deepest level whose
        # capacity holds the live tied count, skipping the shallower
        # extract + shrink passes entirely (count <= caps[0] is the
        # full-round loop's exit condition, so sel >= 0).
        sel = sum(
            (count <= jnp.asarray(c, idx)).astype(jnp.int32) for c in caps
        ) - 1
        return jax.lax.switch(
            sel, [partial(pyramid, i) for i in range(len(caps))], args
        )

    return jax.lax.cond(
        count == 0, resolved, compact_tail, (sa_s, rank_s, h, count)
    )


@partial(jax.jit, static_argnames=("idx", "depth", "levels", "fan",
                                   "extract", "adaptive"))
def build_ints_with_isa(seq: jnp.ndarray, idx=_I32, depth: int = 4,
                        levels: tuple = (4, 32, 256), fan: int = 4,
                        extract: str = "auto", adaptive: bool = True):
    """SA of an `idx`-typed integer sequence. Returns (sa, isa), [n] each.

    The doubling engine generalized from u8 text to an arbitrary integer
    alphabet — the reduced-string solver for the B*-reduction engine
    (`engines/bstar.py`), playing the role trsort plays on divsufsort's
    reduced B* problem (ref: crates/divsufsort/src/trsort.rs:1347-1411,
    which likewise refines integer ranks, not bytes). Unlike the u8
    build's zero-padded packed keys, the initial keys here are exact:
    key t of element i is seq[i+t], or the past-the-end marker -(i+1)
    (via `_shift_ranks`), so initial ranks are exact depth-`depth`
    classes and no marker-repair rounds are needed.

    `seq` values may be any idx-typed integers (negative allowed); only
    their relative order matters.
    """
    n = seq.shape[0]
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if fan < 2:
        raise ValueError("fan must be >= 2")
    if n == 0:
        return seq, seq
    seq = seq.astype(idx)
    # the past-the-end markers -(i+1) used by _shift_ranks must sort
    # below every real value, so bias the sequence to be non-negative
    # (requires max(seq) - min(seq) < idx range, true for the name
    # alphabets this is built for)
    seq = seq - jnp.min(seq)
    j = jnp.arange(n, dtype=idx)
    keys = (seq,) + tuple(
        _shift_ranks(seq, jnp.asarray(t, idx)) for t in range(1, depth)
    )
    with jax.named_scope("initial_sort"):
        out = jax.lax.sort(keys + (j,), num_keys=depth)
    sa_s0, rank_s0, count0 = _ranks_sorted_only(out, idx)
    h0 = jnp.minimum(jnp.asarray(depth, idx), jnp.asarray(n, idx))
    return _refine(sa_s0, rank_s0, count0, h0, idx, levels, fan,
                   extract, adaptive, want_isa=True)


def build_adaptive(text: jnp.ndarray):
    """Back-compat alias: the fused build IS the adaptive build now."""
    return build_with_isa(text)


# ---------------------------------------------------------------------------
# traced build (separate, host-stepped path used by `crosscheck --trace`)
# ---------------------------------------------------------------------------


_TRACE_DEPTH = 8  # shallow initial so traces show the doubling rounds


@jax.jit
def _initial_rank_jit(text):
    rank, sa_s, _rank_s, count = _initial_full(text, depth=_TRACE_DEPTH)
    return rank, sa_s, count == 0


@jax.jit
def _round_jit(rank, h):
    rank, sa_s, _rank_s, count = _full_round(rank, h)
    return rank, sa_s, count == 0


def sort_traced(text, tracer) -> "SuffixArray":
    """Traced build: host-stepped doubling rounds with per-phase dumps.

    The tracing analog of the reference's crosscheck-feature build
    (ref: crates/divsufsort/src/crosscheck.rs; trace calls threaded through
    phases, e.g. divsufsort.rs:177,190). The fast path (`sort`) carries no
    tracing code at all — tracing selects this separate execution path.
    """
    arr = as_text_array(text)
    n = int(arr.shape[0])
    tracer.log(f"doubling engine n={n}")
    if n < 3:
        sa = sort(arr)
        tracer.dump("SA final", sa.sa)
        tracer.flush()
        return sa
    rank, sa, done = _initial_rank_jit(arr)
    tracer.dump(f"rank h={_TRACE_DEPTH} ({_TRACE_DEPTH}-byte radix)", rank)
    tracer.dump(f"SA h={_TRACE_DEPTH}", sa)
    h = _TRACE_DEPTH
    while not bool(done) and h < n:
        rank, sa, done = _round_jit(rank, jnp.int32(h))
        h *= 2
        tracer.log(f"round -> h={h} done={bool(done)}")
        tracer.dump(f"rank h={h}", rank)
        tracer.dump(f"SA h={h}", sa)
    tracer.dump("SA final", sa)
    tracer.flush()
    return SuffixArray(arr, sa)


def sort_in_place(text, sa_out: np.ndarray) -> None:
    """Fill a caller-provided int32 buffer (ref API shape:
    crates/divsufsort/src/lib.rs:20-22)."""
    np.copyto(sa_out, np.asarray(sort(text).sa))


def _auto_depth(n: int) -> int:
    """Initial-key depth: 12 bytes at every size.

    With lazy inverts, the fan-4 round resolves everything the initial
    leaves tied (tied@48B = 0 on enwik-class text), so deeper initials
    pay extra sort operands for ties the round resolves anyway. Chosen
    on the original accelerator, not yet measured on the H100
    (`harness/microbench.py sweep` compares depths)."""
    return 12


def sort(text) -> SuffixArray:
    """Build the suffix array of `text` on the default JAX device.

    Ref API: crates/divsufsort/src/lib.rs:25-29 `sort(text) -> SuffixArray`.
    Short inputs (n < 3) take host fast paths like the reference's n ∈
    {0,1,2} cases (ref: crates/divsufsort/src/divsufsort.rs:18-29).
    """
    arr = as_text_array(text)
    n = int(arr.shape[0])
    if n >= (1 << 31):
        raise ValueError("text length must be < 2^31 for the i32 index path")
    if n == 0:
        return SuffixArray(arr, np.zeros((0,), np.int32))
    if n == 1:
        return SuffixArray(arr, np.zeros((1,), np.int32))
    if n == 2:
        host = np.asarray(arr)
        # equal first bytes → the shorter suffix (position 1) sorts first
        sa = [0, 1] if host[0] < host[1] else [1, 0]
        return SuffixArray(arr, np.asarray(sa, np.int32))
    sa = build_sa(arr, depth=_auto_depth(n))
    return SuffixArray(arr, sa)
