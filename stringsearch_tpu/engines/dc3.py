"""DC3 (difference cover mod 3) SACA — the second in-framework engine.

Capability parity: the reference ships a naive, *incomplete* DC3
(ref: crates/dc3/src/lib.rs — "incomplete, exploratory", crates/dc3/README.md:4,
with its ordering test disabled at lib.rs:216-217). This implementation is a
complete, correct DC3 (Kärkkäinen–Sanders difference-cover recursion),
giving the framework a second independently-derived engine for
crosschecking against the doubling engine and the host oracle — the role
divsufsort-vs-cdivsufsort differential testing plays in the reference.

Data-parallel re-expression of the classic phases
(ref shapes: crates/dc3/src/lib.rs:15-39 radix_pass, :74-76 triple passes,
:78-100 naming, :116-127 mod-0 sort, :129-192 merge):
- the 3× LSB radix passes over triples become one multi-key `lax.sort`;
- lexicographic naming is a neighbor-diff + prefix-sum;
- the sequential two-pointer merge (leq2/leq3 compares) becomes two
  vectorized *binary-search cross-ranks*: every mod-0 suffix counts how
  many sample suffixes precede it (log2 rounds of the O(1) rank-based
  comparator) and vice versa, then one scatter builds the merged SA.
- recursion is host-driven (each level is a jitted program; levels shrink
  geometrically by 2/3).

All values int32; text bytes are biased +1 so 0 is the unique sentinel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from stringsearch_tpu.core.types import SuffixArray, as_text_array

_I32 = jnp.int32


def _lex3_less(a1, a2, a3, b1, b2, b3):
    """(a1,a2,a3) < (b1,b2,b3) lexicographically, elementwise."""
    return (a1 < b1) | (
        (a1 == b1) & ((a2 < b2) | ((a2 == b2) & (a3 < b3)))
    )


@partial(jax.jit, static_argnames=("n", "n0", "n02"))
def _sample_sort(tpad, n: int, n0: int, n02: int):
    """Sort sample (mod-1/mod-2) positions by their character triples.

    Returns (sorted sample positions [n02], names-in-R-layout [n02],
    num_names scalar). R layout: slot i//3 for i%3==1, slot n0 + i//3 for
    i%3==2 (the classic reduced-string arrangement).
    """
    lim = 3 * n0 + 1  # positions i < lim with i%3 != 0 number exactly n02
    mod1 = 1 + 3 * jnp.arange(n0, dtype=_I32)  # n0 of them: 1,4,...,3n0-2
    mod2 = 2 + 3 * jnp.arange(n02 - n0, dtype=_I32)
    s12 = jnp.concatenate([mod1, mod2])
    del lim
    n2 = n02 - n0

    def tri(c):
        """tpad[s12 + c] as two STRIDED SLICES instead of a gather —
        s12 is two arithmetic mod-3 sequences, so strided copies replace
        index-width gathers. Limits are the
        minimal covering values so they stay within tpad for every
        n % 3 (last element accessed is start + 3*(count-1) <= n + 2)."""
        a = jax.lax.slice(tpad, (1 + c,), (1 + c + 3 * (n0 - 1) + 1,), (3,))
        if n2 == 0:
            return a
        b = jax.lax.slice(tpad, (2 + c,), (2 + c + 3 * (n2 - 1) + 1,), (3,))
        return jnp.concatenate([a, b])

    k0, k1, k2 = tri(0), tri(1), tri(2)
    c0, c1, c2, pos = jax.lax.sort((k0, k1, k2, s12), num_keys=3)
    diff = (c0[1:] != c0[:-1]) | (c1[1:] != c1[:-1]) | (c2[1:] != c2[:-1])
    flags = jnp.concatenate([jnp.zeros((1,), _I32), diff.astype(_I32)])
    names_sorted = jnp.cumsum(flags)  # 0-based dense names in sorted order
    num_names = names_sorted[-1] + 1
    # scatter names into the reduced-string layout
    slot = jnp.where(pos % 3 == 1, pos // 3, n0 + pos // 3)
    r = jnp.zeros((n02,), _I32).at[slot].set(names_sorted)
    return pos, r, num_names


@partial(jax.jit, static_argnames=("n0",))
def _unrank_samples(sa_r, n0: int):
    """Map reduced-string SA entries back to text positions."""
    return jnp.where(sa_r < n0, 1 + 3 * sa_r, 2 + 3 * (sa_r - n0))


@partial(jax.jit, static_argnames=("n", "n0", "drop_pad", "steps0",
                                   "steps12", "byte_alpha"))
def _finish(tpad, sa12_all, n: int, n0: int, drop_pad: bool, steps0: int,
            steps12: int, byte_alpha: bool = False):
    """Rank samples, sort mod-0 suffixes, merge via binary-search cross-ranks."""
    # ranks: rank12[p] = 1-based rank of sample suffix at text position p
    npad = tpad.shape[0]
    n12 = sa12_all.shape[0] - (1 if drop_pad else 0)
    sa12 = sa12_all[1:] if drop_pad else sa12_all  # padding suffix sorts first
    rank12 = jnp.zeros((npad,), _I32).at[jnp.clip(sa12, 0, npad - 1)].set(
        1 + jnp.arange(n12, dtype=_I32)
    )

    # Per-position comparator components, built from SLICES (no gathers):
    # the DC3 case comparator at position p reads T[p], T[p+1],
    # rank12[p+1], rank12[p+2] (ref: crates/dc3/src/lib.rs:3-11
    # leq2/leq3). Precomputing these once turns each binary-search step
    # from ~8-10 index-width gathers (both sides' components re-fetched
    # per probe) into 5: one for arr[mid] + four component fetches at
    # midpos; the query side is fetched ONCE before the loop.
    z = jnp.zeros((2,), _I32)
    t1 = jnp.concatenate([tpad[1:].astype(_I32), z[:1]])
    r1 = jnp.concatenate([rank12[1:], z[:1]])
    r2 = jnp.concatenate([rank12[2:], z])
    t0c = tpad.astype(_I32)

    if byte_alpha and npad < (1 << 23):
        # Packed comparator keys — LEVEL-0 BYTE ALPHABET ONLY (values
        # are text bytes + 1 <= 256 = 9 bits; recursion levels carry
        # integer names that don't fit). With ranks < n12 + 1 < 2^23,
        # (T[p] - 256) << 23 | rank packs each case's decisive pair into
        # ONE sign-correct int32 whose integer order IS the
        # lexicographic order ((T-256) <= 0, low 23 bits clear, rank
        # non-negative). Per binary-search step this needs 3 index-width
        # gathers (arr[mid], pk1, pk2) instead of 5.
        pk1 = ((t0c - 256) << 23) | r1          # case mod-1: (T, r[p+1])
        pk2 = ((t1 - 256) << 23) | r2           # case mod-2: (T+1, r[p+2])
        # both keys ride as columns of one [npad, 2] array: a probe step
        # issues ONE row gather instead of two element gathers
        pk = jnp.stack([pk1, pk2], axis=1)

        def comp_at(pos):
            g = jnp.take(pk, pos, axis=0)
            return (g[:, 0], g[:, 1], pos % 3)

        def less_c(a, b):
            k1a, k2a, ma = a
            k1b, k2b, mb = b
            jm = jnp.where(ma == 0, mb, ma)  # the sample side's residue
            l1 = k1a < k1b
            ta, tb = k1a >> 23, k1b >> 23    # recover (T-256): monotone
            l2 = (ta < tb) | ((ta == tb) & (k2a < k2b))
            return jnp.where(jm == 1, l1, l2)
    else:
        comp = jnp.stack([t0c, t1, r1, r2], axis=1)  # [npad, 4]

        def comp_at(pos):
            """(T[p], T[p+1], rank[p+1], rank[p+2], p%3) at `pos` — one
            row gather for all four components."""
            g = jnp.take(comp, pos, axis=0)
            return (g[:, 0], g[:, 1], g[:, 2], g[:, 3], pos % 3)

        def less_c(a, b):
            """suffix at a < suffix at b from components; exactly one
            side is mod-0 and the other a sample — the sample's residue
            picks the comparison depth."""
            ta, t1a, r1a, r2a, ma = a
            tb, t1b, r1b, r2b, mb = b
            jm = jnp.where(ma == 0, mb, ma)
            l1 = (ta < tb) | ((ta == tb) & (r1a < r1b))
            l2 = _lex3_less(ta, t1a, r2a, tb, t1b, r2b)
            return jnp.where(jm == 1, l1, l2)

    # mod-0 suffixes sorted by (first char, rank of following sample suffix)
    s0 = 3 * jnp.arange(n0, dtype=_I32)
    c = jnp.take(t0c, s0)
    r = jnp.take(r1, s0)
    _c, _r, sa0 = jax.lax.sort((c, r, s0), num_keys=2)

    def count_less(queries, arr, steps, query_is_mod0):
        """#elements of sorted-suffix-position array `arr` strictly less
        than each query suffix, by vectorized binary search."""
        m = arr.shape[0]
        q = comp_at(queries)  # fetched once, reused every step
        lo = jnp.zeros(queries.shape, _I32)
        hi = jnp.full(queries.shape, m, _I32)

        def body(_, state):
            lo, hi = state
            mid = (lo + hi) // 2
            midpos = jnp.take(arr, jnp.clip(mid, 0, m - 1))
            a = comp_at(midpos)
            # suffixes are never equal, so arr[mid] < q ⟺ ¬(q < arr[mid])
            if query_is_mod0:
                arr_less = ~less_c(q, a)  # arr = samples
            else:
                arr_less = less_c(a, q)  # arr = mod-0 suffixes
            active = lo < hi
            lo = jnp.where(active & arr_less, mid + 1, lo)
            hi = jnp.where(active & (~arr_less), mid, hi)
            return lo, hi

        lo, _ = jax.lax.fori_loop(0, steps, body, (lo, hi))
        return lo

    # positions in the merged SA
    pos0 = jnp.arange(n0, dtype=_I32) + count_less(sa0, sa12, steps12, True)
    pos12 = jnp.arange(n12, dtype=_I32) + count_less(sa12, sa0, steps0, False)
    out_n = n0 + n12  # == n (+1 if the text itself had a padding slot)
    sa = jnp.zeros((out_n,), _I32)
    sa = sa.at[pos0].set(sa0)
    sa = sa.at[pos12].set(sa12)
    return sa


def _ceil_log2(x: int) -> int:
    return max(1, int(x - 1).bit_length()) if x > 1 else 1


def _reduced_size(v: int) -> int:
    """n02 of a level of size v: (v+2)//3 mod-0 slots + v//3 mod-2 slots."""
    return (v + 2) // 3 + v // 3


def _build_buckets(limit: int = 1 << 31) -> list[int]:
    """Size buckets spaced so that each bucket's reduced string fits in the
    previous bucket: b_{k+1} = max v with n02(v) <= b_k (ratio ~1.5).
    Guarantees the padded recursion strictly shrinks."""
    buckets = [4]
    while buckets[-1] < limit:
        b = buckets[-1]
        # largest v with (v+2)//3 + v//3 <= b; n02 is monotone, step search
        v = (3 * b) // 2
        while _reduced_size(v + 1) <= b:
            v += 1
        while _reduced_size(v) > b:
            v -= 1
        buckets.append(v)
    return buckets


_BUCKETS = _build_buckets()

#: below this padded size, recursion LEVELS >= 1 solve the reduced string
#: with the generalized int-alphabet doubling core in ONE fused dispatch
#: instead of ~log1.5 further host-driven dc3 levels. The cost
#: concentrates in the BIG levels' binary-search merges (steps x n-width
#: gathers), not the dispatch-bound deep tail, so the threshold hands off
#: the whole reduced problem right below the top level. Chosen on the
#: original accelerator, not yet measured on the H100. Level 0 never
#: takes the shortcut: every dc3 run exercises the real
#: sample/naming/merge machinery on the actual input, which is the
#: differential-testing point of this engine.
_SOLVE_THRESHOLD = 1 << 22


def _tail_solve_enabled() -> bool:
    """The tail solve hands levels >= 1 to the shared doubling core, so a
    doubling bug would escape dc3-vs-doubling differential testing below
    level 0 (fuzz still catches it vs the C oracle). Set
    STRINGSEARCH_TPU_DC3_FULL=1 to force the full independent recursion
    (crosscheck/differential runs)."""
    import os

    return not os.environ.get("STRINGSEARCH_TPU_DC3_FULL")


def _dc3(t: jnp.ndarray, tracer=None, level: int = 0,
         byte_alpha: bool = False) -> jnp.ndarray:
    """Suffix array of int32 array `t` (values >= 1; 0 is reserved).

    Pads to the next size bucket with sentinel zeros before running the
    core. Pad suffixes (all-sentinel) sort strictly first — real values are
    >= 1 — and appending a strictly-smaller character preserves the
    relative order of all real suffixes, so the real SA is the tail slice.
    This collapses jit shapes to ~log1.5(n) families across all inputs and
    recursion levels, and the bucket construction guarantees each
    recursion level is strictly smaller.
    """
    n = int(t.shape[0])
    if n <= 3:
        host = np.asarray(t)
        order = sorted(range(n), key=lambda i: host[i:].tolist())
        return jnp.asarray(order, dtype=_I32)
    import bisect

    m = _BUCKETS[bisect.bisect_left(_BUCKETS, n)]
    if level > 0 and m <= _SOLVE_THRESHOLD and _tail_solve_enabled():
        # one-dispatch tail solve (ref recursion being cut:
        # crates/dc3/src/lib.rs:103-114). Bucket-padding first keeps the
        # solver's compiled-shape families identical to the dc3 levels'.
        from stringsearch_tpu.engines.doubling import build_ints_with_isa

        if m > n:
            t = jnp.concatenate([t, jnp.zeros((m - n,), _I32)])
        if tracer is not None:
            tracer.log(f"level {level}: n={n} -> int-doubling tail solve")
        sa, _isa = build_ints_with_isa(t)
        return sa[m - n :]
    if m > n:
        t = jnp.concatenate([t, jnp.zeros((m - n,), _I32)])
        return _dc3_core(t, tracer, level, byte_alpha)[m - n :]
    return _dc3_core(t, tracer, level, byte_alpha)


def _dc3_core(t: jnp.ndarray, tracer=None, level: int = 0,
              byte_alpha: bool = False) -> jnp.ndarray:
    n = int(t.shape[0])
    if n <= 3:
        host = np.asarray(t)
        order = sorted(range(n), key=lambda i: host[i:].tolist())
        return jnp.asarray(order, dtype=_I32)

    n0 = (n + 2) // 3
    n1 = (n + 1) // 3
    n2 = n // 3
    n02 = n0 + n2
    drop_pad = n0 != n1  # n % 3 == 1: sample set includes padding position n

    tpad = jnp.concatenate([t, jnp.zeros((3,), _I32)])
    pos_sorted, r, num_names = _sample_sort(tpad, n, n0, n02)
    if tracer is not None:
        tracer.log(f"level {level}: n={n} n02={n02} names={int(num_names)}")
        tracer.dump(f"L{level} sample order", pos_sorted)
        tracer.dump(f"L{level} names", r)

    if int(num_names) < n02:
        # recurse on the reduced string (values +1 keep 0 as sentinel)
        sa_r = _dc3(r + 1, tracer, level + 1)
        sa12_all = _unrank_samples(sa_r, n0)
    else:
        sa12_all = pos_sorted
    if tracer is not None:
        tracer.dump(f"L{level} SA12", sa12_all)

    steps0 = _ceil_log2(n0 + 1) + 1
    n12 = n02 - (1 if drop_pad else 0)
    steps12 = _ceil_log2(n12 + 1) + 1
    sa = _finish(tpad, sa12_all, n, n0, drop_pad, steps0, steps12,
                 byte_alpha=byte_alpha)
    if tracer is not None:
        tracer.dump(f"L{level} SA (merged)", sa)
    return sa


def sort(text) -> SuffixArray:
    """Build the suffix array with DC3 (engine-shaped API)."""
    arr = as_text_array(text)
    n = int(arr.shape[0])
    if n == 0:
        return SuffixArray(arr, np.zeros((0,), np.int32))
    sa = _dc3(arr.astype(_I32) + 1, byte_alpha=True)
    return SuffixArray(arr, sa)


def sort_traced(text, tracer) -> SuffixArray:
    """Traced DC3 build: per-recursion-level phase dumps (sample order,
    names, sample SA, merged SA), diffable against the other engines'
    traces — the trace analog the reference threads through every phase
    (ref: crates/divsufsort/src/crosscheck.rs)."""
    arr = as_text_array(text)
    n = int(arr.shape[0])
    tracer.log(f"dc3 engine n={n}")
    if n == 0:
        sa = np.zeros((0,), np.int32)
    else:
        sa = _dc3(arr.astype(_I32) + 1, tracer, 0, byte_alpha=True)
    tracer.dump("SA final", sa)
    tracer.flush()
    return SuffixArray(arr, sa)
