"""divsufsort-structured SACA: B*-reduction + data-parallel induction.

This is the data-parallel re-expression of the reference's speed-critical
structure (SURVEY §7 step 5): instead of hard-sorting all n suffixes
(engines/doubling.py), only the ~n/3 B* suffixes are sorted via a
reduced-string problem, and the order of every other suffix is *derived*
from them — the role of divsufsort's `sort_typeBstar`
(ref: crates/divsufsort/src/divsufsort.rs:45-354) and `construct_SA`
(ref: crates/divsufsort/src/divsufsort.rs:356-451). Every phase is
re-designed as data-parallel primitives; nothing is a translation of the
reference's sequential scans.

Definitions (matching the reference's right-to-left classification,
ref: divsufsort.rs:64-121):
  * suffix i is type B iff suffix(i) < suffix(i+1), type A otherwise
    (equal leading chars inherit the right neighbor's type; suffix n-1
    is type A);
  * a maximal equal-char segment has uniform type, so the text is an
    alternating sequence of A-runs and B-runs of whole segments;
  * B* = a type-B suffix whose right neighbor is type A = the LAST
    position of each B-run (marked at the A-loop exit in the reference
    scan, divsufsort.rs:88-96). m = #B* <= n/2, typically ~n/3.

Pipeline (each step a batch of vectorized scans/sorts, fused under jit):

  1. classify — one reverse cummin scan yields per-position segment end,
     type, and B* flags (the scan at divsufsort.rs:64-121 re-expressed).
  2. extract + name B* substrings — the B* substring of p_k is the
     window T[p_k .. p_{k+1}+2) (exactly ss_compare's bound
     U1n = PA[p1+1]+2, ref: crates/divsufsort/src/sssort.rs:102-134,
     with window-exhausted-first = smaller). Names are assigned by one
     multi-key sort over masked packed byte windows with a
     window-length tiebreak, plus extension rounds for windows longer
     than the static prefix; equal names <=> identical substrings.
     Correctness of the +2 overhang (why shorter-window-prefix =>
     smaller *suffix*): if window_i is a proper prefix of window_j,
     the byte equality through offset d+1 (d = p_{i+1}-p_i) forces
     T[d] < T[d+1] inside the shared bytes, so position p_j+d is also
     type B; p_{i+1}+1 is type A (B* def) while p_j+d+1 is type B, and
     at equal first char an A-suffix precedes every B-suffix — hence
     suffix(p_i) < suffix(p_j). This is the invariant the vendored
     "Dismantling DivSufSort" paper formalizes for sssort's bounded
     compare.
  3. reduced SA — the names in text order form the reduced string; its
     suffix array = the sorted B* suffixes (solved by
     doubling.build_ints_with_isa, the trsort analog). The reduced
     string is padded to a static n/2+1 capacity with distinct negative
     sentinels that sort first and are sliced away (static shapes under
     jit; the pad tail also supplies exact past-the-real-end behavior,
     see `_name_and_rank`).
  4. induce B — every type-B suffix's order is derived from the sorted
     B* by ONE multi-key sort over "hop keys" plus rare doubling
     refinement rounds, replacing construct_SA's right-to-left scan
     (ref: divsufsort.rs:366-412). Key fact: a B suffix's chain of
     equal-char segments runs rightward to its B-run's end (the B*),
     and comparing two B suffixes reduces to comparing per-segment
     (char, run-length) hops until one chain exits into its terminal,
     where the B* rank decides. At equal char: longer segment = smaller
     suffix; an A-type target precedes a B-type target (the bucket fact
     divsufsort's layout encodes, see the "B* is smaller" note at
     divsufsort.rs:123-124).
  5. induce A — the mirror image (left-to-right scan at
     divsufsort.rs:414-450): chains of equal-char segments run
     rightward through A-runs into the next B-run start, whose induced
     B order decides; at equal char shorter segment = smaller suffix,
     and B-type targets follow A-type ones.
  6. assemble — final slots from per-char A/B counts (the bucket
     start/end arithmetic of divsufsort.rs:127-142 re-expressed as
     searchsorted over the two sorted sequences) + one scatter.

Index dtype: int32 (n < 2^31) like the reference's Idx
(ref: crates/divsufsort/src/common.rs:4); idx=jnp.int64 for the 64-bit
mode.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from stringsearch_tpu.core.types import SuffixArray, as_text_array
from stringsearch_tpu.engines.doubling import (
    _heads_and_tied,
    _ranks_sorted_only,
    _refine,
    _shift_ranks,
)

_I32 = jnp.int32


def _sent(idx) -> jnp.ndarray:
    return jnp.asarray(np.iinfo(np.dtype(idx)).max, idx)


# ---------------------------------------------------------------------------
# 1. classification
# ---------------------------------------------------------------------------


def _classify(text: jnp.ndarray, idx=_I32):
    """Segment/type/B* arrays from one reverse scan.

    Returns (seg_end, type_b, bstar):
      seg_end[i]: last index of i's maximal equal-char segment
      type_b[i]:  suffix(i) < suffix(i+1)  (suffix n-1: False/type A)
      bstar[i]:   type_b[i] and suffix(i+1) is type A

    Re-expresses the right-to-left classify scan
    (ref: crates/divsufsort/src/divsufsort.rs:64-121): the type of i is
    decided by the first character inequality at or after i, which a
    reverse cummin over per-change packed (index, rising) keys fills in
    one pass.
    """
    n = text.shape[0]
    u = jnp.uint64 if np.dtype(idx) == np.int64 else jnp.uint32
    j = jnp.arange(n, dtype=u)
    change = jnp.concatenate(
        [text[:-1] != text[1:], jnp.ones((min(n, 1),), bool)]
    )
    rises = jnp.concatenate(
        [text[:-1] < text[1:], jnp.zeros((min(n, 1),), bool)]
    )
    key = jnp.where(change, (j << 1) | rises.astype(u),
                    jnp.asarray(np.iinfo(np.dtype(u)).max, u))
    filled = jnp.flip(jax.lax.cummin(jnp.flip(key)))
    seg_end = (filled >> 1).astype(idx)
    type_b = (filled & 1).astype(bool)
    tb_next = jnp.concatenate([type_b[1:], jnp.zeros((min(n, 1),), bool)])
    bstar = type_b & change & ~tb_next
    return seg_end, type_b, bstar


# ---------------------------------------------------------------------------
# 2. B* extraction + substring naming
# ---------------------------------------------------------------------------


def _pack_all4(text: jnp.ndarray) -> jnp.ndarray:
    """u32[i] = bytes i..i+3 big-endian, zero past the end (all i)."""
    n = text.shape[0]
    t = jnp.concatenate([text.astype(jnp.uint32),
                         jnp.zeros((4,), jnp.uint32)])
    return ((t[0:n] << 24) | (t[1:n + 1] << 16)
            | (t[2:n + 2] << 8) | t[3:n + 3])


def _extract_bstar(bstar: jnp.ndarray, idx=_I32):
    """Compact B* positions into a static n//2+1 array (ascending; pads
    = n at the tail) via one 1-key sort. Returns (p, m)."""
    n = bstar.shape[0]
    cap = n // 2 + 1
    j = jnp.arange(n, dtype=idx)
    key = jnp.where(bstar, j, _sent(idx))
    ks = jax.lax.sort((key,), num_keys=1)[0]
    p = jnp.where(ks[:cap] == _sent(idx), n, ks[:cap])
    m = jnp.sum(bstar.astype(idx))
    return p, m


def _window_words(p4: jnp.ndarray, p, wlen, offset: int, nwords: int, n):
    """`nwords` masked u32 window words for bytes [offset, offset+4*nwords)
    of each window, plus the capped remaining-length tiebreak word.

    Bytes at or past each window's end are masked to 0; 0 <= any byte,
    so masked-equal + equal capped length <=> equal within this span,
    and the shorter window sorts first (the ss_compare exhausted-first
    rule, ref: crates/divsufsort/src/sssort.rs:120-131).
    """
    words = []
    for t in range(nwords):
        off = offset + 4 * t
        q = jnp.clip(p + off, 0, n - 1)
        w = jnp.take(p4, q)
        nb = jnp.clip(wlen - off, 0, 4).astype(jnp.uint32)
        mask = jnp.where(
            nb == 0, jnp.uint32(0),
            (~jnp.uint32(0)) << ((4 - nb) << 3),
        )
        words.append(w & mask)
    span = offset + 4 * nwords
    lenk = jnp.clip(wlen - offset, 0, span - offset)
    return words, lenk


def _name_and_rank(text, p, m, idx=_I32, w0_words: int = 4,
                   ext_words: int = 4):
    """Name the B* substrings; returns the padded reduced string R.

    R[k] (k < m) = head-slot name of the k-th B* substring, equal names
    <=> identical windows; R[k] (k >= m) = k - cap < 0, distinct
    negative pads that (a) sort the pad elements first in the reduced
    build and (b) give real reduced suffixes exact end-of-string
    behavior (the first pad value any comparison reads is below every
    real name, so a shorter reduced suffix with an equal prefix sorts
    first).
    """
    n = text.shape[0]
    cap = p.shape[0]
    p4 = _pack_all4(text)
    k = jnp.arange(cap, dtype=idx)
    valid = p < n
    nxt = jnp.concatenate([p[1:], jnp.full((1,), n, idx)])
    wlen = jnp.where(valid,
                     jnp.where(nxt < n, nxt + 2 - p, jnp.asarray(n, idx) - p),
                     0)
    words, lenk = _window_words(p4, p, wlen, 0, w0_words, n)
    big = _sent(idx)
    # pads sort last: all-ones words + max length key
    words = [jnp.where(valid, w, ~jnp.uint32(0)) for w in words]
    lenk = jnp.where(valid, lenk, big)
    out = jax.lax.sort(tuple(words) + (lenk, k), num_keys=w0_words + 1)
    k_s = out[-1]
    eq = jnp.ones((cap - 1,), bool)
    for ws in out[:-1]:
        eq = eq & (ws[1:] == ws[:-1])
    new_flag = jnp.concatenate([jnp.ones((min(cap, 1),), bool), ~eq])
    head = jax.lax.cummax(jnp.where(new_flag, k, jnp.asarray(-1, idx)))
    # unresolved: equal so far AND either side's window extends past the
    # compared span (spuriously equal due to the length cap)
    span = 4 * w0_words
    wl_s = jnp.take(wlen, k_s)
    capped = wl_s > span
    unres = jnp.concatenate(
        [jnp.zeros((min(cap, 1),), bool), eq & (capped[1:] | capped[:-1])]
    )
    # groups where ANY adjacent pair is unresolved must extend as a
    # whole (group members beyond the pair may resolve against them)
    live = jnp.sum(unres.astype(idx))

    def _ext_stage(ext_w: int, max_rounds, st):
        """Extension rounds at a static window width of `ext_w` words.

        Widths must be static (sort operand shapes), so geometric growth
        is expressed as a chain of stages: each stage's while_loop runs
        at most `max_rounds` rounds (None = until resolved) at 4*ext_w
        bytes per round. The chain 1x/2x/4x then unbounded 8x bounds the
        round count on long-common-prefix B* windows at
        ~3 + max_window/(32*ext_words) instead of max_window/(4*ext_words)
        full sorts, without unbounded operand counts.
        """

        def cond(s):
            ok = s[0] > 0
            if max_rounds is not None:
                ok = ok & (s[4] < max_rounds)
            return ok

        def body(s):
            _live, offset, head, k_s, r = s
            p_s = jnp.take(p, k_s)
            wl_s = jnp.take(wlen, k_s)
            words, lenk = _window_words(p4, p_s, wl_s, offset, ext_w, n)
            out = jax.lax.sort((head,) + tuple(words) + (lenk, k_s),
                              num_keys=1 + ext_w + 1)
            head_old, k_s = out[0], out[-1]
            eq = head_old[1:] == head_old[:-1]
            for ws in out[1:-1]:
                eq = eq & (ws[1:] == ws[:-1])
            new_flag = jnp.concatenate(
                [jnp.ones((min(cap, 1),), bool), ~eq])
            head = jax.lax.cummax(
                jnp.where(new_flag, k, jnp.asarray(-1, idx)))
            wl_s = jnp.take(wlen, k_s)
            capped = wl_s > offset + 4 * ext_w
            unres = jnp.concatenate(
                [jnp.zeros((min(cap, 1),), bool),
                 eq & (capped[1:] | capped[:-1])]
            )
            return (jnp.sum(unres.astype(idx)), offset + 4 * ext_w,
                    head, k_s, r + 1)

        live, offset, head, k_s, _r = jax.lax.while_loop(
            cond, body, st + (jnp.asarray(0, idx),))
        return live, offset, head, k_s

    st = (live, jnp.asarray(span, idx), head, k_s)
    for ext_w, rounds in ((ext_words, 1), (2 * ext_words, 1),
                          (4 * ext_words, 1), (8 * ext_words, None)):
        st = _ext_stage(ext_w, rounds, st)
    _live, _off, head, k_s = st
    # names back to B*-index order (k_s is a permutation of 0..cap)
    _, name = jax.lax.sort((k_s, head), num_keys=1)
    return jnp.where(k < m, name, k - jnp.asarray(cap, idx))


# ---------------------------------------------------------------------------
# 4./5. induced phases
# ---------------------------------------------------------------------------


def _induce(elem_sel, w1, w2, nxt_arr, hops: int, idx=_I32):
    """Order the selected suffixes by hop keys + doubling refinement.

    elem_sel: bool[n] — which positions participate as elements;
    w1/w2:    per-position hop word pair (int32[n+1], sentinel slot n);
    nxt_arr:  per-position hop target (int32[n+1]; fixed point at
              terminals and at slot n).

    Returns (pos_sorted, rank_pos): pos_sorted[j] = position of the
    j-th smallest selected suffix (pads of unselected positions at the
    tail in unspecified order), and rank_pos[i] = head-slot rank of
    position i among the selected (garbage at unselected positions).

    The doubling refinement: after the hop-key sort, ranks are exact
    equivalence classes of the first `hops` hops; a round sorts tied
    entries by the continuation at their `hops`*2^r-hop jump target,
    doubling the exact depth. A jump target is either a still-selected
    position (continuation = its current in-phase rank, refining) or a
    terminal — an unselected position or the off-end slot — whose
    continuation is its exact (w1, w2) word pair; the leading w1 word
    keeps the two scales comparable (equal w1 implies equal parity,
    i.e. the same kind, so the second word is always compared within
    one scale). Jumps freeze at terminals; a jump must never be chased
    through an unselected position (its jump-table slot is pad
    garbage). This replaces construct_SA's sequential pop-place scans
    (ref: crates/divsufsort/src/divsufsort.rs:366-450) with one sort +
    O(log(max segments per run)) refinement rounds.
    """
    n = elem_sel.shape[0]
    j = jnp.arange(n, dtype=idx)
    big = _sent(idx)
    cur = jnp.where(elem_sel, j, jnp.asarray(n, idx))
    # FUSED ROW GATHERS (the dc3/unbwt trick, r4): gather cost is
    # index-count-dominated, so (w1, w2, nxt) ride as COLUMNS of one
    # [n+1, 3] array and each hop is ONE row gather instead of three
    # element gathers — 12 gathers -> 4 for the default hops=4.
    static_tbl = jnp.stack([w1, w2, nxt_arr], axis=1)  # [n+1, 3]
    keys = []
    for _t in range(hops):
        g = jnp.take(static_tbl, cur, axis=0)  # [n, 3]
        keys.append(g[:, 0])
        keys.append(g[:, 1])
        cur = g[:, 2]
    # unselected elements sort last
    keys[0] = jnp.where(elem_sel, keys[0], big)
    out = jax.lax.sort(tuple(keys) + (cur, j), num_keys=len(keys))
    jump_s, pos_s = out[-2], out[-1]
    nsel = jnp.sum(elem_sel.astype(idx))
    eq = jnp.ones((n - 1,), bool)
    for ks in out[:-2]:
        eq = eq & (ks[1:] == ks[:-1])
    new_flag = jnp.concatenate([jnp.ones((min(n, 1),), bool), ~eq])
    rank_s, tied = _heads_and_tied(new_flag, j)
    tied = tied & (j < nsel)
    count = jnp.sum(tied.astype(idx))

    def scat(pos_s, val_s):
        _, r = jax.lax.sort((pos_s, val_s), num_keys=1)
        return r

    sel_col = jnp.concatenate(
        [elem_sel.astype(idx), jnp.zeros((1,), idx)]
    )
    # loop-invariant columns of the refinement lookup table
    ref_static = jnp.stack([w1, w2, sel_col], axis=1)  # [n+1, 3]
    zero_pad = jnp.zeros((1,), idx)

    def cond(st):
        return st[0] > 0

    def body(st):
        """One refinement round = TWO sorts + ONE row gather (was three
        sorts + six element gathers before the r5 fusion):

        1. a single 1-key inverse sort by pos_s yields BOTH
           position-indexed tables (rank_pos for the continuation key,
           jump_pos for the jump doubling) — the old code paid one scat
           sort for each;
        2. one [n+1, 5] row gather at jump_s fetches
           (w1, w2, selected, rank_pos, jump_pos) per element;
        3. the doubled jump is computed ELEMENTWISE pre-sort and carried
           through the main sort as a payload — doubling commutes with
           the sort because it only reads position-indexed tables, which
           the sort does not change.
        """
        _c, rank_s, pos_s, jump_s = st
        _, rank_pos, jump_pos = jax.lax.sort(
            (pos_s, rank_s, jump_s), num_keys=1
        )
        tbl = jnp.concatenate(
            [
                ref_static,
                jnp.concatenate([rank_pos, zero_pad])[:, None],
                jnp.concatenate([jump_pos, zero_pad])[:, None],
            ],
            axis=1,
        )  # [n+1, 5]; slot n: sel=0 so the pads are never consulted
        g = jnp.take(tbl, jump_s, axis=0)  # [n, 5]
        jsel = g[:, 2] != 0
        k1 = g[:, 0]
        k2 = jnp.where(jsel, g[:, 3], g[:, 1])
        jump2 = jnp.where(jsel, g[:, 4], jump_s)  # doubled; frozen at
        # terminals (unselected / off-end targets keep their jump)
        out = jax.lax.sort((rank_s, k1, k2, jump2, pos_s), num_keys=3)
        jump_s, pos_s = out[-2], out[-1]
        eqr = jnp.ones((max(n - 1, 0),), bool)
        for ks in out[:3]:
            eqr = eqr & (ks[1:] == ks[:-1])
        new_flag = jnp.concatenate([jnp.ones((min(n, 1),), bool), ~eqr])
        rank_s, tied = _heads_and_tied(new_flag, j)
        tied = tied & (j < nsel)
        return jnp.sum(tied.astype(idx)), rank_s, pos_s, jump_s

    _c, rank_s, pos_s, _jump_s = jax.lax.while_loop(
        cond, body, (count, rank_s, pos_s, jump_s)
    )
    rank_pos = scat(pos_s, rank_s)
    return pos_s, rank_pos, nsel


# ---------------------------------------------------------------------------
# full build
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("idx", "hops", "red_depth", "red_fan",
                                   "red_levels", "w0_words"))
def build(text: jnp.ndarray, idx=_I32, hops: int = 4, red_depth: int = 6,
          red_fan: int = 4, red_levels: tuple = (4, 32, 256),
          w0_words: int = 4):
    """Fused B*-reduction SA construction. Returns (sa, isa), [n] each."""
    n = text.shape[0]
    if n < 3:
        raise ValueError("build requires n >= 3 (host fast paths cover less)")
    n_i = jnp.asarray(n, idx)
    big = _sent(idx)
    j = jnp.arange(n, dtype=idx)
    seg_end, type_b, bstar = _classify(text, idx)
    seg_len = seg_end - j + 1
    char = text.astype(idx)

    # --- sorted B* via the reduced problem -------------------------------
    p, m = _extract_bstar(bstar, idx)
    red = _name_and_rank(text, p, m, idx, w0_words=w0_words)
    sa_red, isa_red = _redsolve(red, idx, red_depth, red_levels, red_fan)
    # rank of each B* among B* (order-isomorphic values suffice): the
    # reduced ISA directly; spread to text positions
    bsr_pos = jnp.full((n + 1,), -1, idx)
    bsr_pos = bsr_pos.at[jnp.where(p < n, p, n)].set(isa_red, mode="drop")

    # --- induce all type-B suffixes --------------------------------------
    # per-position hop words (int32): B positions: (2c+1, -seg_len);
    # A positions (terminals): (2c, bstar_rank(i-1)); slot n: sentinel.
    # At equal char an A-type suffix precedes every B-type suffix, which
    # the parity of w1 encodes (ref note: divsufsort.rs:123-124).
    bsr_prev = jnp.concatenate([jnp.full((1,), -1, idx), bsr_pos[:n][:-1]])
    w1b = jnp.where(type_b, 2 * char + 1, 2 * char)
    w2b = jnp.where(type_b, -seg_len, bsr_prev)
    nxtb = jnp.where(type_b, seg_end + 1, j)
    w1b = jnp.concatenate([w1b, jnp.full((1,), big, idx)])
    w2b = jnp.concatenate([w2b, jnp.zeros((1,), idx)])
    nxtb = jnp.concatenate([nxtb, jnp.full((1,), n, idx)])
    bpos_s, brank_pos, n_b = _induce(type_b, w1b, w2b, nxtb, hops, idx)

    # --- induce all type-A suffixes --------------------------------------
    # A positions: (2c, +seg_len); B positions (terminals): (2c+1,
    # induced B rank); off-end: (-1, 0) — an ended suffix precedes
    # every continuing one (ref: the left-to-right scan seeds n-1 first,
    # divsufsort.rs:414-418).
    w1a = jnp.where(type_b, 2 * char + 1, 2 * char)
    w2a = jnp.where(type_b, brank_pos[:n], seg_len)
    nxta = jnp.where(type_b, j, jnp.minimum(seg_end + 1, n_i))
    w1a = jnp.concatenate([w1a, jnp.full((1,), -1, idx)])
    w2a = jnp.concatenate([w2a, jnp.zeros((1,), idx)])
    nxta = jnp.concatenate([nxta, jnp.full((1,), n, idx)])
    apos_s, _arank_pos, n_a = _induce(~type_b, w1a, w2a, nxta, hops, idx)

    # --- assemble: per-char A-part then B-part ---------------------------
    # (the bucket layout fact: within a first-char bucket all type-A
    # suffixes precede all type-B suffixes; ref divsufsort.rs:127-142)
    ach = jnp.where(j < n_a, jnp.take(char, apos_s), jnp.asarray(256, idx))
    bch = jnp.where(j < n_b, jnp.take(char, bpos_s), jnp.asarray(256, idx))
    probes = jnp.arange(257, dtype=idx)
    astart = jnp.searchsorted(ach, probes)
    bstart = jnp.searchsorted(bch, probes)
    count_a = astart[1:] - astart[:-1]          # [256]
    count_b = bstart[1:] - bstart[:-1]
    charstart = jnp.concatenate(
        [jnp.zeros((1,), idx), jnp.cumsum(count_a + count_b)[:-1]]
    ).astype(idx)
    slot_a = jnp.where(
        j < n_a,
        jnp.take(charstart, ach, mode="clip") + (j - jnp.take(astart, ach, mode="clip")),
        n_i,
    )
    slot_b = jnp.where(
        j < n_b,
        jnp.take(charstart, bch, mode="clip")
        + jnp.take(count_a, jnp.minimum(bch, 255), mode="clip")
        + (j - jnp.take(bstart, bch, mode="clip")),
        n_i,
    )
    sa = jnp.zeros((n,), idx)
    sa = sa.at[slot_a].set(apos_s, mode="drop")
    sa = sa.at[slot_b].set(bpos_s, mode="drop")
    isa = jnp.zeros((n,), idx).at[sa].set(j)
    return sa, isa


def _redsolve(red, idx, depth, levels, fan):
    """Reduced-string SA (inlined build_ints_with_isa, sharing the jit)."""
    cap = red.shape[0]
    seq = red - jnp.min(red)
    k = jnp.arange(cap, dtype=idx)
    keys = (seq,) + tuple(
        _shift_ranks(seq, jnp.asarray(t, idx)) for t in range(1, depth)
    )
    out = jax.lax.sort(keys + (k,), num_keys=depth)
    sa0, rank_s0, count0 = _ranks_sorted_only(out, idx)
    h0 = jnp.minimum(jnp.asarray(depth, idx), jnp.asarray(cap, idx))
    sa_red, isa_red = _refine(sa0, rank_s0, count0, h0, idx,
                              levels, fan, want_isa=True)
    return sa_red, isa_red


# ---------------------------------------------------------------------------
# public API (ref shape: crates/divsufsort/src/lib.rs:20-29)
# ---------------------------------------------------------------------------


def sort(text) -> SuffixArray:
    """Build the suffix array of `text` with the B*-reduction engine."""
    arr = as_text_array(text)
    n = int(arr.shape[0])
    if n >= (1 << 31):
        raise ValueError("text length must be < 2^31 for the i32 index path")
    if n < 3:
        from stringsearch_tpu.engines import doubling

        return doubling.sort(text)
    sa, _isa = build(arr)
    return SuffixArray(arr, sa)


def sort_in_place(text, sa_out: np.ndarray) -> None:
    """Fill a caller-provided int32 buffer (ref API shape:
    crates/divsufsort/src/lib.rs:20-22)."""
    np.copyto(sa_out, np.asarray(sort(text).sa))


def sort_traced(text, tracer) -> SuffixArray:
    """Traced B*-engine build: host-stepped phases with diffable dumps —
    the trace points mirror the reference's phase structure
    (classification/bucket counts, sorted B*, induced B, final SA; ref
    trace calls threaded through sort_typeBstar/construct_SA,
    crates/divsufsort/src/divsufsort.rs:177,190 and crosscheck.rs)."""
    arr = as_text_array(text)
    n = int(arr.shape[0])
    tracer.log(f"bstar engine n={n}")
    if n < 3:
        sa = sort(arr)
        tracer.dump("SA final", sa.sa)
        tracer.flush()
        return sa
    tj = jnp.asarray(arr)
    idx = _I32
    seg_end, type_b, bstar = _classify(tj, idx)
    tracer.log(
        f"classify: B={int(jnp.sum(type_b))} "
        f"B*={int(jnp.sum(bstar))} of {n}"
    )
    p, m = _extract_bstar(bstar, idx)
    m_i = int(m)
    tracer.dump("B* positions", np.asarray(p)[:m_i])
    red = _name_and_rank(tj, p, m, idx)
    tracer.dump("B* substring names", np.asarray(red)[:m_i])
    sa_red, isa_red = _redsolve(red, idx, 6, (4, 32, 256), 4)
    cap = int(p.shape[0])
    sorted_bstar = np.asarray(p)[np.asarray(sa_red)[cap - m_i:]]
    tracer.dump("sorted B* suffixes", sorted_bstar)
    sa, _isa = build(tj, idx)
    tracer.dump("SA final", sa)
    tracer.flush()
    return SuffixArray(arr, sa)
