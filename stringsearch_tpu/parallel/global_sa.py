"""Exact global suffix array over a sharded text — multi-chip doubling.

This is the "stretch goal" capability beyond the reference: `sacapart`
(ref: crates/sacapart/src/lib.rs:26-98) only ever builds *independent*
per-partition SAs and accepts degraded cross-boundary matches. Here the
text lives sharded over the mesh's "parts" axis and the engine produces
the exact suffix array OF THE WHOLE TEXT, with every doubling round's
global sort running as a rank-interval-routed all_to_all (merge-split
fallback on adversarial skew, parallel/distsort.py). During the BUILD
no device ever holds the full
text or SA. The batched query path (`longest_substring_match_batch`)
offers two text-residency modes: "replicated" (default — fastest, but
per-chip HBM bounds the queryable size) and "sharded" (every binary-
search probe fetches its text window through the all-to-all distributed
gather of parallel/gather.py — one collective per step, no device ever
holds more than text/P).

Algorithm = the flagship prefix-doubling engine
(engines/doubling.py, itself the generalization of trsort's doubling loop,
ref: crates/divsufsort/src/trsort.rs:1363-1410), re-expressed shard-wise:

  initial ranks: pack `depth` RAW text bytes into depth/4 uint32 keys
  per position (the cross-shard window comes from ONE neighbor ppermute)
  and globally sort once — on text-like input this deep key resolves
  almost every position before any doubling round runs (same measured
  trade as the single-chip engine: one extra sort key is far cheaper
  than an extra full round);

  per round (h static per round; depth multiplies by `fan` — default 3 —
  per round: sort keys (rank[i], rank[i+h], .., rank[i+(fan-1)h]), each
  a depth-h class; an extra key is one more operand through the
  merge-split exchanges, traded against an extra full round of global
  sorts):
    1. rank_h[i] = rank[i+h] — two static `ppermute` hops (the source
       global position i+h falls in at most two neighbor shards); past
       the end the marker is -(i+1): negative and strictly decreasing,
       so suffixes that end inside the window split immediately,
       shortest first (the raw-byte zero pad conflates "ended" with a
       real 0x00 byte, exactly as in engines/doubling.py — the marker
       protocol is what repairs it);
    2. global sort by (rank, rank_h, gidx) — the primary key is a
       HEAD-SLOT rank, so the sort routes elements to shard rank//L
       with ONE all_to_all + a boundary ppermute instead of the bitonic
       merge-split network's S(P) full exchanges (distsort.py
       `rank_interval_sort`; merge-split is the overflow fallback);
    3. new head-slot ranks: local neighbor-diff flags with the boundary
       value shifted in from the previous shard, local cummax of head
       slots + an all-gathered cross-shard head carry;
    4. redistribute ranks to text order by globally sorting (gidx, rank) —
       sorting by the permutation index IS the inverse scatter, and it
       re-balances shards exactly (shard s ends up with positions
       [s*L, (s+1)*L)).

  Rounds are dispatched in blocks of `ROUNDS_PER_DISPATCH` inside one
  jitted program; each round in the block is guarded by a replicated
  `lax.cond(done, skip, run)` so finished builds stop computing, and the
  host syncs the `done` flag only once per block (O(log(n)/K) syncs and
  compiles rather than one of each per round).

Zero-padding to P*L keeps all shapes static: pad suffixes are true
suffixes of the padded text and sort strictly before the real suffix
with the same content (shorter run sorts first), so they occupy exactly
the first `pad` slots of the sorted order and are dropped from the
final SA.

Index width: pass idx=jnp.int64 (with jax x64 enabled) for global
offsets past 2^31 — the multi-host regime this engine exists for
(ref 64-bit mode: c-sources/divsufsort_private.h:63-84
BUILD_DIVSUFSORT64). Keys stay uint32 (they hold raw bytes); only
positions and ranks widen.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stringsearch_tpu.core.types import BytesLike, as_text_array
from stringsearch_tpu.parallel.distsort import (
    rank_interval_sort,
    redistribute_permutation,
    sharded_sort,
    shift_in_from_prev,
)

_I32 = jnp.int32
_AXIS = "parts"

#: doubling rounds fused into one jitted dispatch (host `done` syncs and
#: fresh compiles happen once per block, not once per round)
ROUNDS_PER_DISPATCH = 4

#: default initial-key depth in text bytes (must be a multiple of 4;
#: clamped down for tiny chunks)
INITIAL_DEPTH = 16


def _global_iota(chunk_len: int, idx):
    me = jax.lax.axis_index(_AXIS).astype(idx)
    return me * chunk_len + jnp.arange(chunk_len, dtype=idx)


def _gmin(x):
    """Cross-shard min of a scalar via all_gather + local reduce.

    Not every backend lowers 64-bit all-reduces other than SUM (the
    original accelerator refused an s64 pmin), so the i64 index mode
    does not use lax.pmax/pmin on ranks. An all_gather of one scalar
    costs the same collective class and lowers for every dtype.
    """
    return jnp.min(jax.lax.all_gather(x, _AXIS))


def _headslot_ranks_from_sorted(eq_prev: jnp.ndarray, idx):
    """Global HEAD-SLOT rank of each sorted element + resolution flag.

    The head-slot rank is the global sorted slot of the element's
    tie-group FIRST member — order-isomorphic to a dense rank (the
    doubling algebra only needs order), equal to the final ISA once
    every group is a singleton, and the representation the
    rank-interval round sort's routing invariant requires: an element
    with rank r has its final slot in [r, r + group_size), so shard
    r // L is where its group starts (parallel/distsort.py
    `rank_interval_sort`). The single-chip engine has used head-slot
    ranks since round 2 (engines/doubling.py `_heads_and_tied`).

    eq_prev: bool [L], True where the element's key equals its global
    predecessor's (shard-boundary handled by the caller). Returns
    (rank [L], done bool scalar): done ⟺ every slot is its own head.
    The carry for shards whose first elements continue an earlier
    shard's group is a masked max over an all-gather of per-shard last
    local heads (a headless shard contributes -1, so the max lands on
    the latest shard that actually saw a group head).
    """
    p = jax.lax.axis_size(_AXIS)
    me = jax.lax.axis_index(_AXIS)
    length = eq_prev.shape[0]
    gslot = _global_iota(length, idx)
    new_flag = ~eq_prev
    head_local = jax.lax.cummax(
        jnp.where(new_flag, gslot, jnp.asarray(-1, idx))
    )
    lasts = jax.lax.all_gather(head_local[-1], _AXIS)  # [P]
    mask = jnp.arange(p, dtype=jnp.int32) < me
    carry = jnp.max(jnp.where(mask, lasts, jnp.asarray(-1, idx)))
    rank = jnp.where(head_local >= 0, head_local, carry)
    # tied SLOT count: a slot is tied iff it is not its own head OR the
    # next slot shares its head (group size >= 2) — the count the host
    # uses to enter the compacted phase, and 0 ⟺ resolved
    perm = [(i, (i - 1) % p) for i in range(p)]
    nf = jax.lax.ppermute(rank[:1], _AXIS, perm)
    nf = jnp.where(me == p - 1, jnp.full_like(nf, -1), nf)
    rank_next = jnp.concatenate([rank[1:], nf])
    tied = (rank != gslot) | (rank_next == rank)
    count = jax.lax.psum(jnp.sum(tied.astype(jnp.int32)), _AXIS)
    return rank, count


def _initial_shard_ranks(depth: int, idx, chunk: jnp.ndarray):
    """Ranks by the first `depth` raw bytes (packed u32 keys), shard-wise.

    The window past the shard boundary comes from the next shard's first
    `depth` bytes (one ppermute); past the LAST shard the window is
    zero-filled — the same raw-byte conflation as engines/doubling.py,
    repaired by the doubling rounds' marker protocol.
    """
    length = chunk.shape[0]
    t = chunk.astype(jnp.uint32)
    p = jax.lax.axis_size(_AXIS)
    me = jax.lax.axis_index(_AXIS)
    perm = [(i, (i - 1) % p) for i in range(p)]
    nxt = jax.lax.ppermute(t[:depth], _AXIS, perm)
    nxt = jnp.where(me == p - 1, jnp.zeros_like(nxt), nxt)
    ext = jnp.concatenate([t, nxt])  # [L + depth]
    keys = []
    for k in range(depth // 4):
        o = 4 * k
        keys.append(
            (ext[o : o + length] << 24)
            | (ext[o + 1 : o + 1 + length] << 16)
            | (ext[o + 2 : o + 2 + length] << 8)
            | ext[o + 3 : o + 3 + length]
        )
    nk = len(keys)
    gidx = _global_iota(length, idx)
    out = sharded_sort(tuple(keys) + (gidx,), _AXIS, num_keys=nk)
    keys_s, gidx_s = out[:nk], out[-1]
    # eq-prev across ALL keys; boundary values from the previous shard
    prev = shift_in_from_prev(
        jnp.stack([ks[-1] for ks in keys_s]), _AXIS, 0
    )
    eq_prev = jnp.ones((length,), bool)
    for i, ks in enumerate(keys_s):
        shifted = jnp.concatenate([prev[i : i + 1], ks[:-1]])
        eq_prev = eq_prev & (ks == shifted)
    # the global first element is never equal to a predecessor (the
    # fill 0 above could collide with a real all-zero key)
    eq_prev = eq_prev & ~(
        (me == 0) & (jnp.arange(length) == 0)
    )
    rank_s, count = _headslot_ranks_from_sorted(eq_prev, idx)
    # back to text order: gidx_s is a permutation, so this is one
    # all_to_all (merge-split fallback on adversarial skew) instead of a
    # full distributed sort — ~3x less redistribute wire volume at P=8
    (rank,) = redistribute_permutation(gidx_s, (rank_s,), _AXIS)
    return rank, gidx_s, rank_s, count


def _shifted_ranks(rank: jnp.ndarray, h: int, total_shards: int, idx):
    """rank_h[i] = rank[global i + h]; marker -(i+1) past the end.

    h static. The marker is negative (ended suffixes sort before every
    continuing one) and strictly decreasing in global i, so ties among
    ended suffixes split immediately, shortest suffix first — required
    because raw-byte zero-padded initial keys conflate "suffix ended"
    with "real 0x00 byte" (see module docstring).
    """
    length = rank.shape[0]
    p = total_shards
    me = jax.lax.axis_index(_AXIS)
    d, r = divmod(h, length)

    def from_offset(delta):
        if delta >= p:
            return jnp.full_like(rank, -1)
        perm = [(i, i - delta) for i in range(delta, p)]
        src = jax.lax.ppermute(rank, _AXIS, perm) if perm else rank
        return jnp.where(me + delta < p, src, -1)

    if r == 0:
        shifted = from_offset(d)
    else:
        a = from_offset(d)      # provides positions [r, L) of the window
        b = from_offset(d + 1)  # provides positions [0, r)
        shifted = jnp.concatenate([a[r:], b[:r]])
    gidx = _global_iota(length, idx)
    n_pad = length * p
    in_range = gidx < jnp.asarray(n_pad - h, idx) if h < n_pad else jnp.zeros(
        (length,), bool
    )
    return jnp.where(in_range, shifted, -(gidx + 1))


def _doubling_step(chunk_len: int, total_shards: int, idx, h: int, rank,
                   fan: int = 2):
    """One distributed round (h static). Returns (rank, sa, done).

    `fan` as in engines/doubling.py: sort keys (rank[i], rank[i+h], ...,
    rank[i+(fan-1)h]) — each a depth-h class — multiply the resolved
    depth by `fan` per round instead of 2. Each extra key costs one more
    operand through the bitonic merge-split exchanges, traded against a
    whole extra round of global sorts.
    """
    n_pad = chunk_len * total_shards
    shifts = [
        _shifted_ranks(rank, min(k * h, n_pad), total_shards, idx)
        for k in range(1, fan)
    ]
    gidx = _global_iota(chunk_len, idx)
    # head-slot primary key → the interval-routed sort replaces the
    # merge-split network's S(P) full-chunk exchanges with ONE
    # all_to_all + one boundary ppermute (merge-split fallback on
    # adversarial rank skew) — the round-5 wire cut that moves the
    # P=8 comm projection from ~59% to ~75% (parallel/comm_model.py)
    out = rank_interval_sort((rank, *shifts, gidx), _AXIS,
                             num_keys=fan + 1)
    keys_s, sa_s = out[:fan], out[-1]
    prev = shift_in_from_prev(
        jnp.stack([ks[-1] for ks in keys_s]), _AXIS, -2
    )
    eq_prev = jnp.ones((chunk_len,), bool)
    for i, ks in enumerate(keys_s):
        eq_prev = eq_prev & (ks == jnp.concatenate([prev[i : i + 1], ks[:-1]]))
    rank_s, count = _headslot_ranks_from_sorted(eq_prev, idx)
    # redistribute ranks to text order: sa_s is a permutation — one
    # all_to_all instead of a full merge-split sort (see distsort)
    (rank,) = redistribute_permutation(sa_s, (rank_s,), _AXIS)
    return rank, sa_s, rank_s, count


def _rounds_block(chunk_len: int, total_shards: int, idx, hs: tuple,
                  fan: int, rank, sa, rank_s, count):
    """ROUNDS_PER_DISPATCH cond-guarded rounds in one traced program.

    Every round's `count` is replicated (a psum result), so all devices
    take the same branch and the collectives inside the live branch stay
    deadlock-free; once the count hits zero, the remaining rounds are
    skipped.
    """
    state = (rank, sa, rank_s, count)
    for h in hs:
        def run(st, h=h):
            rank, _sa, _rank_s, _count = st
            return _doubling_step(chunk_len, total_shards, idx, h, rank, fan)

        state = jax.lax.cond(state[3] == 0, lambda st: st, run, state)
    return state


#: per-shard compacted capacity divisor: M = chunk // _COMPACT_DIV
_COMPACT_DIV = 4
#: enter the compacted phase when the global tied count <= n_pad / this
_COMPACT_ENTRY = 8


def _compact_round(chunk_len: int, total_shards: int, idx, fan: int,
                   m_cap: int, h: int, rank, sa, rank_s):
    """One COMPACTED distributed round — refine only the tied slots.

    The distributed analog of the single-chip compaction cascade
    (engines/doubling.py `_compact_round`; the role of trsort's
    skip-run compression, ref: crates/divsufsort/src/trsort.rs:1363-1410):
    instead of sorting all n_pad lanes across the mesh every round, each shard
    extracts the tied slots RESIDENT in its slice of the sorted order
    (<= m_cap of them), reunites boundary-straddling groups on their
    head's shard with one neighbor ppermute, and refines them with
    LOCAL sorts — the only full-width collective traffic left is the
    shifted-key gather and the text-order rank write-back, both
    balanced all_to_alls at 2*ceil(2M/P) per-pair capacity. Per-round
    wire is thereby bounded by the LIVE TIED POPULATION, not n_pad.

    Locality invariants (why the sorts and head arithmetic are local):
      * no-extraction-overflow ⇒ every tied group spans <= 2 shards (a
        3-shard span contains a whole middle shard: L > m_cap tied
        slots there);
      * after the straddle ppermute, every working entry's group head
        slot g lies in THIS shard's interval, so group members are
        co-resident and `slot = g + offset` arithmetic needs no
        cross-shard carries;
      * slots of refined entries exceed the shard's range by < 2M <= L,
        so SA / sorted-rank write-backs spill to the NEXT shard only
        (one ppermute).

    Every capacity violation (extraction > M, gather or write-back
    skew > cap) raises a replicated flag and the round falls back to
    the always-correct full-width `_doubling_step` — adversarial
    inputs lose the optimization, never correctness.

    Returns (rank, sa, rank_s, count).
    """
    p = total_shards
    me = jax.lax.axis_index(_AXIS)
    length = chunk_len
    n_pad = length * p
    big = jnp.asarray(np.iinfo(np.dtype(idx)).max, idx)
    n_pad_i = jnp.asarray(n_pad, idx)
    gslot = _global_iota(length, idx)
    perm_from_next = [(i, (i - 1) % p) for i in range(p)]
    perm_to_next = [(i, (i + 1) % p) for i in range(p)]

    # 1. tied flags in sorted order (local + one boundary ppermute)
    nf = jax.lax.ppermute(rank_s[:1], _AXIS, perm_from_next)
    nf = jnp.where(me == p - 1, jnp.full_like(nf, -1), nf)
    rank_s_next = jnp.concatenate([rank_s[1:], nf])
    tied = (rank_s != gslot) | (rank_s_next == rank_s)

    # 2. local extraction at capacity M (sorted by group id g = rank_s)
    key = jnp.where(tied, rank_s, big)
    key_srt, pos_srt = jax.lax.sort((key, sa), num_keys=1)
    over_local = (m_cap < length) & (key_srt[min(m_cap, length - 1)]
                                     != big)
    over_extract = jax.lax.psum(
        over_local.astype(jnp.int32), _AXIS) > 0  # replicated
    g0 = key_srt[:m_cap]
    pos0 = pos_srt[:m_cap]

    # 3. straddle repair: entries whose group head lives on the
    # PREVIOUS shard (g < me*L — a prefix of the g-sorted extraction)
    # ship there whole, so groups become shard-resident
    pre = g0 < me * jnp.asarray(length, idx)
    cnt_pre = jnp.sum(pre.astype(jnp.int32))
    g_in = jax.lax.ppermute(g0, _AXIS, perm_from_next)
    pos_in = jax.lax.ppermute(pos0, _AXIS, perm_from_next)
    cnt_in = jax.lax.ppermute(cnt_pre, _AXIS, perm_from_next)
    cnt_in = jnp.where(me == p - 1, 0, cnt_in)
    jm = jnp.arange(m_cap, dtype=jnp.int32)
    rv = jm < cnt_in
    g_recv = jnp.where(rv, g_in, big)
    pos_recv = jnp.where(rv, pos_in, n_pad_i)
    gw = jnp.concatenate([jnp.where(pre, big, g0), g_recv])
    pw = jnp.concatenate([jnp.where(pre, n_pad_i, pos0), pos_recv])

    # 4. shifted keys: balanced capped gather on the sharded text-order
    # rank (markers for windows past the end, as everywhere)
    from stringsearch_tpu.parallel.gather import sharded_gather_capped

    cap = 2 * (-(-2 * m_cap // p))
    over = over_extract
    shifts = []
    for k in range(1, fan):
        s_k = min(h, n_pad // k + 1) * k  # static, like _doubling_step
        past = pw >= n_pad_i - jnp.asarray(s_k, idx)
        req = jnp.where(past, 0, pw + jnp.asarray(s_k, idx))
        val, ov = sharded_gather_capped(rank, req.astype(jnp.int32),
                                        _AXIS, cap)
        shifts.append(jnp.where(past, -(pw + 1), val.astype(idx)))
        over = over | ov

    # 5. LOCAL refinement sort over the [2M] working set
    out = jax.lax.sort((gw, *shifts, pw), num_keys=fan + 1)
    g_s2, pos_s2 = out[0], out[-1]
    j2 = jnp.arange(2 * m_cap, dtype=idx)
    group_f = jnp.concatenate(
        [jnp.ones((1,), bool), g_s2[1:] != g_s2[:-1]])
    kdiff = jnp.zeros((2 * m_cap - 1,), bool)
    for ks in out[1:-1]:
        kdiff = kdiff | (ks[1:] != ks[:-1])
    run_f = group_f | jnp.concatenate([jnp.ones((1,), bool), kdiff])
    ghead = jax.lax.cummax(jnp.where(group_f, j2, jnp.asarray(-1, idx)))
    rhead = jax.lax.cummax(jnp.where(run_f, j2, jnp.asarray(-1, idx)))
    valid = g_s2 != big
    slot = jnp.where(valid, g_s2 + (j2 - ghead), n_pad_i)
    new_g = jnp.where(valid, g_s2 + (rhead - ghead), big)
    nxt_rhead = jnp.concatenate([rhead[1:], jnp.full((1,), -1, idx)])
    tied2 = valid & ((rhead != j2) | (nxt_rhead == rhead))
    count = jax.lax.psum(jnp.sum(tied2.astype(jnp.int32)), _AXIS)

    # 7a. SA + sorted-rank write-back by slot: local scatter + one
    # next-neighbor ppermute for the spill (slot < (me+1)L + 2M <=
    # (me+2)L, so the spill never reaches further)
    base = me.astype(idx) * jnp.asarray(length, idx)
    loc = slot - base
    in_loc = valid & (loc >= 0) & (loc < length)
    drop_i = jnp.where(in_loc, loc, length)
    sa_new = sa.at[drop_i].set(pos_s2, mode="drop")
    rank_s_new = rank_s.at[drop_i].set(new_g, mode="drop")
    sp_slot = jnp.where(valid & (loc >= length), slot, n_pad_i)
    sp1 = jax.lax.ppermute(sp_slot, _AXIS, perm_to_next)
    sp2 = jax.lax.ppermute(pos_s2, _AXIS, perm_to_next)
    sp3 = jax.lax.ppermute(new_g, _AXIS, perm_to_next)
    sp1 = jnp.where(me == 0, n_pad_i, sp1)  # shard 0 receives nothing
    loc2 = sp1 - base
    in2 = (loc2 >= 0) & (loc2 < length)
    drop2 = jnp.where(in2, loc2, length)
    sa_new = sa_new.at[drop2].set(sp2, mode="drop")
    rank_s_new = rank_s_new.at[drop2].set(sp3, mode="drop")

    # 7b. text-order rank write-back: balanced all_to_all scatter
    dest = jnp.where(valid, (pos_s2 // length).astype(jnp.int32), p)
    d_s, po_s, ng_s = jax.lax.sort(
        (dest, pos_s2, new_g), num_keys=1)
    i2 = jnp.arange(2 * m_cap, dtype=jnp.int32)
    seg = jnp.searchsorted(d_s, d_s, side="left").astype(jnp.int32)
    rnk = i2 - seg
    over = over | (jax.lax.psum(
        jnp.any((d_s < p) & (rnk >= cap)).astype(jnp.int32), _AXIS) > 0)
    d_safe = jnp.where(d_s < p, d_s, 0)
    use = (d_s < p) & (rnk < cap)
    send_po = jnp.full((p, cap), n_pad_i, idx)
    send_po = send_po.at[
        jnp.where(use, d_safe, p), jnp.minimum(rnk, cap - 1)
    ].set(po_s, mode="drop")
    send_ng = jnp.zeros((p, cap), idx)
    send_ng = send_ng.at[
        jnp.where(use, d_safe, p), jnp.minimum(rnk, cap - 1)
    ].set(ng_s, mode="drop")
    recv_po = jax.lax.all_to_all(send_po, _AXIS, split_axis=0,
                                 concat_axis=0, tiled=True).reshape(-1)
    recv_ng = jax.lax.all_to_all(send_ng, _AXIS, split_axis=0,
                                 concat_axis=0, tiled=True).reshape(-1)
    locp = recv_po - base
    inp = (locp >= 0) & (locp < length)
    rank_new = rank.at[jnp.where(inp, locp, length)].set(
        recv_ng, mode="drop")

    def fallback(_):
        return _doubling_step(chunk_len, total_shards, idx, h, rank, fan)

    def fast(_):
        return rank_new, sa_new, rank_s_new, count

    return jax.lax.cond(over, fallback, fast, None)


def _compact_block(chunk_len: int, total_shards: int, idx, fan: int,
                   m_cap: int, hs: tuple, rank, sa, rank_s, count):
    """ROUNDS_PER_DISPATCH cond-guarded COMPACTED rounds per dispatch."""
    state = (rank, sa, rank_s, count)
    for h in hs:
        def run(st, h=h):
            rank, sa, rank_s, _count = st
            return _compact_round(chunk_len, total_shards, idx, fan,
                                  m_cap, h, rank, sa, rank_s)

        state = jax.lax.cond(state[3] == 0, lambda st: st, run, state)
    return state


@functools.lru_cache(maxsize=64)
def _jit_init(mesh: Mesh, depth: int, idx):
    return jax.jit(
        jax.shard_map(
            partial(_initial_shard_ranks, depth, idx),
            mesh=mesh,
            in_specs=P(_AXIS),
            out_specs=(P(_AXIS), P(_AXIS), P(_AXIS), P()),
            check_vma=False,
        )
    )


@functools.lru_cache(maxsize=256)
def _jit_block(mesh: Mesh, chunk: int, p: int, idx, hs: tuple, fan: int):
    """Cached per (mesh, shapes, h-schedule): repeated builds (bench reps,
    the scaling harness, saturated-h tail blocks) reuse the compiled
    program instead of re-tracing a fresh jit wrapper every dispatch."""
    return jax.jit(
        jax.shard_map(
            partial(_rounds_block, chunk, p, idx, hs, fan),
            mesh=mesh,
            in_specs=(P(_AXIS), P(_AXIS), P(_AXIS), P()),
            out_specs=(P(_AXIS), P(_AXIS), P(_AXIS), P()),
            check_vma=False,
        )
    )


@functools.lru_cache(maxsize=256)
def _jit_compact_block(mesh: Mesh, chunk: int, p: int, idx, fan: int,
                       m_cap: int, hs: tuple):
    return jax.jit(
        jax.shard_map(
            partial(_compact_block, chunk, p, idx, fan, m_cap, hs),
            mesh=mesh,
            in_specs=(P(_AXIS), P(_AXIS), P(_AXIS), P()),
            out_specs=(P(_AXIS), P(_AXIS), P(_AXIS), P()),
            check_vma=False,
        )
    )


def _verify_shard(chunk_len: int, idx, text_chunk, rank_chunk, sa_chunk):
    """Distributed ISA-recurrence verify — runs INSIDE shard_map.

    The sharded re-expression of core/verify.py's O(n) characterisation
    (itself the role of the reference's checkers,
    ref: crates/sacabase/src/lib.rs:127-149 `verify` and
    c-sources/utils.c:160-241 `sufcheck`): with rank = the claimed ISA in
    text order, the SA is valid  ⟺
      (1) rank is a permutation of [0, n_pad)
      (2) the key (T[i], rank(i+1)) is strictly increasing when positions
          are ordered by rank  (rank(n_pad) = -1: the empty suffix first)
    Both reduce to ONE distributed 1-key sort by rank carrying
    (first-byte, next-rank, position) payloads: sorted ranks must equal
    the global iota, adjacent payload keys must be strictly increasing
    (boundary via one ppermute), and the position payload must reproduce
    the stored SA shards. No device ever materializes a full array.

    Returns (ok scalar bool, bad: the smallest failing global sorted-order
    slot, n_pad when ok) — replicated.
    """
    p = jax.lax.axis_size(_AXIS)
    me = jax.lax.axis_index(_AXIS)
    n_pad = chunk_len * p
    gidx = _global_iota(chunk_len, idx)
    # rank(i+1): local shift; the boundary value is the NEXT shard's
    # first rank (one ppermute); the global last position gets -1
    perm = [(i, (i - 1) % p) for i in range(p)]
    nxt_first = jax.lax.ppermute(rank_chunk[:1], _AXIS, perm)
    nxt_first = jnp.where(me == p - 1, jnp.full_like(nxt_first, -1),
                          nxt_first)
    rank_next = jnp.concatenate([rank_chunk[1:], nxt_first])
    first = text_chunk.astype(idx)
    r_s, fb_s, rn_s, pos_s = sharded_sort(
        (rank_chunk, first, rank_next, gidx), _AXIS, num_keys=1)
    perm_ok = jnp.all(r_s == gidx)
    sa_ok = jnp.all(pos_s == sa_chunk)
    prev = shift_in_from_prev(jnp.stack([fb_s[-1], rn_s[-1]]), _AXIS, -1)
    fb_p = jnp.concatenate([prev[:1], fb_s[:-1]])
    rn_p = jnp.concatenate([prev[1:2], rn_s[:-1]])
    adj_ok = (fb_p < fb_s) | ((fb_p == fb_s) & (rn_p < rn_s))
    adj_ok = adj_ok | (gidx == 0)  # the global first slot has no prev
    bad_local = jnp.min(jnp.where(adj_ok, jnp.asarray(n_pad, idx), gidx))
    bad = _gmin(bad_local)
    ok = _gmin((perm_ok & sa_ok & jnp.all(adj_ok)).astype(jnp.int32)) == 1
    kind = _gmin(
        jnp.where(perm_ok, jnp.where(sa_ok, 2, 1), 0).astype(jnp.int32)
    )
    return ok, bad, kind


@functools.lru_cache(maxsize=64)
def _jit_verify(mesh: Mesh, chunk: int, idx):
    return jax.jit(
        jax.shard_map(
            partial(_verify_shard, chunk, idx),
            mesh=mesh,
            in_specs=(P(_AXIS), P(_AXIS), P(_AXIS)),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
    )


@functools.lru_cache(maxsize=256)
def _jit_query(mesh: Mesh, text_mode: str, chunk: int, n: int, n_pad: int,
               steps: int, m_width: int):
    """Cached compiled distributed-query executable.

    Keyed by everything the trace closes over (mesh, mode, shard
    geometry, text length, search depth, needle width): repeated query
    batches with the same shapes reuse the compiled program instead of
    re-tracing a fresh jit wrapper per call — the same pattern as
    `_jit_block` on the build path."""
    from stringsearch_tpu.core import compare as cmp
    from stringsearch_tpu.core.search import lcs_kernel, lcs_loop
    from stringsearch_tpu.parallel.gather import sharded_gather_windows

    def reduce_over_shards(start, length, nds):
        # mask pad suffixes (start >= n) and clamp matches at the
        # real end of text (a \x00-bearing needle must not extend
        # into zero pad)
        length = jnp.minimum(length, n - start)
        length = jnp.where(start < n, length, -1)
        all_len = jax.lax.all_gather(length, _AXIS, axis=0)  # [P, B]
        all_start = jax.lax.all_gather(start, _AXIS, axis=0)
        best_p = jnp.argmax(all_len, axis=0)
        best_len = jnp.maximum(jnp.max(all_len, axis=0), 0)
        best_start = jnp.take_along_axis(all_start, best_p[None, :], axis=0)[0]
        return best_start, best_len

    def per_shard_replicated(sa_slice, text_full, nds):
        start, _ = lcs_kernel(text_full, sa_slice, nds, steps)
        windows = cmp.gather_window(text_full, start[None, :], nds.shape[-1])[0]
        length = cmp.prefix_match_len(windows, nds)
        return reduce_over_shards(start, length, nds)

    def per_shard_sharded(sa_slice, text_shard, nds):
        def windows_at(pos):
            starts = jnp.take(sa_slice, jnp.clip(pos, 0, chunk - 1))
            win = sharded_gather_windows(
                text_shard, starts, m_width, _AXIS
            ).astype(jnp.int32)
            offs = jnp.arange(m_width, dtype=jnp.int32)
            inb = (starts[:, None] + offs[None, :]) < n_pad
            return starts, jnp.where(inb, win, cmp.PAST_TEXT_END)

        start, length = lcs_loop(windows_at, chunk, nds, steps)
        return reduce_over_shards(start, length, nds)

    if text_mode == "replicated":
        fn, text_spec = per_shard_replicated, P()
    else:
        fn, text_spec = per_shard_sharded, P(_AXIS)
    return jax.jit(
        jax.shard_map(
            fn,
            mesh=mesh,
            in_specs=(P(_AXIS), text_spec, P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )


@functools.lru_cache(maxsize=256)
def _jit_search(mesh: Mesh, text_mode: str, chunk: int, n: int, n_pad: int,
                steps: int, m_width: int):
    """Cached compiled distributed exact-occurrence search.

    The sharded re-expression of `sa_search`
    (ref: c-sources/utils.c:244-325): every shard runs the double binary
    search (`core.search.sa_search_loop`) over ITS contiguous slice of
    the global sorted order; because the slices concatenate to the full
    sorted order, each shard's (lower, upper) insertion bounds are the
    counts of its entries below the needle, so the GLOBAL bounds are
    plain psums — count = psum(up - lo), leftmost slot = psum(lo). No
    device materializes the whole SA; the reduction is two scalar-batch
    psums.

    Pad-suffix handling: probe windows mask every byte at global
    position >= n (the real text end) to PAST_TEXT_END, so pad bytes can
    neither extend a real match nor let a pad suffix match a nonempty
    needle; pad slots then compare below every needle and land inside
    the lower bound, which the caller rebases by `pad`.
    """
    from stringsearch_tpu.core import compare as cmp
    from stringsearch_tpu.core.search import needle_mask_cmp, sa_search_loop
    from stringsearch_tpu.parallel.gather import sharded_gather_windows

    offs = jnp.arange(m_width, dtype=jnp.int32)

    def per_shard(sa_slice, text_arg, needles, lens):
        compare = needle_mask_cmp(needles, lens)

        def windows_replicated(pos):
            starts = jnp.take(sa_slice, jnp.clip(pos, 0, chunk - 1))
            win = cmp.gather_window(text_arg, starts, m_width)
            inb = (starts[:, None] + offs[None, :]) < n
            return jnp.where(inb, win, cmp.PAST_TEXT_END)

        def windows_sharded(pos):
            starts = jnp.take(sa_slice, jnp.clip(pos, 0, chunk - 1))
            win = sharded_gather_windows(
                text_arg, starts, m_width, _AXIS
            ).astype(jnp.int32)
            inb = (starts[:, None] + offs[None, :]) < n
            return jnp.where(inb, win, cmp.PAST_TEXT_END)

        windows_at = (windows_replicated if text_mode == "replicated"
                      else windows_sharded)
        lo, up = sa_search_loop(
            lambda pos: compare(windows_at(pos)),
            chunk, needles.shape[0], steps,
        )
        count = jax.lax.psum(up - lo, _AXIS)
        left = jax.lax.psum(lo, _AXIS)
        return count, left

    text_spec = P() if text_mode == "replicated" else P(_AXIS)
    return jax.jit(
        jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(_AXIS), text_spec, P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )


class GlobalSuffixArray:
    """Exact suffix array of a mesh-sharded text (multi-chip, one index).

    Unlike `ShardedSuffixArray` (independent per-partition SAs with
    repair-at-query), this builds THE suffix array of the whole text; the
    result shards hold SA[s*L:(s+1)*L] of the global sorted order.

    idx: index dtype for global positions/ranks — jnp.int32 (default,
    n < 2^31) or jnp.int64 with jax x64 enabled (the multi-host 64-bit
    mode; ref: c-sources/divsufsort_private.h:63-84).
    """

    def __init__(self, text: BytesLike, mesh: Mesh, idx=_I32,
                 depth: int = INITIAL_DEPTH, fan: int = 3, tracer=None,
                 compaction: bool = True):
        self._tracer = tracer
        if _AXIS not in mesh.shape:
            raise ValueError(f'mesh must have a "{_AXIS}" axis')
        if depth % 4 or depth < 4:
            raise ValueError("depth must be a positive multiple of 4")
        if fan < 2:
            raise ValueError("fan must be >= 2")
        self.mesh = mesh
        self.idx = idx
        self.fan = fan
        self.compaction = compaction
        arr = as_text_array(text)
        self.n = int(arr.shape[0])
        p = mesh.shape[_AXIS]
        self.num_shards = p
        # min chunk of 4 keeps even the clamped-down minimum initial-key
        # window inside the immediate next shard (tiny texts just carry
        # extra zero padding)
        chunk = max(-(-max(self.n, p) // p), 4)
        self.chunk_len = chunk
        # the initial window must not reach past the immediate neighbor
        self.depth = max(4, min(depth, chunk) // 4 * 4)
        pad = chunk * p - self.n
        self.pad = pad
        if pad:
            arr = jnp.concatenate([arr, jnp.zeros((pad,), jnp.uint8)])
        sharding = NamedSharding(mesh, P(_AXIS))
        self.text_padded = jax.device_put(arr, sharding)
        self._build()

    def _build(self) -> None:
        mesh, chunk, p, idx = self.mesh, self.chunk_len, self.num_shards, self.idx
        n_pad = chunk * p
        m_cap = max(chunk // _COMPACT_DIV, 1)

        rank, sa, rank_s, count = _jit_init(mesh, self.depth, idx)(
            self.text_padded)
        h = self.depth
        self.rounds_run = 0
        self.compact_rounds_run = 0
        if self._tracer is not None:
            self._tracer.log(
                f"global engine n={self.n} shards={p} chunk={chunk} "
                f"depth={self.depth} fan={self.fan}"
            )
            self._tracer.dump(f"rank h={self.depth}", np.asarray(rank))
        # h saturates at n_pad, where the marker round resolves every
        # remaining tie (raw-byte conflation means a count-based early
        # exit is unsound; the saturated round is the guaranteed
        # finisher). Once the tied population fits the compacted
        # capacity with headroom, rounds switch to the compacted path
        # whose collective volume tracks the live population (adversarial
        # inputs: long runs / tiny alphabets); every compacted round
        # self-falls-back to a full-width round on capacity overflow.
        while bool(count):
            hs = []
            for _ in range(ROUNDS_PER_DISPATCH):
                hs.append(h)
                h = min(self.fan * h, n_pad)
            compact = (
                self.compaction
                and p >= 2
                and int(count) <= n_pad // _COMPACT_ENTRY
                and int(count) <= p * m_cap
            )
            if compact:
                rank, sa, rank_s, count = _jit_compact_block(
                    mesh, chunk, p, idx, self.fan, m_cap, tuple(hs)
                )(rank, sa, rank_s, count)
                self.compact_rounds_run += len(hs)
            else:
                rank, sa, rank_s, count = _jit_block(
                    mesh, chunk, p, idx, tuple(hs), self.fan
                )(rank, sa, rank_s, count)
            self.rounds_run += len(hs)
            if self._tracer is not None:
                self._tracer.log(
                    f"block rounds={self.rounds_run} h->{h} "
                    f"compact={compact} tied={int(count)}"
                )
                self._tracer.dump(f"rank after {self.rounds_run} rounds",
                                  np.asarray(rank))
            if self.rounds_run > 2 * n_pad.bit_length() + 2 * ROUNDS_PER_DISPATCH:
                raise AssertionError(
                    "global doubling failed to converge — bug"
                )
        self.rank = rank  # ISA over the padded text, text order, sharded
        self._sa_sharded = sa  # sorted order, sharded
        self._sa_host: Optional[np.ndarray] = None

    def verify(self) -> None:
        """Distributed O(n/P)-per-device verification — no host SA.

        Checks, entirely on the mesh (one distributed sort + local
        compares + boundary ppermutes), that the stored sharded state is
        THE suffix array of the padded text: rank is a permutation,
        the ISA recurrence holds at every adjacent pair of the global
        sorted order, and the sharded SA is rank's inverse. Raises
        `NotSorted` like the single-device verifier (ref:
        crates/sacabase/src/lib.rs:127-149); the sharded analog of the C
        sufcheck oracle (ref: c-sources/utils.c:160-241). Unlike
        `suffix_array()`, this never materializes a full-width array on
        any single device, so it works for texts larger than one chip's
        HBM — the regime this engine exists for.
        """
        from stringsearch_tpu.core.types import NotSorted

        ok, bad, kind = _jit_verify(self.mesh, self.chunk_len, self.idx)(
            self.text_padded, self.rank, self._sa_sharded
        )
        if bool(ok):
            return
        kind = int(kind)
        if kind == 0:
            raise NotSorted(0, 0, "global rank is not a permutation")
        if kind == 1:
            raise NotSorted(
                0, 0, "sharded SA is not the inverse of the global rank"
            )
        # Reported position: global sorted-order slot minus the pad
        # count. Pad suffixes USUALLY occupy exactly the first `pad`
        # slots, but a real suffix of leading 0x00 bytes can interleave
        # with them, so for NUL-bearing texts the position is
        # approximate (off by at most the number of interleaved NUL
        # runs); detection itself is exact either way. The raw padded
        # slot rides in the message for exact diagnosis.
        i = max(int(bad) - self.pad, 0)
        raise NotSorted(
            max(i - 1, 0), i,
            f"adjacent-order violation at padded sorted slot {int(bad)} "
            f"(position estimate assumes pad suffixes fill the first "
            f"{self.pad} slots; approximate if the text contains NULs)",
        )

    def comm_report(self):
        """Exact per-device communication volume of THIS build
        (parallel/comm_model.py; uses the actual rounds_run)."""
        from stringsearch_tpu.parallel.comm_model import report_for

        return report_for(self)

    def suffix_array(self) -> np.ndarray:
        """The exact SA of the (unpadded) text as a host array [n]."""
        if self._sa_host is None:
            full = np.asarray(jax.device_get(self._sa_sharded))
            # pad suffixes sort strictly first; drop them
            self._sa_host = full[self.pad :]
        return self._sa_host

    def longest_substring_match_batch(self, needles, text_mode: str = "replicated"):
        """Batched LCS query against the sharded global SA — distributed.

        Each shard binary-searches its contiguous slice of the global
        sorted order; the per-shard candidates reduce with an
        all-gather + argmax. No device ever materializes the whole SA.
        Same LCS-of-needle-prefix semantics as the single-device path
        (ref: crates/sacabase/src/lib.rs:39-99).

        text_mode:
          "replicated" (default) — the padded text is replicated per
          device for the binary search's random reads; fastest, but
          per-chip HBM bounds the queryable size.
          "sharded" — the text stays sharded and every probe's window
          is fetched with the all-to-all distributed gather
          (parallel/gather.py); one collective per search step, but no
          device ever holds more than text/P — the mode for texts
          larger than one chip's HBM.
        """
        from stringsearch_tpu.core.search import (
            _ceil_log2,
            _needle_batch_to_windows,
        )
        from stringsearch_tpu.core.types import LongestCommonSubstring

        if text_mode not in ("replicated", "sharded"):
            raise ValueError(f"unknown text_mode {text_mode!r}")
        if not needles:
            return []
        padded, _lens, width = _needle_batch_to_windows(needles)
        needles_dev = jnp.asarray(padded)
        n, chunk = self.n, self.chunk_len
        n_pad = chunk * self.num_shards
        steps = _ceil_log2(chunk + 1) + 1
        m_width = padded.shape[-1]
        query = _jit_query(self.mesh, text_mode, chunk, n, n_pad, steps,
                           m_width)
        start, length = query(self._sa_sharded, self.text_padded, needles_dev)
        both = np.asarray(jnp.stack([start, length]))  # one host fetch
        start, length = both[0], both[1]
        host = np.asarray(self.text_padded[: self.n])
        return [
            LongestCommonSubstring(host, int(start[i]), int(length[i]))
            for i in range(len(needles))
        ]

    def longest_substring_match(self, needle):
        return self.longest_substring_match_batch([needle])[0]

    def sa_search_batch(self, needles, text_mode: str = "replicated"):
        """Batched exact-occurrence search: [(count, left_slot)] per
        needle — distributed over the mesh (see `_jit_search`).

        Semantics are identical to the single-device `sa_search` / the
        reference's flat-SA search (ref: c-sources/utils.c:244-325):
        `count` = number of suffixes of the WHOLE text whose prefix is
        the needle, `left_slot` = the slot of the leftmost occurrence in
        the (unpadded) global SA — byte-compatible with the oracle's
        `sa_search` output on the same text. `text_mode` as in
        `longest_substring_match_batch` ("replicated" | "sharded").
        """
        from stringsearch_tpu.core.search import (
            _ceil_log2,
            _needle_batch_to_windows,
        )

        if text_mode not in ("replicated", "sharded"):
            raise ValueError(f"unknown text_mode {text_mode!r}")
        if not needles:
            return []
        padded, lens, _w = _needle_batch_to_windows(needles)
        chunk = self.chunk_len
        steps = _ceil_log2(chunk + 1) + 1
        search = _jit_search(self.mesh, text_mode, chunk, self.n,
                             chunk * self.num_shards, steps,
                             padded.shape[-1])
        count, left = search(self._sa_sharded, self.text_padded,
                             jnp.asarray(padded), jnp.asarray(lens))
        both = np.asarray(jnp.stack([count, left]))  # one host fetch
        count, left = both[0], both[1]
        out = []
        for i, nd in enumerate(needles):
            if len(bytes(nd)) == 0:
                # empty needle: every real suffix matches the empty
                # prefix (the kernel's all-masked compare degenerates)
                out.append((self.n, 0))
            else:
                out.append((int(count[i]), int(left[i]) - self.pad))
        return out

    def sa_search(self, needle, text_mode: str = "replicated"):
        return self.sa_search_batch([needle], text_mode)[0]

    def sa_simplesearch(self, c: int, text_mode: str = "replicated"):
        """(count, left_slot) of suffixes starting with byte `c` — the
        distributed `sa_simplesearch` (ref: c-sources/utils.c:328-381),
        expressed as a 1-byte `sa_search` (the dedicated searchsorted
        kernel is a single-device optimization; here the probe cost is
        already one collective-free window fetch per step)."""
        return self.sa_search(bytes([c]), text_mode)

    def to_suffix_array_index(self):
        """Materialize a single-device `SuffixArray` for the query API."""
        from stringsearch_tpu.core.types import SuffixArray

        text = self.text_padded[: self.n]
        return SuffixArray(text, jnp.asarray(self.suffix_array()))


def build_global(text: BytesLike, mesh: Mesh, idx=_I32,
                 depth: int = INITIAL_DEPTH, fan: int = 3,
                 tracer=None, compaction: bool = True) -> GlobalSuffixArray:
    """Build the exact global SA of `text` sharded over `mesh`'s "parts".

    Pass a `harness.tracing.Tracer` to dump the sharded rank state per
    round block (the distributed analog of the engines' `--trace`).
    `compaction=False` pins the full-width round path (differential
    testing of the compacted rounds)."""
    return GlobalSuffixArray(text, mesh, idx=idx, depth=depth, fan=fan,
                             tracer=tracer, compaction=compaction)
