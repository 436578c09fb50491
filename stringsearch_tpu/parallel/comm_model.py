"""Communication volume of the distributed global-SA build.

Every collective in the build moves a statically known number of bytes
(all shapes are static), so the per-device communication volume is exact
arithmetic, not sampling. The virtual-CPU mesh validates correctness
but its `ppermute` is a host memcpy, so this byte count is what a CPU
run can say about the collectives; their time comes only from a
profiler trace on the cards. (What is being surpassed: the reference's
only parallelism is rayon threads over independent partitions with
zero reconciliation, ref: crates/sacapart/src/lib.rs:45-51.)

Communication inventory of one `GlobalSuffixArray` build (see
parallel/global_sa.py, parallel/distsort.py):

  initial:   1 sharded_sort over (depth/4 key words + gidx)   [nk+1 ops]
             + 1 all_to_all permutation redistribute           [2 ops]
             + 1 neighbor ppermute of `depth` bytes (window)
  per round: (fan-1) rank-shift fetches, <= 2 chunk ppermutes each
             + 1 rank_interval_sort over (rank, shifts, gidx)
               [fan+1 ops: one all_to_all at cap 2*ceil(L/P) per pair
                + one boundary ppermute of cap elements]
             + 1 all_to_all permutation redistribute (rank)    [2 ops]
             + O(1) scalar all_gathers (head carries, done flag)

One merge-split sharded_sort (the initial sort and every fallback) of P
power-of-two shards is bitonic with S(P) = log2(P)*(log2(P)+1)/2
comparator stages; each stage exchanges the device's FULL chunk of
every operand with its partner (ppermute), so a device sends (and
receives) S(P) * L * ops * width bytes per sort. The round-5
rank_interval_sort replaces that with ~2L elements per operand per
sort on the fast path — an S(P)-fold cut in bytes sent.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def merge_split_stages(p: int) -> int:
    """Comparator stages of the bitonic merge-split network over p shards."""
    if p <= 1:
        return 0
    lg = int(math.log2(p))
    if 1 << lg != p:
        raise ValueError("power-of-two shard count required")
    return lg * (lg + 1) // 2


def sharded_sort_bytes_per_device(p: int, chunk_elems: int, n_ops: int,
                                  width: int = 4) -> int:
    """Bytes SENT per device by one sharded_sort (receive volume equal)."""
    return merge_split_stages(p) * chunk_elems * n_ops * width


@dataclass
class CommReport:
    """Per-device communication totals for one global build."""

    p: int
    chunk_elems: int
    rounds: int
    fan: int
    depth: int
    idx_width: int
    initial_bytes: int
    per_round_bytes: int
    total_bytes: int

    def projected_comm_seconds(self, link_gbytes_per_s: float) -> float:
        """Wire time if every send leaves the device at the given rate
        (an all-to-all fabric: every partner is one hop away)."""
        return self.total_bytes / (link_gbytes_per_s * 1e9)

    def projected_efficiency(self, compute_seconds_per_chip: float,
                             link_gbytes_per_s: float) -> float:
        """compute / (compute + comm), the model's scaling-efficiency bound.

        `compute_seconds_per_chip` = the measured single-chip build time
        of one chunk-sized problem (the work that doesn't shrink away);
        overlap of compute with transfers is NOT assumed, so this is a
        lower bound on efficiency from the comm side.
        """
        comm = self.projected_comm_seconds(link_gbytes_per_s)
        return compute_seconds_per_chip / (compute_seconds_per_chip + comm)


def rank_interval_sort_bytes_per_device(p: int, chunk_elems: int,
                                        n_ops: int, width: int = 4,
                                        cap_factor: int = 2) -> int:
    """Bytes sent per device by one `rank_interval_sort` fast path: one
    all_to_all of n_ops [P, cap] buffers (cap imported from the
    implementation so the model cannot drift) plus the boundary-repair
    ppermute of one cap-row per operand. The adversarial fallback is a
    full merge-split sort (`sharded_sort_bytes_per_device`); on
    text-like data the fast path is what runs (fuzz exercises both)."""
    from stringsearch_tpu.parallel.distsort import redistribute_cap

    cap = redistribute_cap(p, chunk_elems, cap_factor)
    return (cap * p + cap) * n_ops * width


def compact_round_bytes_per_device(p: int, chunk_elems: int,
                                   fan: int = 3, width: int = 4,
                                   compact_div: int = 4) -> int:
    """Bytes sent per device by one COMPACTED round (global_sa.py
    `_compact_round`) — the adversarial-input path whose volume is
    bounded by the live tied population, not n_pad.

    Inventory (M = L // compact_div, cap = 2*ceil(2M/P)):
      * straddle-repair ppermute: (M + 1) elements x 2 operands
      * shifted-key capped gathers: (fan-1) x 2 all_to_alls of [P, cap]
      * SA/sorted-rank spill ppermute: 3 x [2M]
      * text-order rank write-back: 2 all_to_alls of [P, cap]
    At P = 8, fan = 3, compact_div = 4 this is ~4.4L bytes vs the full
    interval round's ~15L element-equivalents — and it shrinks linearly
    with the tied population via compact_div. Not part of the default
    build report: on enwik-class text the compacted phase never
    triggers (tied@48B = 0); it exists for the long-run / tiny-alphabet
    regime (trsort's skip-run compression re-expressed,
    ref: crates/divsufsort/src/trsort.rs:1363-1410).
    """
    m = max(chunk_elems // compact_div, 1)
    cap = 2 * (-(-2 * m // p))
    straddle = 2 * m * width
    gathers = (fan - 1) * 2 * p * cap * width
    spill = 3 * 2 * m * width
    writeback = 2 * p * cap * width
    return straddle + gathers + spill + writeback


def redistribute_bytes_per_device(p: int, chunk_elems: int,
                                  n_payloads: int = 1, width: int = 4,
                                  cap_factor: int = 2) -> int:
    """Bytes sent per device by `redistribute_permutation`'s fast path:
    one all_to_all of (gidx + payload) buffers at the implementation's
    static per-pair capacity (imported, so the model cannot drift from
    the code). The adversarial fallback is a full merge-split sort
    (`sharded_sort_bytes_per_device(p, L, 1 + n_payloads)`); on
    text-like data the fast path is what runs."""
    from stringsearch_tpu.parallel.distsort import redistribute_cap

    cap = redistribute_cap(p, chunk_elems, cap_factor)
    return cap * p * (1 + n_payloads) * width


def global_build_comm(n: int, p: int, depth: int = 16, fan: int = 3,
                      rounds: int | None = None, idx_width: int = 4,
                      a2a_redistribute: bool = True,
                      interval_round_sort: bool = True) -> CommReport:
    """Exact per-device communication volume of a GlobalSuffixArray build.

    `rounds`: pass the actual `GlobalSuffixArray.rounds_run` when known;
    defaults to the schedule bound ceil(log_fan(n_pad/depth)) + 1 (the
    marker round), matching global_sa's h schedule.
    `a2a_redistribute`: model the all_to_all rank redistribute (the
    shipped fast path) rather than the merge-split fallback.
    `interval_round_sort`: model the round sort as the shipped
    rank-interval all_to_all route (round 5) rather than the bitonic
    merge-split fallback.
    """
    chunk = max(-(-max(n, p) // p), 4)
    n_pad = chunk * p
    depth = max(4, min(depth, chunk) // 4 * 4)
    if rounds is None:
        rounds = 1 + max(0, math.ceil(
            math.log(max(n_pad / depth, 1), fan)))
    nk = depth // 4
    if a2a_redistribute:
        redist = redistribute_bytes_per_device(p, chunk, 1, idx_width)
    else:
        redist = sharded_sort_bytes_per_device(p, chunk, 2, idx_width)
    if interval_round_sort and p > 2:
        # the implementation's own branch: interval routing only for
        # P >= 4, where it beats S(P) merge-split stages (distsort.py)
        round_sort = rank_interval_sort_bytes_per_device(
            p, chunk, fan + 1, idx_width)
    else:
        round_sort = sharded_sort_bytes_per_device(
            p, chunk, fan + 1, idx_width)
    init = (
        sharded_sort_bytes_per_device(p, chunk, nk + 1)
        + redist
        + depth  # neighbor window ppermute
    )
    # shifted-key fetches: while k*h < L the source window spans only
    # the immediate next shard (from_offset(0) is free in the code), so
    # a shifted key costs ONE chunk ppermute; saturated tail rounds
    # (k*h >= L) pay two. Count exactly from the h schedule.
    per_round = (
        (fan - 1) * chunk * idx_width  # typical (h < L) round
        + round_sort
        + redist
    )
    hop_extra = 0
    h = depth
    for _ in range(rounds):
        for k in range(1, fan):
            if k * h >= chunk:  # second neighbor hop needed
                hop_extra += chunk * idx_width
        h = min(h * fan, n_pad)
    total = init + rounds * per_round + hop_extra
    return CommReport(p=p, chunk_elems=chunk, rounds=rounds, fan=fan,
                      depth=depth, idx_width=idx_width, initial_bytes=init,
                      per_round_bytes=per_round, total_bytes=total)


def report_for(gsa) -> CommReport:
    """CommReport for an already-built GlobalSuffixArray (actual rounds)."""
    import numpy as np

    idx_width = int(np.dtype(gsa.idx).itemsize)
    return global_build_comm(
        gsa.n, gsa.num_shards, depth=gsa.depth, fan=gsa.fan,
        rounds=gsa.rounds_run, idx_width=idx_width,
    )
