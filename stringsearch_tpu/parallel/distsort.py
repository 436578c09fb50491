"""Distributed multi-key sort over a device mesh — bitonic merge-split.

The device-mesh building block the reference has no analog of: its only
parallelism is rayon threads over *independent* partitions
(ref: crates/sacapart/src/lib.rs:45-51), so cross-partition order is never
reconciled. The global suffix-array engine (parallel/global_sa.py) needs a
*true global sort* of key tuples that live sharded across chips.

Design: chunk-level bitonic merge-split — the classic distributed sort for
fixed-size shards:

- each device locally sorts its [L] chunk (XLA sort);
- the bitonic network over P chunk-slots runs comparator stages; each
  comparator is: exchange chunks with a partner (`ppermute`),
  merge the two sorted chunks (one 2L XLA sort), keep the lower or upper
  half depending on network direction;
- P power-of-two, all shapes static, O(log^2 P) stages, each stage moving
  exactly L elements per key array per device — no sample-based capacity
  bounds to violate (a sample sort's all-to-all can overflow any fixed
  per-pair capacity on adversarial/all-equal data; merge-split cannot).

Sample-sort considered for the MAIN sort and deliberately not taken
(round 4): splitter exchange + one all_to_all would cut the per-sort
wire volume ~3x at P=8 (2*L vs stages(8)=6*L per operand — the comm
model's dominant term), BUT sample sort produces VARIABLE per-shard
counts, and this stack's whole design is static shapes: equalizing
shards afterwards needs a rebalancing pass with its own data-dependent
capacities and fallbacks stacked on the routing fallback, each a
replicated-branch collective hazard. The PERMUTATION special case —
where per-shard counts are exactly L by construction — is taken instead
(`redistribute_permutation` below), which removes the redistribute
sort's merge-split volume outright with a single safe fallback.

All functions here run INSIDE `shard_map` with a named mesh axis.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp


def _merge_halves(mine, theirs, mine_first: jnp.ndarray, keep_low: jnp.ndarray, num_keys: int):
    """Merge two per-device sorted tuples of [L] arrays; keep one half.

    Both partners MUST materialize the identical merged list, or ties that
    straddle the split point get duplicated on one side and dropped on the
    other (stable sort breaks ties by input position, and the partners see
    the two chunks in opposite positions). `mine_first` pins a canonical
    concatenation order — the lower-indexed device's chunk first on both
    sides. keep_low / mine_first are traced bool scalars.
    """
    length = mine[0].shape[0]
    cat = tuple(
        jnp.where(
            mine_first,
            jnp.concatenate([a, b]),
            jnp.concatenate([b, a]),
        )
        for a, b in zip(mine, theirs)
    )
    merged = jax.lax.sort(cat, num_keys=num_keys)
    low = tuple(a[:length] for a in merged)
    high = tuple(a[length:] for a in merged)
    return tuple(
        jnp.where(keep_low, lo, hi) for lo, hi in zip(low, high)
    )


def sharded_sort(
    operands: Sequence[jnp.ndarray],
    axis_name: str,
    num_keys: int = 1,
):
    """Globally sort sharded arrays by their first `num_keys` operands.

    Each operand is the *local* [L] shard of a global [P*L] array. After the
    call, the logical concatenation of shards along the mesh axis is sorted
    lexicographically by the key operands; value operands are permuted
    alongside. The sort is NOT stable across equal full key tuples — make
    keys unique (e.g. append a position operand as the last key) when
    determinism matters.
    """
    operands = tuple(operands)
    p = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)

    # local sort
    operands = jax.lax.sort(operands, num_keys=num_keys)
    if p == 1:
        return operands

    if p & (p - 1):
        raise ValueError(f"sharded_sort needs a power-of-two axis, got {p}")

    k = 2
    while k <= p:
        j = k // 2
        while j >= 1:
            partner = me ^ j
            # ascending region of the bitonic network
            ascending = (me & k) == 0
            perm = [(i, i ^ j) for i in range(p)]
            theirs = tuple(
                jax.lax.ppermute(a, axis_name, perm) for a in operands
            )
            mine_first = me < partner
            keep_low = mine_first == ascending
            operands = _merge_halves(operands, theirs, mine_first, keep_low, num_keys)
            j //= 2
        k *= 2
    return operands


def redistribute_cap(p: int, chunk_elems: int, cap_factor: int = 2) -> int:
    """Static per-(source, dest) capacity of the all_to_all redistribute.

    Shared with parallel/comm_model.py so the comm model's volume
    arithmetic can never drift from the implementation."""
    return int(min(chunk_elems, cap_factor * (-(-chunk_elems // p))))


def redistribute_permutation(gidx, operands, axis_name: str,
                             cap_factor: int = 2):
    """Route elements to shard `gidx // L`, slot `gidx % L` — the cheap
    replacement for `sharded_sort((gidx, *operands), num_keys=1)` when
    `gidx` is a permutation of [0, P*L).

    The merge-split redistribute moves stages(P) * L elements per operand
    per device; here ONE `all_to_all` moves ~cap_factor * L instead (at
    P = 8 that cuts the redistribute's wire volume 3x, see
    parallel/comm_model.py). Per-(source, dest) counts vary, so the send
    buffer has static capacity cap = cap_factor * ceil(L/P) per pair; if
    ANY pair overflows (adversarial orders — e.g. already-sorted text
    makes shard s's elements all route to shard s), a replicated psum'd
    flag routes EVERY device to the merge-split fallback, which has no
    capacity to violate. Uniform branch choice keeps the collectives
    inside the branches deadlock-free.

    Returns the operand tuple in destination order (slot gidx % L).
    Runs inside shard_map.
    """
    operands = tuple(operands)
    p = jax.lax.axis_size(axis_name)
    length = gidx.shape[0]
    if p == 1:
        srt = jax.lax.sort((gidx,) + operands, num_keys=1)
        return srt[1:]
    dest = (gidx // length).astype(jnp.int32)
    arrs = jax.lax.sort((dest, gidx) + operands, num_keys=2)
    dest_s, gidx_s, ops_s = arrs[0], arrs[1], arrs[2:]
    i = jnp.arange(length, dtype=jnp.int32)
    seg_start = jnp.searchsorted(dest_s, dest_s, side="left").astype(
        jnp.int32)
    rank = i - seg_start
    cap = redistribute_cap(p, length, cap_factor)
    overflow = jax.lax.psum(
        jnp.any(rank >= cap).astype(jnp.int32), axis_name) > 0

    def fast(_):
        send_g = jnp.full((p, cap), -1, gidx_s.dtype)
        send_g = send_g.at[dest_s, rank].set(gidx_s, mode="drop")
        recv_g = jax.lax.all_to_all(send_g, axis_name, split_axis=0,
                                    concat_axis=0, tiled=True)
        valid = recv_g >= 0
        off = jnp.where(valid, recv_g % length, length).reshape(-1)
        outs = []
        for op_s in ops_s:
            send = jnp.zeros((p, cap), op_s.dtype)
            send = send.at[dest_s, rank].set(op_s, mode="drop")
            recv = jax.lax.all_to_all(send, axis_name, split_axis=0,
                                      concat_axis=0, tiled=True)
            outs.append(
                jnp.zeros((length,), op_s.dtype)
                .at[off].set(recv.reshape(-1), mode="drop")
            )
        return tuple(outs)

    def slow(_):
        srt = sharded_sort((gidx,) + operands, axis_name, num_keys=1)
        return srt[1:]

    return jax.lax.cond(overflow, slow, fast, None)


def rank_interval_sort(operands, axis_name: str, num_keys: int,
                       cap_factor: int = 2):
    """Global sort whose primary key is a HEAD-SLOT RANK — one
    all_to_all + local sort + one boundary ppermute instead of the
    merge-split network's S(P) full-chunk exchanges (at P=8: ~6x less
    wire on the sort itself; see parallel/comm_model.py).

    Precondition (what makes interval routing exact): operand[0] holds
    head-slot ranks of the CURRENT global order — the value r of an
    element is the global slot of its tie-group's first member, so the
    element's final sorted slot lies in [r, r + group_size). Routing to
    shard r // L therefore sends every element to the shard where its
    group STARTS; after a local sort, each shard's elements occupy the
    contiguous global slot range [s*L + overhang_s, (s+1)*L +
    overhang_{s+1}) where overhang_s = (elements of lower intervals
    spilling past slot s*L) >= 0, and ONE neighbor ppermute of the
    right-aligned tail repairs the boundaries exactly.

    Fast-path capacities (static; replicated overflow flags fall back
    to `sharded_sort`, which has none):
      * per-(source, dest) all_to_all capacity `redistribute_cap`
        (near-balanced rank distributions fit; adversarial skew —
        e.g. few giant tie groups — overflows);
      * boundary-shift capacity = the same cap (overhang < group size,
        so a tie group larger than the cap straddling a shard boundary
        overflows).

    Returns operands globally sorted by the first `num_keys` operands
    (ties broken arbitrarily unless the key tuple is unique — append a
    position operand, as `sharded_sort` requires too). Runs inside
    shard_map. (What is being surpassed: the reference's rayon
    partitions never reconcile cross-shard order at all,
    ref: crates/sacapart/src/lib.rs:45-51.)
    """
    operands = tuple(operands)
    p = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)
    length = operands[0].shape[0]
    if p == 1:
        return jax.lax.sort(operands, num_keys=num_keys)
    if p == 2:
        # S(2) = 1 merge-split stage moves L per operand; the interval
        # route's cap clamps to L at P=2, so its all_to_all + boundary
        # repair would move ~3L — merge-split wins below P=4
        # (parallel/comm_model.py has the same branch)
        return sharded_sort(operands, axis_name, num_keys=num_keys)
    rank = operands[0]
    dtype = rank.dtype
    import numpy as np

    sent = jnp.asarray(np.iinfo(np.dtype(dtype)).max, dtype)
    dest = jnp.clip(rank // length, 0, p - 1).astype(jnp.int32)
    srt = jax.lax.sort((dest,) + operands, num_keys=1)
    dest_s, ops_s = srt[0], srt[1:]
    i = jnp.arange(length, dtype=jnp.int32)
    seg_start = jnp.searchsorted(dest_s, dest_s, side="left").astype(
        jnp.int32)
    seg_rank = i - seg_start
    cap = redistribute_cap(p, length, cap_factor)
    overflow = jax.lax.psum(
        jnp.any(seg_rank >= cap).astype(jnp.int32), axis_name) > 0

    def fast(_):
        # receive buffer = p * cap rows (every pair at full capacity)
        recvs = []
        for k, op_s in enumerate(ops_s):
            fill = sent if k == 0 else jnp.asarray(0, op_s.dtype)
            send = jnp.full((p, cap), fill, op_s.dtype)
            send = send.at[dest_s, seg_rank].set(op_s, mode="drop")
            recv = jax.lax.all_to_all(send, axis_name, split_axis=0,
                                      concat_axis=0, tiled=True)
            recvs.append(recv.reshape(-1))
        # local sort of the padded buffer; pads (rank = sent) sort last
        srt2 = jax.lax.sort(tuple(recvs), num_keys=max(num_keys, 1))
        n_valid = jnp.sum((srt2[0] != sent).astype(jnp.int32))
        prefix = exclusive_shard_offset(n_valid, axis_name)
        oh_me = prefix - me * length          # my head deficit
        oh_next = prefix + n_valid - (me + 1) * length  # my tail spill
        bad = (oh_me < 0) | (oh_me > cap) | (oh_next < 0) | (oh_next > cap)
        bad = jax.lax.psum(bad.astype(jnp.int32), axis_name) > 0
        # shard p-1 has oh_next == 0 by construction (prefix+valid == n)

        def repair(_):
            perm = [(t, (t + 1) % p) for t in range(p)]
            outs = []
            zero_head = jnp.zeros((cap,), jnp.int32)
            for op2 in srt2:
                ext = jnp.concatenate([zero_head.astype(op2.dtype), op2])
                # right-aligned tail [n_valid - cap, n_valid) of the
                # valid region; receivers read only the last oh slots
                tail = jax.lax.dynamic_slice_in_dim(ext, n_valid, cap)
                head = jax.lax.ppermute(tail, axis_name, perm)
                head = jnp.where(me == 0, jnp.zeros_like(head), head)
                asm = jnp.concatenate([head, op2])
                outs.append(jax.lax.dynamic_slice_in_dim(
                    asm, cap - oh_me, length))
            return tuple(outs)

        def fb(_):
            return sharded_sort(operands, axis_name, num_keys=num_keys)

        return jax.lax.cond(bad, fb, repair, None)

    def slow(_):
        return sharded_sort(operands, axis_name, num_keys=num_keys)

    return jax.lax.cond(overflow, slow, fast, None)


def exclusive_shard_offset(local_sum: jnp.ndarray, axis_name: str):
    """Sum of `local_sum` over all lower-indexed shards (exclusive scan).

    Used to turn per-shard cumsums into global cumsums: a one-hot
    all-gather of the scalar partials followed by a masked sum, so the
    collective is a single small all-gather.
    """
    p = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)
    partials = jax.lax.all_gather(local_sum, axis_name)  # [P]
    mask = jnp.arange(p, dtype=jnp.int32) < me
    return jnp.sum(jnp.where(mask, partials, 0), axis=0)


def shift_in_from_prev(x_last: jnp.ndarray, axis_name: str, fill):
    """Bring the previous shard's boundary value in (for neighbor diffs).

    x_last: this shard's last element (scalar or [k]); returns the
    previous shard's x_last, with `fill` on shard 0.
    """
    p = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % p) for i in range(p)]
    prev = jax.lax.ppermute(x_last, axis_name, perm)
    return jnp.where(me == 0, jnp.full_like(prev, fill), prev)
