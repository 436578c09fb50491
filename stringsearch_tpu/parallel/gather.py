"""Distributed gather over a sharded array — all-to-all request routing.

The primitive the reference never needed (its data always fits one
node): read `out[i] = values[idx[i]]` where `values` is sharded over the
mesh's "parts" axis and every shard holds its own batch of global
indices. Formulation with fully static shapes:

  1. each shard sorts its requests by owner shard (one small local
     sort), computes each request's rank within its owner segment, and
     scatters requests into a [P, cap] send buffer — capacity `cap` per
     destination equals the local request count m, so NO distribution of
     requests can overflow (the worst case is all m requests owned by
     one shard);
  2. one `all_to_all` moves request buffers to their owners;
  3. owners answer with a plain local take;
  4. a reverse `all_to_all` returns answers, and the original request
     order is restored by scattering through the sort's permutation.

Cost: O(m log m) local sort + 2 all-to-alls of P*m elements + O(P*m)
local gather. For m requests over P shards that is the static-shape
price of not holding the array replicated; `idx` out of range is
clamped to the array (callers mask).

Used by `GlobalSuffixArray` text-sharded queries (global_sa.py) so the
binary search can read text windows without replicating the text per
device — per-chip HBM then bounds only text/P, not the whole text.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sharded_gather(values: jnp.ndarray, idx: jnp.ndarray, axis_name: str):
    """out[i] = global_values[idx[i]] for sharded values, per-shard idx.

    values: [L] — this shard's slice of the global [P*L] array.
    idx: [m] int32 global indices (clamped into [0, P*L)).
    Returns [m] with values.dtype. Runs inside shard_map.
    """
    p = jax.lax.axis_size(axis_name)
    length = values.shape[0]
    m = idx.shape[0]
    idx = jnp.clip(idx, 0, p * length - 1)
    owner = idx // length
    off = (idx % length).astype(jnp.int32)

    # sort requests by owner; remember where each came from
    owner_s, off_s, src_s = jax.lax.sort(
        (owner.astype(jnp.int32), off, jnp.arange(m, dtype=jnp.int32)),
        num_keys=1,
    )
    # rank of each request within its owner segment
    i = jnp.arange(m, dtype=jnp.int32)
    seg_start = jnp.searchsorted(owner_s, owner_s, side="left")
    rank = i - seg_start

    # send buffer [P, m]: slot (d, r) = the r-th request owned by d
    # (unused slots carry offset 0; their answers are never read back)
    send = jnp.full((p, m), 0, jnp.int32)
    send = send.at[owner_s, rank].set(off_s, mode="drop")

    # route to owners: recv[s] = offsets requested BY shard s of my slice
    recv = jax.lax.all_to_all(send, axis_name, split_axis=0,
                              concat_axis=0, tiled=True)
    answers = jnp.take(values, recv.reshape(-1), mode="clip").reshape(p, m)
    # route answers back: back[d] = my requests' answers from shard d
    back = jax.lax.all_to_all(answers, axis_name, split_axis=0,
                              concat_axis=0, tiled=True)

    # un-permute: request src_s[j] (sorted position j, owner owner_s[j],
    # rank rank[j]) was answered at back[owner_s[j], rank[j]]
    got_sorted = back[owner_s, rank]
    return jnp.zeros((m,), values.dtype).at[src_s].set(got_sorted, mode="drop")


def sharded_gather_capped(values: jnp.ndarray, idx: jnp.ndarray,
                          axis_name: str, cap: int):
    """`sharded_gather` with a BALANCED per-owner request capacity.

    The full-capacity gather sizes its send buffer [P, m] so no request
    distribution can overflow — safe, but its all_to_all moves P*m
    elements per device even when requests are spread evenly. This
    variant uses [P, cap] buffers (cap ~ 2*ceil(m/P) for near-uniform
    request distributions — the distributed compaction's regime) and
    returns (out, overflow): when ANY shard's requests concentrate more
    than `cap` onto one owner, the replicated `overflow` flag is True
    and `out` is garbage — callers must branch to a fallback (the
    compacted round falls back to a full-width round). Wire: 2*P*cap
    elements per device instead of 2*P*m.
    """
    p = jax.lax.axis_size(axis_name)
    length = values.shape[0]
    m = idx.shape[0]
    idx = jnp.clip(idx, 0, p * length - 1)
    owner = (idx // length).astype(jnp.int32)
    off = (idx % length).astype(jnp.int32)
    owner_s, off_s, src_s = jax.lax.sort(
        (owner, off, jnp.arange(m, dtype=jnp.int32)), num_keys=1
    )
    i = jnp.arange(m, dtype=jnp.int32)
    seg_start = jnp.searchsorted(owner_s, owner_s, side="left").astype(
        jnp.int32)
    rank = i - seg_start
    overflow = jax.lax.psum(
        jnp.any(rank >= cap).astype(jnp.int32), axis_name) > 0
    send = jnp.zeros((p, cap), jnp.int32)
    send = send.at[owner_s, jnp.minimum(rank, cap - 1)].set(
        off_s, mode="drop")
    recv = jax.lax.all_to_all(send, axis_name, split_axis=0,
                              concat_axis=0, tiled=True)
    answers = jnp.take(values, recv.reshape(-1), mode="clip").reshape(
        p, cap)
    back = jax.lax.all_to_all(answers, axis_name, split_axis=0,
                              concat_axis=0, tiled=True)
    got_sorted = back[owner_s, jnp.minimum(rank, cap - 1)]
    out = jnp.zeros((m,), values.dtype).at[src_s].set(
        got_sorted, mode="drop")
    return out, overflow


def sharded_gather_windows(values: jnp.ndarray, starts: jnp.ndarray,
                           width: int, axis_name: str):
    """Fetch [B, width] windows values[start:start+width] from a sharded
    array (windows may span shard boundaries). Out-of-range reads clamp;
    callers mask with their own length logic."""
    b = starts.shape[0]
    flat = (starts[:, None] + jnp.arange(width, dtype=starts.dtype)[None, :])
    out = sharded_gather(values, flat.reshape(-1).astype(jnp.int32), axis_name)
    return out.reshape(b, width)
