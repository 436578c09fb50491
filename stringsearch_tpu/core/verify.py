"""Suffix-array verification oracle, O(n) and fully vectorized.

Capability parity with the reference's two verifiers:
- `sacabase::verify` — O(n·L) pairwise adjacent-suffix compare
  (ref: crates/sacabase/src/lib.rs:127-149), and
- the stronger C `sufcheck` — 3-stage O(n) induced check
  (ref: c-sources/utils.c:160-241).

Data-parallel design: instead of comparing adjacent suffixes byte-by-byte
(data-dependent loop lengths), we use the classic O(n) ISA-recurrence
characterisation, which is three gathers and a reduction:

  SA is *the* suffix array of T  ⟺
    (1) SA is a permutation of [0, n)
    (2) for all adjacent entries i:  T[SA[i]] <= T[SA[i+1]]
    (3) if T[SA[i]] == T[SA[i+1]]:  rank(SA[i]+1) < rank(SA[i+1]+1)
        where rank(p) = ISA[p] and rank(n) = -1 (the empty suffix
        sorts first).

Stage (2)+(3) is exactly sufcheck's stages 2 and 3 fused into one pass.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from stringsearch_tpu.core.types import NotSorted, as_text_array


@jax.jit
def verify_flags(text: jnp.ndarray, sa: jnp.ndarray):
    """Device-side check. Returns (perm_ok [n] bool, adj_ok [n-1] bool)."""
    n = text.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    counts = jnp.zeros((n,), jnp.int32).at[jnp.clip(sa, 0, n - 1)].add(1)
    perm_ok = (counts == 1) & jnp.all((sa >= 0) & (sa < n))

    isa = jnp.zeros((n,), jnp.int32).at[jnp.clip(sa, 0, n - 1)].set(iota)
    first = jnp.take(text, jnp.clip(sa, 0, n - 1)).astype(jnp.int32)
    nxt = sa + 1
    rank_next = jnp.where(nxt < n, jnp.take(isa, jnp.clip(nxt, 0, n - 1)), -1)
    adj_ok = (first[:-1] < first[1:]) | (
        (first[:-1] == first[1:]) & (rank_next[:-1] < rank_next[1:])
    )
    return perm_ok, adj_ok


@jax.jit
def is_valid(text: jnp.ndarray, sa: jnp.ndarray) -> jnp.ndarray:
    """Scalar bool validity — usable inside jitted pipelines."""
    perm_ok, adj_ok = verify_flags(text, sa)
    return jnp.all(perm_ok) & jnp.all(adj_ok)


def verify(text, sa) -> None:
    """Raise NotSorted if `sa` is not the suffix array of `text`.

    Ref API: crates/sacabase/src/lib.rs:127-149 (returns the offending
    adjacent pair (i, j) like the reference's `NotSorted { i, j }`).
    """
    text = as_text_array(text)
    sa = jnp.asarray(sa, dtype=jnp.int32)
    n = int(text.shape[0])
    if sa.shape != (n,):
        raise NotSorted(0, 0, f"sa shape {sa.shape} != text length {n}")
    if n == 0:
        return
    perm_ok, adj_ok = verify_flags(text, sa)
    perm_ok = np.asarray(perm_ok)
    if not perm_ok.all():
        bad = int(np.argmin(perm_ok))
        raise NotSorted(bad, bad, "SA is not a permutation of [0, n)")
    if n > 1:
        adj_ok = np.asarray(adj_ok)
        if not adj_ok.all():
            i = int(np.argmin(adj_ok))
            raise NotSorted(i, i + 1)
