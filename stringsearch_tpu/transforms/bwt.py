"""Burrows–Wheeler transform and inverse, on the device.

Capability parity with the reference's C-side extras (ref:
c-sources/divsufsort.c:372-405 `divbwt` direct BWT entry,
c-sources/divsufsort.c:256-324 `construct_BWT`,
c-sources/utils.c:52-108 `bw_transform`, :111-157 `inverse_bw_transform`).

Convention (identical to the C++ oracle, so outputs cross-check byte-exact):
with SA the suffix array and pidx the row where SA[pidx] == 0,
  U[0] = T[n-1];  U[1:] = T[SA[i]-1] for rows i in order, skipping row pidx.

Data-parallel design:
- forward: one gather + one index-shift gather (the "skip one row"
  compaction is a computed-index gather, not a dynamic-shape filter).
- inverse: the reference's LF walk is a sequential n-step pointer chase
  (utils.c:146-151). Here it is re-formulated data-parallel:
    1. LF mapping = one stable sort (LF[r] is the stable rank of the BWT
       char at row r),
    2. orbit ranks of the single (n+1)-cycle via pointer-jumping /
       permutation doubling — ceil(log2(n+1)) rounds of two gathers,
    3. one scatter emits all output bytes at once.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from stringsearch_tpu.core.types import BytesLike, as_text_array

_I32 = jnp.int32


@jax.jit
def bwt_from_sa(text: jnp.ndarray, sa: jnp.ndarray):
    """BWT from an existing SA (ref: utils.c:52-108 `bw_transform`).

    Returns (u uint8 [n], pidx int32 scalar).
    """
    n = text.shape[0]
    pidx = jnp.argmax(sa == 0).astype(_I32)
    # sentinel-augmented BWT column: row 0 is the sentinel suffix
    col = jnp.concatenate(
        [text[-1:], jnp.take(text, jnp.clip(sa - 1, 0, n - 1))]
    )  # [n+1]; row pidx+1 is the virtual-sentinel row (garbage here)
    k = jnp.arange(n, dtype=_I32)
    src = k + (k > pidx).astype(_I32)  # skip row pidx+1 of col
    u = jnp.take(col, src)
    return u, pidx


@partial(jax.jit, static_argnames=("rounds",))
def _unbwt_kernel(u: jnp.ndarray, pidx: jnp.ndarray, rounds: int):
    n = u.shape[0]
    m = n + 1  # sentinel-augmented length
    r = jnp.arange(m, dtype=_I32)
    # rebuild the sentinel column: chars biased +1, sentinel = 0 at row pidx+1
    src = r - (r > pidx + 1).astype(_I32)
    vals = jnp.take(u, jnp.clip(src, 0, n - 1)).astype(_I32) + 1
    col = jnp.where(r == pidx + 1, 0, vals)  # [m]

    # LF mapping via stable rank: sort rows by char (stable) — LF[row] is
    # the row's position in that order.
    order = jnp.argsort(col, stable=True).astype(_I32)
    lf = jnp.zeros((m,), _I32).at[order].set(r)

    # Pointer jumping: distance from every row to row 0 along the LF
    # cycle. (nxt, dist) ride as COLUMNS of one [m, 2] array so each
    # doubling round is ONE row gather instead of two element gathers.
    nxt = jnp.where(r == 0, 0, lf)
    dist = jnp.where(r == 0, 0, 1).astype(_I32)
    state = jnp.stack([nxt, dist], axis=1)  # [m, 2]

    def body(_, st):
        g = jnp.take(st, st[:, 0], axis=0)  # rows at nxt: [m, 2]
        return jnp.stack([g[:, 0], st[:, 1] + g[:, 1]], axis=1)

    state = jax.lax.fori_loop(0, rounds, body, state)
    dist = state[:, 1]

    # Walk step s(row): the LF walk starts at row 0 and emits T[n-1-s].
    s = jnp.where(r == 0, 0, m - dist)
    target = n - 1 - s
    emit = (s >= 0) & (s <= n - 1)  # excludes the full-string row (s == n)
    target_safe = jnp.where(emit, target, n)  # out-of-range → dropped
    out = jnp.zeros((n,), jnp.uint8).at[target_safe].set(
        (col - 1).astype(jnp.uint8), mode="drop"
    )
    return out


@partial(jax.jit, static_argnames=("depth",))
def _divbwt_fused(text: jnp.ndarray, depth: int):
    """SA build + BWT emission in ONE device program.

    The fused analog of the reference's `divbwt`/`construct_BWT`, which
    computes the BWT during construction without handing a finished SA
    back to the caller (ref: c-sources/divsufsort.c:256-324, 372-405):
    the ISA-free build resolves to the final sorted order and the BWT
    column gather runs in the same program — no second dispatch, no SA
    round trip, and the build's lazy-invert saving applies (the SA
    itself is consumed on-device).
    """
    from stringsearch_tpu.engines.doubling import build_sa

    sa = build_sa(text, depth=depth)
    # bwt_from_sa traces inline here (one fused program), so the
    # skip-row/pidx emission convention lives in exactly one place
    return bwt_from_sa(text, sa)


def bwt(text: BytesLike, sa=None, engine: str = "doubling") -> tuple[jnp.ndarray, int]:
    """BWT of `text`; builds the SA with `engine` if not supplied.

    Returns (u uint8 device array [n], pidx int). Matches the oracle's
    `saca_bwt` byte-exactly. With no SA supplied and the default engine,
    the build and the BWT emission run as one fused device program
    (`_divbwt_fused`).
    """
    arr = as_text_array(text)
    n = int(arr.shape[0])
    if n == 0:
        return jnp.zeros((0,), jnp.uint8), 0
    if sa is None and engine == "doubling" and n >= 3:
        from stringsearch_tpu.engines.doubling import _auto_depth

        u, pidx = _divbwt_fused(arr, _auto_depth(n))
        return u, int(pidx)
    if sa is None:
        from stringsearch_tpu.engines import build_suffix_array

        sa = build_suffix_array(arr, engine=engine).sa
    u, pidx = bwt_from_sa(arr, jnp.asarray(sa, dtype=_I32))
    return u, int(pidx)


def divbwt(text: BytesLike, engine: str = "doubling") -> tuple[bytes, int]:
    """Direct-BWT entry returning host bytes (ref: divsufsort.c:372-405)."""
    u, pidx = bwt(text, engine=engine)
    return bytes(np.asarray(u).tobytes()), pidx


def unbwt(u: BytesLike, pidx: int) -> bytes:
    """Inverse BWT (ref: utils.c:111-157), data-parallel on device."""
    arr = as_text_array(u)
    n = int(arr.shape[0])
    if n == 0:
        return b""
    rounds = max(1, int(n).bit_length())
    out = _unbwt_kernel(arr, jnp.int32(pidx), rounds)
    return bytes(np.asarray(out).tobytes())
