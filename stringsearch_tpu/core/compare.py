"""Vectorized byte-string comparison primitives.

Capability parity with the reference's scalar compare loops, re-expressed as
fixed-width vector ops:

- `common_prefix_len` (ref: crates/sacabase/src/lib.rs:26-35, whose source
  carries a TODO "exploit SSE 4.2" — here the whole compare is one vector op).
- suffix-vs-needle lexicographic compares used by the SA binary search
  (ref: crates/sacabase/src/lib.rs:39-99) and `sa_search`
  (ref: c-sources/utils.c:244-325).

Design notes:
- All compares are over *fixed-width* windows (the padded needle length M),
  gathered from the text in one vectorized gather — no data-dependent scalar
  loops under jit.
- Sentinels make padding participate correctly in lexicographic order:
    PAST_TEXT_END  = -2   (a suffix that ran out of text sorts lowest)
    PAST_NEEDLE_END = -1  (an exhausted needle sorts below any real byte but
                           above an exhausted suffix, giving "shorter string
                           is smaller" semantics on both sides)
  Real bytes occupy [0, 255] in int32.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

PAST_TEXT_END = -2
PAST_NEEDLE_END = -1


def gather_window(text: jnp.ndarray, starts: jnp.ndarray, width: int) -> jnp.ndarray:
    """Gather `width` bytes of `text` at each start as int32, with
    PAST_TEXT_END sentinels beyond the end of text.

    text: uint8 [n]; starts: int32 [...]; returns int32 [..., width].
    """
    n = text.shape[0]
    offs = jnp.arange(width, dtype=jnp.int32)
    pos = starts[..., None] + offs  # [..., width]
    inb = (pos >= 0) & (pos < n)
    vals = jnp.take(text, jnp.clip(pos, 0, n - 1), axis=0).astype(jnp.int32)
    return jnp.where(inb, vals, PAST_TEXT_END)


def pad_needle(needle: jnp.ndarray, width: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pad a uint8 needle [m] to int32 [width] with PAST_NEEDLE_END; returns
    (padded, length)."""
    m = needle.shape[0]
    if m > width:
        raise ValueError(f"needle length {m} exceeds window width {width}")
    out = jnp.full((width,), PAST_NEEDLE_END, dtype=jnp.int32)
    out = out.at[:m].set(needle.astype(jnp.int32))
    return out, jnp.int32(m)


def prefix_match_len(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Length of the common prefix of two int32 byte windows [..., W].

    Sentinel bytes never match each other across different sentinel kinds,
    and matching sentinels (-1 == -1) are excluded by masking to real bytes.
    """
    eq = (a == b) & (a >= 0) & (b >= 0)
    return jnp.sum(jnp.cumprod(eq.astype(jnp.int32), axis=-1), axis=-1).astype(
        jnp.int32
    )


def lex_less(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Lexicographic a < b over int32 windows [..., W] (sentinels included)."""
    neq = a != b
    # index of first difference; W if none
    w = a.shape[-1]
    idx = jnp.argmax(neq, axis=-1)
    any_diff = jnp.any(neq, axis=-1)
    a_at = jnp.take_along_axis(a, idx[..., None], axis=-1)[..., 0]
    b_at = jnp.take_along_axis(b, idx[..., None], axis=-1)[..., 0]
    del w
    return any_diff & (a_at < b_at)


def lex_cmp(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Three-way lexicographic compare over windows: -1 / 0 / +1."""
    neq = a != b
    idx = jnp.argmax(neq, axis=-1)
    any_diff = jnp.any(neq, axis=-1)
    a_at = jnp.take_along_axis(a, idx[..., None], axis=-1)[..., 0]
    b_at = jnp.take_along_axis(b, idx[..., None], axis=-1)[..., 0]
    sign = jnp.sign(a_at - b_at).astype(jnp.int32)
    return jnp.where(any_diff, sign, 0)


@partial(jax.jit, static_argnames=("width",))
def _cpl_kernel(text, pa, pb, width):
    wa = gather_window(text, pa, width)
    wb = gather_window(text, pb, width)
    return prefix_match_len(wa, wb)


def common_prefix_len(text, a, b, max_len: int = 256) -> jnp.ndarray:
    """Common prefix length of text[a:] and text[b:], batched over positions.

    Ref: crates/sacabase/src/lib.rs:26-35. `a` and `b` may be scalars or
    arrays of positions; windows of `max_len` are compared in one vector op,
    then extended in doubling rounds for the (rare) longer matches, so the
    result is exact regardless of `max_len`.
    """
    from stringsearch_tpu.core.types import as_text_array

    text = as_text_array(text)
    n = int(text.shape[0])
    a = jnp.asarray(a, dtype=jnp.int32)
    b = jnp.asarray(b, dtype=jnp.int32)
    scalar = a.ndim == 0 and b.ndim == 0
    a, b = jnp.atleast_1d(a), jnp.atleast_1d(b)
    a, b = jnp.broadcast_arrays(a, b)

    width = min(max(max_len, 1), max(n, 1))
    total = _cpl_kernel(text, a, b, width)
    # Extend any window-saturated lanes with doubling window sizes.
    while width < n:
        if not bool(jnp.any(total == jnp.minimum(width, n))):
            break
        nxt = min(width * 2, n)
        total = jnp.where(
            total >= width,
            width + _cpl_kernel(text, a + width, b + width, nxt - width),
            total,
        )
        # positions past the end gather sentinels, so over-extension is safe
        width = nxt
        total = jnp.minimum(total, jnp.maximum(n - jnp.maximum(a, b), 0))
    if scalar:
        return total[0]
    return total
