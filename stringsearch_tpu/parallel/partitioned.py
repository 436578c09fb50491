"""Partitioned suffix arrays — data-parallel construction, merged queries.

Capability parity with the reference's only parallelism strategy
(ref: crates/sacapart/src/lib.rs:26-98 `PartitionedSuffixArray`):
split the text into P partitions, build each partition's SA in parallel,
and answer queries by searching every partition and keeping the best match,
with cross-boundary repair.

Data-parallel re-design:
- rayon `par_chunks` (ref: sacapart/src/lib.rs:45-51) becomes a *batched*
  build: all partitions' doubling loops run as one vmapped program, so a
  single chip sorts all partitions at once, and a mesh shards the partition
  axis across chips (see parallel/mesh.py).
- the query path (ref: sacapart/src/lib.rs:69-97) becomes: one vmapped
  LCS search over [P] partitions × [B] needles, then a *boundary repair*
  that recomputes each candidate's true match length against the full text
  (a strict improvement over the reference's right-extension at :77-84 —
  every candidate is extended, not only those touching a boundary), then an
  argmax keeping the earliest partition on ties (ref behavior at :86-92).
- non-divisible lengths: the last partition is zero-padded. End-padding with
  0x00 preserves the relative order of real suffixes inside the chunk
  (pad bytes sort lowest and ties break by length in the same direction as
  true suffix order); candidates that start inside padding are masked out,
  and the full-text repair step removes any influence of pad bytes on
  match lengths.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from stringsearch_tpu.core import compare as cmp
from stringsearch_tpu.core.search import (
    _ceil_log2,
    _needle_batch_to_windows,
    lcs_loop,
    needle_mask_cmp,
    sa_search_loop,
)
from stringsearch_tpu.core.types import (
    BytesLike,
    LongestCommonSubstring,
    as_text_array,
)


@partial(jax.jit, static_argnames=("num_partitions",))
def build_partitioned(padded_text: jnp.ndarray, num_partitions: int):
    """Build all partition SAs in one batched program.

    padded_text: uint8 [P*L]. Returns sa int32 [P, L].
    """
    from stringsearch_tpu.engines.doubling import build_sa

    chunks = padded_text.reshape(num_partitions, -1)
    # build_sa: the ISA is unused, so the lazy-invert saving applies per
    # chunk. adaptive=False: under vmap a lax.switch lowers to
    # execute-all-branches, so the adaptive cascade entry would RUN every
    # pyramid level instead of picking one — the static entry is the
    # right shape for batched builds.
    sa = jax.vmap(partial(build_sa, adaptive=False))(chunks)
    return chunks, sa


@partial(jax.jit, static_argnames=("steps",))
def partitioned_query(chunks, sas, full_text, real_lens, needles, lens, steps: int):
    """Query all partitions, repair against the full text, reduce.

    chunks: uint8 [P, L]; sas: int32 [P, L]; full_text: uint8 [n];
    needles: int32 [B, M]; lens: int32 [B].
    Returns (start [B], length [B]) — global text coordinates.
    """
    p, chunk_len = chunks.shape
    m_width = needles.shape[-1]

    # per-partition LCS candidates: [P, B]. The in-chunk comparison masks
    # positions at or past the partition's REAL length to the past-end
    # sentinel: pad zeros must not inflate a near-end suffix's apparent
    # match (fuzz-found: the pad-contaminated candidate "\x00"+pad beat
    # the real "\x00\x00..." occurrence for a zero-leading needle). The
    # padded-chunk SA order is identical under this comparator — zero
    # padding is order-safe and ties break by length in the same
    # direction (see module doc) — so the binary search stays valid.
    def query_one(chunk, sa, real_len):
        def windows_at(pos):
            starts = jnp.take(sa, jnp.clip(pos, 0, chunk_len - 1))
            win = cmp.gather_window(chunk, starts, m_width)
            offs = jnp.arange(m_width, dtype=jnp.int32)
            inb = (starts[:, None] + offs[None, :]) < real_len
            return starts, jnp.where(inb, win, cmp.PAST_TEXT_END)

        return lcs_loop(windows_at, chunk_len, needles, steps)

    starts, _lengths = jax.vmap(query_one)(chunks, sas, real_lens)

    offsets = (jnp.arange(p, dtype=jnp.int32) * chunk_len)[:, None]
    global_starts = starts + offsets  # [P, B]
    valid = starts < real_lens[:, None]  # not a pure-padding suffix

    # boundary repair: true match length vs the full text (covers both
    # pad-byte contamination and cross-partition extension)
    windows = cmp.gather_window(full_text, global_starts, m_width)  # [P,B,M]
    true_len = cmp.prefix_match_len(windows, needles[None, :, :])  # [P,B]
    true_len = jnp.where(valid, true_len, -1)

    best_p = jnp.argmax(true_len, axis=0)  # first max wins → earliest partition
    best_len = jnp.max(true_len, axis=0)
    best_start = jnp.take_along_axis(global_starts, best_p[None, :], axis=0)[0]
    return best_start, jnp.maximum(best_len, 0)


@partial(jax.jit, static_argnames=("steps",))
def partitioned_search(chunks, sas, real_lens, needles, lens, steps: int):
    """Batched in-partition exact-occurrence search over all partitions.

    Returns (count [B], first [B]): `count` = occurrences lying entirely
    inside SOME partition (summed — partitions are disjoint, so no
    occurrence is counted twice); `first` = smallest global text
    position among those occurrences, -1 when count is 0.

    Each partition runs the shared double binary search
    (core.search.sa_search_loop) over its own SA with windows masked at
    the partition's REAL length, so (a) pad bytes never extend a match
    and (b) a suffix that runs out at the partition end cannot match a
    longer needle — exactly the "occurrence fits inside the partition"
    predicate. The last partition's pad slots hold DUPLICATES of its
    smallest real suffix (see the constructor note); duplicates landing
    inside [lo, up) are subtracted from the count (their positions
    cannot perturb `first`: the original is in range with the same
    position).
    """
    p, chunk_len = chunks.shape
    m_width = needles.shape[-1]
    b = needles.shape[0]
    compare = needle_mask_cmp(needles, lens)
    offs = jnp.arange(m_width, dtype=jnp.int32)

    def search_one(chunk, sa, real_len):
        def cmp_at(pos):
            starts = jnp.take(sa, jnp.clip(pos, 0, chunk_len - 1))
            win = cmp.gather_window(chunk, starts, m_width)
            inb = (starts[:, None] + offs[None, :]) < real_len
            return compare(jnp.where(inb, win, cmp.PAST_TEXT_END))

        return sa_search_loop(cmp_at, chunk_len, b, steps)

    lo, up = jax.vmap(search_one)(chunks, sas, real_lens)  # [P, B] each
    pad_p = (jnp.asarray(chunk_len, jnp.int32) - real_lens)[:, None]  # [P,1]
    dup_in_range = jnp.clip(pad_p - lo, 0, up - lo)
    counts = up - lo - dup_in_range
    total = jnp.sum(counts, axis=0)  # [B]

    # exact leftmost global text position: masked min over every
    # occurrence slot (the [B, P, L] broadcast fuses into the reduce —
    # one O(B*n) bandwidth-bound pass, no materialization)
    j = jnp.arange(chunk_len, dtype=jnp.int32)
    offsets = jnp.arange(p, dtype=jnp.int32) * chunk_len
    in_range = (j[None, None, :] >= lo.T[:, :, None]) & (
        j[None, None, :] < up.T[:, :, None]
    )  # [B, P, L]
    gpos = sas[None, :, :] + offsets[None, :, None]
    big = jnp.asarray(np.iinfo(np.int32).max, jnp.int32)
    first = jnp.min(jnp.where(in_range, gpos, big), axis=(1, 2))
    first = jnp.where(total > 0, first, -1)
    return total, first


class PartitionedSuffixArray:
    """P per-partition suffix arrays over one text (ref: sacapart).

    Same documented trade-off as the reference (sacapart/src/lib.rs:5-25):
    construction parallelises across partitions; queries search all
    partitions; matches crossing a boundary may be shorter than the
    full-text optimum (mitigated here by full-text repair of every
    candidate).
    """

    def __init__(
        self,
        text: BytesLike,
        num_partitions: int,
        engine: Union[str, Callable, None] = None,
    ):
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        self.text = as_text_array(text)
        n = int(self.text.shape[0])
        self._num_partitions = num_partitions
        part = -(-max(n, num_partitions) // num_partitions)  # ceil, >= 1
        self.partition_size = part
        padded_len = part * num_partitions
        pad = padded_len - n
        padded = (
            jnp.concatenate([self.text, jnp.zeros((pad,), jnp.uint8)])
            if pad
            else self.text
        )
        self.real_lens = jnp.asarray(
            [max(0, min(n - i * part, part)) for i in range(num_partitions)],
            dtype=jnp.int32,
        )
        if engine is None or engine == "doubling" or callable(engine):
            # batched on-device build (callable engines also route here —
            # the batched doubling build *is* the device engine; host
            # callables are only meaningful for the oracle, handled below)
            if callable(engine):
                self.chunks, self.sas = self._build_with_callable(
                    padded, num_partitions, engine
                )
            else:
                self.chunks, self.sas = build_partitioned(padded, num_partitions)
        else:
            self.chunks, self.sas = self._build_with_callable(
                padded, num_partitions, None, engine_name=engine
            )
        # Pad suffixes (all-zero strings) are the lexicographically
        # smallest suffixes of a padded chunk, so they occupy exactly the
        # first `pad` slots of its SA. A zero-leading needle's binary
        # search would surface one of them as the partition's single
        # candidate, which the validity mask then discards — losing real
        # in-partition matches (fuzz-found: needle b"\x00" returned no
        # match with 36 zeros in the text). Overwrite those slots with
        # duplicates of the smallest REAL suffix: the array stays sorted,
        # and the search can only ever return real candidates.
        pad_counts = jnp.asarray(part, jnp.int32) - self.real_lens  # [P]
        if pad:
            cols = jnp.arange(part, dtype=jnp.int32)[None, :]
            fix = jnp.maximum(
                cols, jnp.minimum(pad_counts[:, None], part - 1)
            )
            self.sas = jnp.take_along_axis(self.sas, fix, axis=1)
        self._host_text: Optional[np.ndarray] = None

    @staticmethod
    def _build_with_callable(padded, num_partitions, fn, engine_name=None):
        from stringsearch_tpu.engines import get_engine

        if fn is None:
            fn = get_engine(engine_name)
        chunks = padded.reshape(num_partitions, -1)
        host_chunks = np.asarray(chunks)
        sas = np.stack(
            [np.asarray(fn(host_chunks[i]).sa) for i in range(num_partitions)]
        )
        return chunks, jnp.asarray(sas, dtype=jnp.int32)

    def num_partitions(self) -> int:
        """Ref: crates/sacapart/src/lib.rs:60-62."""
        return self._num_partitions

    def text_bytes(self) -> np.ndarray:
        if self._host_text is None:
            self._host_text = np.asarray(self.text)
        return self._host_text

    def longest_substring_match_batch(
        self, needles: Sequence[BytesLike]
    ) -> list[LongestCommonSubstring]:
        if not needles:
            return []
        n = int(self.text.shape[0])
        host = self.text_bytes()
        if n == 0:
            return [LongestCommonSubstring(host, 0, 0) for _ in needles]
        padded, lens, _w = _needle_batch_to_windows(needles)
        steps = _ceil_log2(self.partition_size + 1) + 1
        start, length = partitioned_query(
            self.chunks,
            self.sas,
            self.text,
            self.real_lens,
            jnp.asarray(padded),
            jnp.asarray(lens),
            steps,
        )
        both = np.asarray(jnp.stack([start, length]))  # one host fetch
        start, length = both[0], both[1]
        return [
            LongestCommonSubstring(host, int(start[i]), int(length[i]))
            for i in range(len(needles))
        ]

    def longest_substring_match(self, needle: BytesLike) -> LongestCommonSubstring:
        """Ref: crates/sacapart/src/lib.rs:65-98 (StringIndex impl)."""
        return self.longest_substring_match_batch([needle])[0]

    def sa_search_batch(self, needles: Sequence[BytesLike]):
        """Batched exact search: [(count, first_text_pos)] per needle.

        PARTITIONED SEMANTICS (documented divergence from the flat-SA
        `sa_search`, ref c-sources/utils.c:244-325, which this
        re-expresses per partition): `count` is the number of
        occurrences lying entirely inside a single partition — an
        occurrence crossing a partition boundary is NOT counted (the
        same boundary degradation the reference pins for partitioned
        matches, ref crates/sacapart/src/lib.rs:5-25), so
        count <= the full-index count, with equality whenever no
        occurrence crosses a boundary. There is no meaningful global SA
        slot for a partitioned index, so the second element is the
        smallest global TEXT position of a counted occurrence (-1 when
        count is 0) instead of the reference's SA index.
        """
        if not needles:
            return []
        n = int(self.text.shape[0])
        out_empty = [(len(bytes(nd)) == 0) for nd in needles]
        if n == 0:
            return [(0, -1) for _ in needles]
        padded, lens, _w = _needle_batch_to_windows(needles)
        steps = _ceil_log2(self.partition_size + 1) + 1
        count, first = partitioned_search(
            self.chunks, self.sas, self.real_lens,
            jnp.asarray(padded), jnp.asarray(lens), steps,
        )
        both = np.asarray(jnp.stack([count, first]))  # one host fetch
        count, first = both[0], both[1]
        return [
            (n, 0) if out_empty[i] else (int(count[i]), int(first[i]))
            for i in range(len(needles))
        ]

    def sa_search(self, needle: BytesLike):
        return self.sa_search_batch([needle])[0]

    def sa_simplesearch(self, c: int):
        """(count, first_text_pos) for the single byte `c` (ref:
        c-sources/utils.c:328-381). Single-byte occurrences never cross
        a boundary, so the count equals the full-text count exactly."""
        return self.sa_search(bytes([c]))
