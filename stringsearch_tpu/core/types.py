"""Core types: SuffixArray, match results, StringIndex protocol.

Capability parity with the reference's base API layer (ref:
crates/sacabase/src/lib.rs:4-21 `LongestCommonSubstring`,
:101-125 `NotSorted`, :152-197 `SuffixArray` + `StringIndex` trait),
re-designed for device residency: the text is a `uint8` JAX array in HBM
and the suffix array an `int32` JAX array, so queries and verification
run on-device without host round-trips.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, Union, runtime_checkable

import jax.numpy as jnp
import numpy as np

BytesLike = Union[bytes, bytearray, np.ndarray, "jnp.ndarray"]


def as_text_array(data: BytesLike) -> jnp.ndarray:
    """Coerce host bytes / arrays into a device-resident uint8 text array."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        arr = np.asarray(data) if not isinstance(data, jnp.ndarray) else data
        if arr.dtype != np.uint8:
            raise TypeError(f"text must be uint8 bytes, got {arr.dtype}")
    return jnp.asarray(arr, dtype=jnp.uint8)


@dataclasses.dataclass(frozen=True)
class LongestCommonSubstring:
    """The longest prefix of a needle found anywhere in the indexed text.

    Ref semantics: crates/sacabase/src/lib.rs:4-21 — `start`/`len` locate the
    match in the *indexed text*; `as_bytes` returns the matched slice.
    """

    text: np.ndarray  # host view of the indexed text (uint8)
    start: int
    len: int

    def as_bytes(self) -> bytes:
        return bytes(self.text[self.start : self.start + self.len].tobytes())

    def __repr__(self) -> str:  # pragma: no cover - debug nicety
        return (
            f"LongestCommonSubstring(start={self.start}, len={self.len}, "
            f"bytes={self.as_bytes()!r})"
        )


class NotSorted(Exception):
    """Raised when `verify` finds the SA is not a valid suffix array.

    Ref: crates/sacabase/src/lib.rs:101-125 `NotSorted { i, j }` — we keep
    the adjacent-pair (i, j) indices for debuggability.
    """

    def __init__(self, i: int, j: int, reason: str = ""):
        self.i = int(i)
        self.j = int(j)
        super().__init__(
            f"suffix array not sorted at adjacent entries ({self.i}, {self.j})"
            + (f": {reason}" if reason else "")
        )


@runtime_checkable
class StringIndex(Protocol):
    """The one abstraction every index type implements.

    Ref: crates/sacabase/src/lib.rs:160-163 `trait StringIndex`.
    """

    def longest_substring_match(self, needle: BytesLike) -> LongestCommonSubstring:
        ...


class SuffixArray:
    """An owning (text, sa) pair with query/verify methods.

    Ref: crates/sacabase/src/lib.rs:152-197. This design keeps both
    arrays on device; `text_bytes()` materialises a host copy lazily for
    `LongestCommonSubstring.as_bytes()`.
    """

    def __init__(self, text: BytesLike, sa: Union[np.ndarray, jnp.ndarray]):
        self.text = as_text_array(text)
        self.sa = jnp.asarray(sa, dtype=jnp.int32)
        if self.sa.shape != (self.text.shape[0],):
            raise ValueError(
                f"sa shape {self.sa.shape} does not match text length "
                f"{self.text.shape[0]}"
            )
        self._host_text: np.ndarray | None = None

    # -- accessors (ref: into_parts / text, sacabase/src/lib.rs:170-183) ----
    def __len__(self) -> int:
        return int(self.text.shape[0])

    def into_parts(self) -> tuple[jnp.ndarray, jnp.ndarray]:
        return self.text, self.sa

    def text_bytes(self) -> np.ndarray:
        if self._host_text is None:
            self._host_text = np.asarray(self.text)
        return self._host_text

    # -- verification (ref: sacabase/src/lib.rs:127-149) ---------------------
    def verify(self) -> None:
        from stringsearch_tpu.core.verify import verify

        verify(self.text, self.sa)

    # -- queries (ref: sacabase/src/lib.rs:190-197) ---------------------------
    def longest_substring_match(self, needle: BytesLike) -> LongestCommonSubstring:
        from stringsearch_tpu.core.search import longest_substring_match

        return longest_substring_match(self, needle)

    def longest_substring_match_batch(
        self, needles: Sequence[BytesLike]
    ) -> list[LongestCommonSubstring]:
        from stringsearch_tpu.core.search import longest_substring_match_batch

        return longest_substring_match_batch(self, needles)

    def search(self, needle: BytesLike) -> tuple[int, int]:
        """(count, leftmost SA index) of exact occurrences of `needle`.

        Ref: c-sources/utils.c:244-325 `sa_search` returns (count, left idx).
        """
        from stringsearch_tpu.core.search import sa_search

        return sa_search(self, needle)
