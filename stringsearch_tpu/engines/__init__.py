"""SACA engines (suffix-array construction algorithms).

Engine registry — capability parity with the reference's interchangeable
engines (ref: crates/{divsufsort,cdivsufsort,dc3} all exposing
`sort(text) -> SuffixArray`; sacapart accepts any engine closure,
crates/sacapart/src/lib.rs:39-41).

Engines here:
- "doubling": prefix-doubling (rank-doubling) SACA — the data-parallel
  re-formulation of trsort's doubling loop generalized to the whole text
  (ref: crates/divsufsort/src/trsort.rs:1347-1411). Fully jittable.
- "dc3": difference-cover mod-3 SACA (ref: crates/dc3/src/lib.rs), the
  independently-derived second engine for in-framework cross-checking.
- "bstar": divsufsort-structured engine — A/B/B* classification, B*
  substring naming, reduced-problem solve, and data-parallel induced
  derivation of the full SA (ref: crates/divsufsort/src/divsufsort.rs
  sort_typeBstar + construct_SA, re-expressed; see engines/bstar.py).
- "oracle": trusted host C++ engine (ref: crates/cdivsufsort) — CPU-side,
  used for differential conformance.
"""

from __future__ import annotations

from typing import Callable

from stringsearch_tpu.core.types import BytesLike, SuffixArray


def get_engine(name: str) -> Callable[[BytesLike], SuffixArray]:
    if name == "doubling":
        from stringsearch_tpu.engines.doubling import sort

        return sort
    if name == "dc3":
        from stringsearch_tpu.engines.dc3 import sort

        return sort
    if name == "bstar":
        from stringsearch_tpu.engines.bstar import sort

        return sort
    if name == "oracle":
        from stringsearch_tpu.oracle import sort

        return sort
    raise KeyError(
        f"unknown engine {name!r} (have: doubling, dc3, bstar, oracle)")


def build_suffix_array(text: BytesLike, engine: str = "doubling") -> SuffixArray:
    """Build a SuffixArray with the named engine (default: flagship)."""
    return get_engine(engine)(text)


ENGINES = ("doubling", "dc3", "bstar", "oracle")
