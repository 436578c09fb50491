"""Diffable phase-trace subsystem.

Capability parity with the reference's crosscheck trace system
(ref: crates/divsufsort/src/crosscheck.rs:12-84 — `crosscheck!` text lines
and `SA_dump!` 25-per-line array dumps written to crosscheck/{c,rust},
gated by a compile-time feature so it is zero-cost when off,
divsufsort_private.h:206-212).

Here the gate is runtime-but-structural: tracing selects a *different
execution path* (host-stepped rounds around jitted kernels, see
engines/doubling.py `sort_traced`) so the jitted fast path carries no
tracing overhead at all. Dump format is line-diffable: `:: label` headers
and 25 values per line, matching the reference's dump shape so traces from
the device engines and the host oracle diff cleanly against each other.
"""

from __future__ import annotations

import os
from typing import IO, Optional

import numpy as np

PER_LINE = 25  # ref: crosscheck.rs:38-55 dumps 25 entries per line


class Tracer:
    """Writes phase labels and array dumps to a text file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f: Optional[IO[str]] = open(path, "w")

    def log(self, msg: str) -> None:
        assert self._f is not None
        self._f.write(f":: {msg}\n")

    def dump(self, label: str, arr) -> None:
        """Array dump, 25 values per line (diffable vs other engines)."""
        assert self._f is not None
        a = np.asarray(arr).ravel()
        self._f.write(f":: {label} len={a.size}\n")
        for i in range(0, a.size, PER_LINE):
            row = a[i : i + PER_LINE]
            self._f.write(" ".join(str(int(v)) for v in row) + "\n")

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
