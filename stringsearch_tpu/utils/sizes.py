"""Human-friendly size parsing/formatting.

Capability parity with the reference CLI's size handling
(ref: crates/divsuftest/src/main.rs:192-208 `parse_size` with k/m suffixes,
and size_format usage at main.rs:52-55). Extended with `g` since device
memory holds multi-GB texts.
"""

from __future__ import annotations

_SUFFIXES = {"k": 1024, "m": 1024**2, "g": 1024**3}


def parse_size(s: str) -> int:
    """Parse '4096', '64k', '16m', '1g' into a byte count."""
    s = s.strip().lower()
    if not s:
        raise ValueError("empty size")
    if s[-1] in _SUFFIXES:
        return int(float(s[:-1]) * _SUFFIXES[s[-1]])
    return int(s)


def format_size(n: float) -> str:
    """Format a byte count as a short human string (e.g. '12.3 MB')."""
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TB"


def format_throughput(bytes_per_s: float) -> str:
    return f"{format_size(bytes_per_s)}/s"
