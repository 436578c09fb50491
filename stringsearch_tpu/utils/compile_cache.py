"""Persistent XLA compilation cache for the harness entry points.

A cold build of a large text compiles for many seconds; the persistent
on-disk cache lets later processes load the compiled executables
instead. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself
and this module sets no other directory. Otherwise the cache lives at a
fixed path inside the checkout, `<repo>/.jax_cache/` (git-ignored): the
path is part of the cache key, so a directory that moved would never
hit. Opt out with STRINGSEARCH_TPU_NO_COMPILE_CACHE=1 (e.g. when
measuring compile time itself).

Off on the CPU backend: XLA:CPU executables reloaded from the cache
carry the compiling machine's CPU feature strings, and loads on another
machine were seen to warn of SIGILL and to crash fuzz campaigns.

The reference has no analog (rustc compiles once, ahead of time); this
is kept out of library import paths so plain `import stringsearch_tpu`
never mutates global jax config.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str | None:
    """The directory the persistent cache uses, or None when opted out."""
    if os.environ.get("STRINGSEARCH_TPU_NO_COMPILE_CACHE"):
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> str | None:
    """Turn on jax's persistent compilation cache (idempotent).

    Returns the cache directory in use, or None when the cache stays off
    (opted out, or the CPU backend)."""
    d = cache_dir()
    if d is None:
        return None
    import jax

    dev = jax.config.jax_default_device  # a Device, a platform name or None
    platform = getattr(dev, "platform", dev) or jax.default_backend()
    if platform == "cpu":
        return None
    if d == DEFAULT_DIR:  # otherwise JAX already follows the variable
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    return d
