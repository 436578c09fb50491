"""Headline benchmark: SA-construction throughput (bytes/s) on one GPU.

Prints the device and the card, then ONE JSON line:
  {"metric": "sa_build_bytes_per_s", "value": N, "unit": "B/s",
   "device": {"platform": "gpu", "kind": ..., "count": N}, "card": ...}

Fails, printing no result, unless JAX's default backend is the GPU.
The default size is a 256 MB (2^28-byte) enwik-class text; BENCH_SIZE
overrides it, BENCH_REPS sets the timed repetitions, and BENCH_FAST
skips the 2^24 scan and the host-oracle column. Detail lines go to
stderr so the headline line stays parseable.

Metric definition matches the reference harness: bytes/s =
input_len / wall_time_of_one_sort (ref: crates/divsuftest/src/main.rs:179).
Each timed build ends in `block_until_ready`.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _bench_build(build, text, reps: int):
    """Min wall time of one warm build, reference formula main.rs:179."""
    sa = build(text).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sa = build(text).block_until_ready()
        times.append(time.perf_counter() - t0)
    return min(times), sa


def main() -> None:
    from stringsearch_tpu.harness.device import (
        card_name_and_power,
        device_record,
        require_gpu,
    )

    devs = require_gpu()
    card = card_name_and_power()
    _log(f"device: {device_record(devs)}; card: {card}")

    size = int(os.environ.get("BENCH_SIZE", 1 << 28))
    reps = int(os.environ.get("BENCH_REPS", 3))

    from stringsearch_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    import jax.numpy as jnp

    from stringsearch_tpu.core.verify import is_valid
    from stringsearch_tpu.engines.doubling import _auto_depth, build_sa
    from stringsearch_tpu.harness.corpus import enwik_like

    _log(f"generating {size} bytes of enwik-like text ...")
    text_host = np.frombuffer(enwik_like(size), dtype=np.uint8)

    def doubling_build(t):
        # the headline path: no ISA, so a build that resolves in the
        # full-round loop skips the final inverse-permutation sort
        return build_sa(t, depth=_auto_depth(int(t.shape[0])))

    text = jnp.asarray(text_host)
    dt, sa = _bench_build(doubling_build, text, reps)
    bps = size / dt
    _log(f"doubling @ {size}: {dt:.4f}s -> {bps / 1e6:.2f} MB/s")
    if not bool(is_valid(text, sa)):
        raise SystemExit("verification of the benchmarked SA failed")

    if not os.environ.get("BENCH_FAST"):
        small = min(size, 1 << 24)
        if small != size:
            dts, _ = _bench_build(doubling_build, jnp.asarray(text_host[:small]),
                                  reps)
            _log(f"doubling @ {small}: {dts:.4f}s -> "
                 f"{small / dts / 1e6:.2f} MB/s")
        # the reference bench races saca-k (crates/divsuftest/src/main.rs:
        # 162-164); here the host C++ SA-IS oracle, single core
        from stringsearch_tpu import oracle

        osz = min(size, 1 << 24)
        ohost = text_host[:osz]
        oracle.build(ohost[:4096])  # build/load the shared library first
        t0 = time.perf_counter()
        oracle.build(ohost)
        dto = time.perf_counter() - t0
        _log(f"host oracle @ {osz}: {dto:.4f}s -> {osz / dto / 1e6:.2f} MB/s")

    print(json.dumps({
        "metric": "sa_build_bytes_per_s",
        "value": bps,
        "unit": "B/s",
        "device": device_record(devs),
        "card": card,
    }))


if __name__ == "__main__":
    main()
