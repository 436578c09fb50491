"""CLI harness: crosscheck | bench | run.

Capability parity with the reference CLI (ref: crates/divsuftest/src/main.rs):
- `crosscheck <file> [len]` — differential test: the trusted host oracle
  and the device engine(s) each sort the input; every output is verified and
  the SAs are compared byte-exact; nonzero exit on any mismatch
  (ref: main.rs:82-113). `--trace` additionally writes diffable phase
  dumps to crosscheck/{engine}, like the reference's crosscheck/{c,rust}.
- `bench <file> [len]` — times each engine and prints a table with
  Time and Average speed in B/s = len / elapsed (ref: main.rs:123-190,
  formula :179).
- `run <file> [len]` — one timed sort, "Done in {t}" (ref: main.rs:115-121).

Length caps accept k/m/g suffixes (ref: main.rs:192-208).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from stringsearch_tpu.utils.sizes import format_size, format_throughput, parse_size


def _load_input(path: str, length: str | None) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    if length is not None:
        cap = parse_size(length)
        data = data[:cap]
    return data


def _timed_sort(engine_fn, data: bytes) -> tuple[float, "object"]:
    t0 = time.perf_counter()
    sa = engine_fn(data)
    sa.sa.block_until_ready()
    return time.perf_counter() - t0, sa


def command_run(args) -> int:
    from stringsearch_tpu.engines import get_engine

    data = _load_input(args.input, args.length)
    engine = get_engine(args.engine)
    engine(data[: min(len(data), 4096)])  # warmup/compile on a small slice
    dt, sa = _timed_sort(engine, data)
    print(f"Done in {dt:.3f}s ({format_throughput(len(data) / max(dt, 1e-9))})")
    if args.verify:
        sa.verify()
        print("verify: OK")
    return 0


def command_bench(args) -> int:
    from stringsearch_tpu.engines import ENGINES, get_engine

    data = _load_input(args.input, args.length)
    print(f"input: {args.input} ({format_size(len(data))})")
    rows = []
    names = args.engines.split(",") if args.engines else list(ENGINES)
    for name in names:
        try:
            engine = get_engine(name)
        except KeyError as e:
            print(f"skipping {name}: {e}", file=sys.stderr)
            continue
        try:
            engine(data[: min(len(data), 4096)])  # warmup/compile
            dt, sa = _timed_sort(engine, data)
            sa.verify()
            rows.append((name, dt, len(data) / max(dt, 1e-9)))
        except NotImplementedError:
            print(f"skipping {name}: not implemented", file=sys.stderr)
    w = max(len(r[0]) for r in rows) if rows else 10
    print(f"{'Algorithm':<{w}}  {'Time':>10}  {'Average speed':>16}")
    for name, dt, bps in rows:
        print(f"{name:<{w}}  {dt:>9.3f}s  {format_throughput(bps):>16}")
    return 0


def command_queries(args) -> int:
    """Batched LCS query latency (the BASELINE.json query metric).

    Builds the doubling SA, then times `longest_substring_match_batch`
    over batches of needles sampled from the text (plus misses) and
    reports p50/p95 batch latency and per-needle throughput. `--batch`
    accepts a comma list (e.g. 64,256,1024,4096) to print the
    batch-scaling curve in one invocation (one SA build, one line per
    batch size).
    """
    from stringsearch_tpu.engines import get_engine

    data = _load_input(args.input, args.length)
    try:
        batches = [int(b) for b in str(args.batch).split(",") if b.strip()]
    except ValueError:
        print(f"error: --batch must be a comma list of ints, got "
              f"{args.batch!r}", file=sys.stderr)
        return 2
    if not batches or any(b < 1 for b in batches):
        print(f"error: --batch needs at least one positive int, got "
              f"{args.batch!r}", file=sys.stderr)
        return 2
    sa = get_engine(args.engine)(data)
    for batch in batches:
        rng = np.random.default_rng(0xBEEF)
        needles = []
        for i in range(batch):
            if i % 8 == 7:  # every 8th needle is a guaranteed miss
                needles.append(
                    bytes(rng.integers(0, 256, 24, dtype=np.uint8)) + b"\xff\xfe"
                )
            else:
                start = int(rng.integers(0, max(1, len(data) - 64)))
                needles.append(data[start : start + int(rng.integers(4, 64))])
        sa.longest_substring_match_batch(needles)  # warmup/compile
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            sa.longest_substring_match_batch(needles)
            times.append(time.perf_counter() - t0)
        ts = sorted(times)
        p50 = ts[len(ts) // 2]
        p95 = ts[min(len(ts) - 1, int(len(ts) * 0.95))]
        print(
            f"queries: batch={batch} reps={args.reps} "
            f"p50={p50 * 1e3:.2f}ms p95={p95 * 1e3:.2f}ms "
            f"({batch / p50:,.0f} needles/s)"
        )
    return 0


def command_crosscheck(args) -> int:
    from stringsearch_tpu import oracle
    from stringsearch_tpu.engines import get_engine

    data = _load_input(args.input, args.length)
    print(f"crosscheck on {format_size(len(data))}")

    # trusted oracle first (ref: main.rs:89-94 runs the C engine first)
    c_sa = oracle.build(data)
    rc = oracle.sufcheck(data, c_sa)
    if rc != 0:
        print(f"FAIL: oracle output failed sufcheck (rc={rc})")
        return 1
    print("oracle: built + sufcheck OK")

    names = args.engines.split(",") if args.engines else ["doubling"]
    status = 0
    wrote_oracle_trace = False
    for name in names:
        if name == "global":
            sa = _build_global_index(data, args.trace)
        elif args.trace:
            traced = _traced_engine(name)
            if traced is None:
                print(
                    f"warning: engine {name!r} has no traced build path; "
                    "running untraced",
                    file=sys.stderr,
                )
                sa = get_engine(name)(data)
            else:
                from stringsearch_tpu.harness.tracing import Tracer

                with Tracer(f"crosscheck/{name}") as tr:
                    sa = traced(data, tr)
        else:
            sa = get_engine(name)(data)
        if args.trace and not wrote_oracle_trace:
            from stringsearch_tpu.harness.tracing import Tracer

            with Tracer("crosscheck/oracle") as tr:
                tr.log(f"oracle n={len(data)}")
                tr.dump("SA final", c_sa)
            wrote_oracle_trace = True
        sa.verify()
        got = np.asarray(sa.sa)
        if np.array_equal(got, c_sa):
            print(f"{name}: verify OK, byte-exact match vs oracle")
        else:
            bad = int(np.argmax(got != c_sa))
            print(
                f"{name}: MISMATCH at SA[{bad}]: got {got[bad]}, oracle {c_sa[bad]}"
            )
            status = 1
    return status


def _traced_engine(name: str):
    """Traced build entry for `name`, or None (ref crosscheck-feature
    builds, crates/divsufsort/src/crosscheck.rs — every engine that can
    trace does so through the same diffable Tracer format)."""
    if name == "doubling":
        from stringsearch_tpu.engines.doubling import sort_traced
    elif name == "dc3":
        from stringsearch_tpu.engines.dc3 import sort_traced
    elif name == "bstar":
        from stringsearch_tpu.engines.bstar import sort_traced
    else:
        return None
    return sort_traced


def _build_global_index(data: bytes, trace: bool):
    """Crosscheck entry for the distributed global engine: build over a
    mesh of all same-platform devices (1 device degenerates gracefully)
    and adapt to the SuffixArray interface."""
    import jax
    from jax.sharding import Mesh

    from stringsearch_tpu.parallel.global_sa import build_global

    # follow the configured default device's platform (--device cpu must
    # not silently build the mesh on the accelerator)
    default = jax.config.jax_default_device
    platform = default.platform if default is not None else \
        jax.devices()[0].platform
    devs = jax.devices(platform)
    p = len(devs)
    while p & (p - 1):
        p -= 1
    mesh = Mesh(np.array(devs[:p]), ("parts",))
    if trace:
        from stringsearch_tpu.harness.tracing import Tracer

        with Tracer("crosscheck/global") as tr:
            g = build_global(data, mesh, tracer=tr)
            g.suffix_array()
            tr.dump("SA final", g.suffix_array())
    else:
        g = build_global(data, mesh)
    return g.to_suffix_array_index()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="stringsearch-tpu",
        description="suffix-array harness (crosscheck | bench | run | queries)",
    )
    ap.add_argument("command", choices=["crosscheck", "bench", "run", "queries"])
    ap.add_argument("input", help="input file")
    ap.add_argument("length", nargs="?", default=None, help="size cap (k/m/g suffixes)")
    ap.add_argument(
        "--engine", default="doubling", help="engine for `run` / `queries`"
    )
    ap.add_argument("--engines", default=None, help="comma list for bench/crosscheck")
    ap.add_argument("--device", default=None, choices=[None, "cpu", "gpu"])
    ap.add_argument("--verify", action="store_true", help="verify after `run`")
    ap.add_argument("--trace", action="store_true", help="write crosscheck/ trace dumps")
    ap.add_argument("--batch", default="256",
                    help="needle batch for `queries`; comma list for a curve")
    ap.add_argument("--reps", type=int, default=20, help="timing reps for `queries`")
    args = ap.parse_args(argv)

    from stringsearch_tpu.harness.device import select_device

    if args.device is not None and not select_device(args.device):
        return 2
    from stringsearch_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    if args.command == "run":
        return command_run(args)
    if args.command == "bench":
        return command_bench(args)
    if args.command == "queries":
        return command_queries(args)
    return command_crosscheck(args)


if __name__ == "__main__":
    sys.exit(main())
