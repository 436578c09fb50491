"""Scaling-efficiency harness — sharded build throughput vs shard count.

The reference has no distributed story to compare against (rayon
threads only, ref: crates/sacapart/src/lib.rs:45-51); this harness
times both distributed build modes:

  * `--mode partitioned` — independent per-shard SAs (parallel/mesh.py),
    zero communication: the embarrassingly-parallel upper bound;
  * `--mode global` (default) — the exact global SA (parallel/global_sa.py),
    whose per-round collectives are where scaling is at risk.

Both time a fixed-size input at 1, 2, 4, ... P shards with throughput in
B/s and efficiency = (bps_k / bps_1) / k. The global mode also prints
the exact bytes each device sends (parallel/comm_model.py), and a wire
time and projected efficiency only when `--link-gbps` gives a rate.

Run on however many devices the backend exposes:
  python -m stringsearch_tpu.harness.scaling 64m --device gpu   # the GPUs
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python -m stringsearch_tpu.harness.scaling 1m        # virtual 8-dev mesh
"""

from __future__ import annotations

import argparse
import sys
import time

from stringsearch_tpu.utils.sizes import format_throughput, parse_size


def measure(
    size: int,
    reps: int = 3,
    backend: str | None = None,
    mode: str = "global",
) -> list[tuple[int, float, float]]:
    import jax

    from stringsearch_tpu.harness.corpus import enwik_like
    from stringsearch_tpu.parallel.mesh import build_sharded, make_mesh

    devs = jax.devices(backend) if backend else jax.devices()
    text = enwik_like(size)

    def one_partitioned(mesh):
        _chunks, sas, _lens = build_sharded(text, mesh)
        sas.block_until_ready()

    last_build = {}

    def one_global(mesh):
        from stringsearch_tpu.parallel.global_sa import GlobalSuffixArray

        g = GlobalSuffixArray(text, mesh)  # _build runs in the constructor
        g._sa_sharded.block_until_ready()
        # keep only the plain-int comm report, not the device buffers —
        # retaining the index would inflate HBM during later timings
        last_build["report"] = g.comm_report()

    one = one_global if mode == "global" else one_partitioned

    rows = []
    k = 1
    while k <= len(devs):
        mesh = make_mesh(k, batch_axis=1, devices=devs)
        one(mesh)  # warmup/compile (jitted programs are lru-cached)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            one(mesh)
            times.append(time.perf_counter() - t0)
        dt = min(times)
        report = last_build.get("report") if mode == "global" else None
        rows.append((k, dt, size / dt, report))
        k *= 2
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stringsearch-tpu-scaling")
    ap.add_argument("size", nargs="?", default="4m", help="input size (k/m/g)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, choices=[None, "cpu", "gpu"])
    ap.add_argument(
        "--link-gbps", type=float, default=None,
        help="per-device send rate (GB/s) for a wire-time projection of "
        "the measured bytes; without it only the bytes are printed",
    )
    ap.add_argument(
        "--mode",
        default="global",
        choices=["global", "partitioned"],
        help="global = exact global SA (communication-bound); "
        "partitioned = independent per-shard SAs (upper bound)",
    )
    args = ap.parse_args(argv)

    if args.device is not None:
        from stringsearch_tpu.harness.device import select_device

        if not select_device(args.device):
            return 2

    size = parse_size(args.size)
    rows = measure(size, args.reps, backend=args.device, mode=args.mode)
    base = rows[0][2]
    print(f"mode: {args.mode}")
    print(f"{'Shards':>6}  {'Time':>9}  {'Throughput':>14}  {'Efficiency':>10}")
    for k, dt, bps, _rep in rows:
        eff = bps / (base * k)
        print(f"{k:>6}  {dt:>8.3f}s  {format_throughput(bps):>14}  {eff:>9.1%}")
    if args.mode == "global":
        # exact bytes each device sends for THIS build (actual round
        # counts, parallel/comm_model.py); with --link-gbps also the wire
        # time and the efficiency bound compute/(compute+comm), per-chip
        # compute approximated by t(1 shard)/k
        t1 = rows[0][1]
        rate = args.link_gbps
        print("\ncomm volume (per device)"
              + (f", projected at {rate:g} GB/s:" if rate else ":"))
        print(f"{'Shards':>6}  {'Rounds':>6}  {'MB sent':>9}"
              + (f"  {'Wire time':>9}  {'Proj. eff.':>10}" if rate else ""))
        for k, _dt, _bps, rep in rows:
            if rep is None or k == 1:
                continue
            line = (f"{k:>6}  {rep.rounds:>6}  "
                    f"{rep.total_bytes / 1e6:>8.1f}M")
            if rate:
                comm = rep.projected_comm_seconds(rate)
                eff = rep.projected_efficiency(t1 / k, rate)
                line += f"  {comm:>8.4f}s  {eff:>9.1%}"
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
