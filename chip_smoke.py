"""Smoke run of the main path on the GPU, at the sizes users index.

    python chip_smoke.py          # one GPU: phases a-g, then the gpu tests
    python chip_smoke.py --four   # four GPUs: phase h only

Phases (one process; every one prints one JSON line before the last):
  a. device check: fails unless JAX's default backend is the GPU;
  b. build a 256 MB (2^28-byte) enwik-class text with the headline
     `st.build_suffix_array` and with `build_with_isa`; `verify()` on the
     device; byte-exact against the C++ SA-IS oracle;
  c. one profiler trace of one warm build: each sort's device time, how
     XLA lowered it (CUB radix sort or XLA's own sort kernel), and the
     device's idle share;
  d. a batch of 256 LCS needles and one of 256 `sa_search` needles on
     the 2^28 index, checked against the oracle;
  e. BWT forward and inverse at 2^24 against the oracle;
  f. `PartitionedSuffixArray(text, 4)` at 2^26, queries checked as in d
     under partitioned semantics;
  g. the dc3 and bstar engines at 2^20, byte-exact against the oracle;
  then the tests marked `gpu`, in this process.
  h. (`--four`) the exact global SA (`build_global`) of a 1 GB (2^30)
     text over four GPUs, checked by its distributed `verify()` and
     byte-exact against the oracle, with the shardings and each device's
     peak memory; a `ShardedSuffixArray` at 2^28 with a checked query
     batch; then each collective's device time from one traced build.

Any failure raises: the process exits non-zero and prints no result
line. Nothing falls back to the CPU. The last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.
Text is made from fixed seeds; traces and HLO dumps go to
`chiprun_out/chip_smoke/`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 7
BUILD_LOG2, QUERY_BATCH = 28, 256
BWT_LOG2, PART_LOG2, PARTS, ENGINE_LOG2 = 24, 26, 4, 20
GLOBAL_LOG2, SHARDED_LOG2, FOUR = 30, 28, 4
OUT_DIR = os.path.join("chiprun_out", "chip_smoke")


class Report:
    """Prints one JSON line per phase with the devices' memory and the
    card; `devices` are the devices the phase ran on."""

    def __init__(self, devices, card: str):
        self.devices = list(devices)
        self.card = card

    def line(self, phase: str, **fields) -> dict:
        stats = [d.memory_stats() or {} for d in self.devices]
        rec = {
            "phase": phase,
            **fields,
            # process-wide peak so far, per device (JAX has no reset)
            "peak_bytes_in_use": [s.get("peak_bytes_in_use") for s in stats],
            "device_kind": self.devices[0].device_kind,
            "card": self.card,
        }
        print(json.dumps(rec), flush=True)
        return rec


def _block(x):
    import jax

    return jax.block_until_ready(x)


def first_and_warm(fn):
    """(out, first_s, warm_s): the first call compiles and runs, the
    second only runs; both end in `block_until_ready`. compile_s is
    reported as first_s - warm_s."""
    t0 = time.perf_counter()
    _block(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _block(fn())
    return out, first, time.perf_counter() - t0


def _ready(index):
    """Block on every device array an index object holds; returns it."""
    import jax

    _block([v for v in vars(index).values() if isinstance(v, jax.Array)])
    return index


def _timing(first: float, warm: float) -> dict:
    return {"compile_s": first - warm, "run_s": warm}


# ---------------------------------------------------------------------------
# needles and their checks (the oracle is the reference)
# ---------------------------------------------------------------------------


def make_needles(text: np.ndarray, count: int, seed: int) -> list[bytes]:
    """Three in four drawn from the text (4-63 bytes), the rest misses."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        if i % 4 == 3:
            out.append(bytes(rng.integers(0, 256, 24, dtype=np.uint8))
                       + b"\xff\xfe")
        else:
            start = int(rng.integers(0, max(1, len(text) - 64)))
            out.append(text[start:start + int(rng.integers(4, 64))].tobytes())
    return out


def occurrences(text, sa, needle: bytes, part: int | None = None):
    """Oracle (count, leftmost SA slot, positions) of `needle`; with
    `part`, only occurrences inside one partition of that size."""
    from stringsearch_tpu import oracle

    cnt, left = oracle.search(text, needle, sa)
    pos = sa[left:left + cnt] if cnt else sa[:0]
    if part is not None and len(needle):
        pos = pos[pos // part == (pos + len(needle) - 1) // part]
    return cnt, left, pos


def check_lcs(text, sa, needles, matches, part: int | None = None) -> None:
    """Each match is a prefix of its needle found at its start, and the
    prefix one byte longer does not occur (inside one partition, for a
    partitioned index, whose matches may not cross a boundary)."""
    for nd, m in zip(needles, matches):
        got = text[m.start:m.start + m.len].tobytes()
        if got != nd[:m.len]:
            raise AssertionError(f"match {got!r} is not a prefix of {nd!r}")
        if m.len < len(nd):
            _, _, pos = occurrences(text, sa, nd[:m.len + 1], part)
            if len(pos):
                raise AssertionError(
                    f"LCS of {nd!r} is {m.len} but {m.len + 1} bytes occur")


def check_search(text, sa, needles, results, part: int | None = None):
    """Counts and leftmost SA slots equal the oracle's; for a partitioned
    index, counts of non-crossing occurrences and their first text
    position."""
    for nd, (cnt, left) in zip(needles, results):
        o_cnt, o_left, pos = occurrences(text, sa, nd, part)
        if part is None:
            want = (o_cnt, o_left) if o_cnt else (0, left)
        else:
            want = (len(pos), int(pos.min()) if len(pos) else -1)
        if (cnt, left) != want:
            raise AssertionError(f"search {nd!r}: got {(cnt, left)}, "
                                 f"oracle {want}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device_check(count: int = 1):
    """a. The first `count` GPUs, the card's name and power limit."""
    from stringsearch_tpu.harness.device import card_name_and_power, require_gpu

    devs = require_gpu(count)
    return devs, card_name_and_power()


def phase_build(report: Report, text: np.ndarray, oracle_sa):
    """b. Headline build + build_with_isa, verify, byte-exact vs oracle.
    Returns the headline index."""
    import jax.numpy as jnp

    import stringsearch_tpu as st
    from stringsearch_tpu.engines.doubling import _auto_depth, build_with_isa

    text_d = jnp.asarray(text)
    idx, first, warm = first_and_warm(
        lambda: _ready(st.build_suffix_array(text_d)))
    n = len(text)
    report.line("b.build_suffix_array", n=n, bytes_per_s=n / warm,
                **_timing(first, warm))
    t0 = time.perf_counter()
    idx.verify()
    report.line("b.verify", n=n, run_s=time.perf_counter() - t0)

    depth = _auto_depth(n)
    (sa2, isa), first, warm = first_and_warm(
        lambda: build_with_isa(text_d, depth=depth))
    if not bool(jnp.array_equal(sa2, idx.sa)):
        raise AssertionError("build_with_isa SA differs from build_sa")
    if not bool(jnp.array_equal(isa[sa2], jnp.arange(n, dtype=isa.dtype))):
        raise AssertionError("build_with_isa ISA is not the inverse")
    del sa2, isa
    report.line("b.build_with_isa", n=n, bytes_per_s=n / warm,
                **_timing(first, warm))
    t0 = time.perf_counter()
    want = oracle_sa.result()
    wait = time.perf_counter() - t0
    got = np.asarray(idx.sa)
    if not np.array_equal(got, want):
        bad = int(np.argmax(got != want))
        raise AssertionError(f"SA differs from the oracle at slot {bad}")
    report.line("b.oracle_byte_exact", n=n, oracle_wait_s=wait)
    return idx


def build_sorts(text_d, out_dir: str):
    """(compiled `build_sa` program at this size, every sort in it and
    how XLA lowered it, compile seconds); the HLO goes to `out_dir`.

    JAX's caches key a program without its source metadata, so a cached
    executable can carry the op_names of older code. This compile clears
    the in-memory caches and keys the persistent one on metadata, so
    each sort's `site` names the engine's current scopes."""
    import jax

    from stringsearch_tpu.engines.doubling import _auto_depth, build_sa
    from stringsearch_tpu.harness import profile

    n = int(text_d.shape[0])
    key = "jax_compilation_cache_include_metadata_in_key"
    saved = getattr(jax.config, key)
    jax.clear_caches()
    jax.config.update(key, True)
    try:
        t0 = time.perf_counter()
        compiled = build_sa.lower(text_d, depth=_auto_depth(n)).compile()
        compile_s = time.perf_counter() - t0
    finally:
        jax.config.update(key, saved)
    hlo = compiled.as_text()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"build_sa_{n}.hlo.txt"), "w") as f:
        f.write(hlo)
    return compiled, profile.sort_lowerings(hlo), compile_s


def phase_trace(report: Report, idx, out_dir: str) -> dict:
    """c. One traced warm run of the headline build program (`build_sa`
    at the depth `st.build_suffix_array` picks): per-sort device time
    and lowering, and the device's idle share over the build. The trace
    runs the executable whose HLO names the sorts. Raises on a trace
    with no GPU plane, or when no sort kernel is found in it."""
    import jax

    from stringsearch_tpu.harness import profile

    text_d = idx.text
    n = int(text_d.shape[0])
    compiled, sorts, compile_s = build_sorts(text_d, out_dir)
    _block(compiled(text_d))  # warm
    trace_dir = os.path.join(out_dir, f"trace_build_{n}")
    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation(profile.WINDOW):
            _block(compiled(text_d))
    summary = profile.summarize(profile.latest_xplane(trace_dir), sorts)
    if summary["sort_device_s"] <= 0:
        raise AssertionError("no sort of the HLO was found in the trace")
    return report.line("c.trace_build", n=n, hlo_compile_s=compile_s,
                       **summary)


def phase_queries(report: Report, idx, text: np.ndarray, oracle_sa) -> None:
    """d. A 256-needle LCS batch and a 256-needle sa_search batch."""
    from stringsearch_tpu.core.search import sa_search_batch

    sa = oracle_sa.result()
    needles = make_needles(text, QUERY_BATCH, SEED)
    matches, first, warm = first_and_warm(
        lambda: idx.longest_substring_match_batch(needles))
    check_lcs(text, sa, needles, matches)
    report.line("d.lcs_batch", batch=len(needles), **_timing(first, warm))
    needles = make_needles(text, QUERY_BATCH, SEED + 1)
    results, first, warm = first_and_warm(
        lambda: sa_search_batch(idx, needles))
    check_search(text, sa, needles, results)
    report.line("d.sa_search_batch", batch=len(needles),
                **_timing(first, warm))


def phase_bwt(report: Report, text: np.ndarray, oracle_bwt) -> None:
    """e. Forward BWT against the oracle's, and an exact round trip."""
    from stringsearch_tpu.transforms import divbwt, unbwt

    (u, pidx), first, warm = first_and_warm(lambda: divbwt(text))
    if (u, pidx) != oracle_bwt.result():
        raise AssertionError("BWT differs from the oracle")
    report.line("e.bwt", n=len(text), **_timing(first, warm))
    back, first, warm = first_and_warm(lambda: unbwt(u, pidx))
    if back != text.tobytes():
        raise AssertionError("inverse BWT does not round-trip")
    report.line("e.unbwt", n=len(text), **_timing(first, warm))


def phase_partitioned(report: Report, text: np.ndarray, oracle_sa) -> None:
    """f. PartitionedSuffixArray: build, LCS and sa_search batches."""
    import stringsearch_tpu as st

    pidx, first, warm = first_and_warm(
        lambda: _ready(st.PartitionedSuffixArray(text, PARTS)))
    report.line("f.partitioned_build", n=len(text), parts=PARTS,
                **_timing(first, warm))
    sa, part = oracle_sa.result(), pidx.partition_size
    needles = make_needles(text, QUERY_BATCH, SEED + 2)
    matches, first, warm = first_and_warm(
        lambda: pidx.longest_substring_match_batch(needles))
    check_lcs(text, sa, needles, matches, part)
    report.line("f.partitioned_lcs_batch", batch=len(needles),
                **_timing(first, warm))
    results, first, warm = first_and_warm(
        lambda: pidx.sa_search_batch(needles))
    check_search(text, sa, needles, results, part)
    report.line("f.partitioned_sa_search_batch", batch=len(needles),
                **_timing(first, warm))


def phase_engines(report: Report, text: np.ndarray, oracle_sa) -> None:
    """g. dc3 and bstar, byte-exact against the oracle."""
    import stringsearch_tpu as st

    want = oracle_sa.result()
    for engine in ("dc3", "bstar"):
        idx, first, warm = first_and_warm(
            lambda: st.build_suffix_array(text, engine=engine).sa)
        if not np.array_equal(np.asarray(idx), want):
            raise AssertionError(f"{engine} SA differs from the oracle")
        report.line(f"g.{engine}", n=len(text), **_timing(first, warm))


def phase_gpu_tests(report: Report) -> None:
    """The tests marked `gpu`, run by pytest in this process."""
    import jax
    import pytest

    saved = jax.config.jax_default_device
    t0 = time.perf_counter()
    try:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          "tests"])
    finally:  # tests/conftest.py pins the CPU as the default device
        jax.config.update("jax_default_device", saved)
    if rc != 0:
        raise AssertionError(f"gpu tests failed: pytest exit {int(rc)}")
    report.line("tests.gpu", run_s=time.perf_counter() - t0)


def phase_four(report: Report, devs, text: np.ndarray, oracle_sa,
               oracle_sa_prefix, sharded_n: int):
    """h. Global SA over four devices, and a sharded partitioned index.
    Returns the mesh."""
    import jax.numpy as jnp

    from stringsearch_tpu.parallel.global_sa import build_global
    from stringsearch_tpu.parallel.mesh import ShardedSuffixArray, make_mesh

    mesh = make_mesh(len(devs), batch_axis=1, devices=devs)
    text_d = jnp.asarray(text)
    n = len(text)
    g, first, warm = first_and_warm(lambda: _ready(build_global(text_d, mesh)))
    shards = g._sa_sharded.addressable_shards
    placement = sorted((str(s.device), s.data.shape[0]) for s in shards)
    if len({d for d, _ in placement}) != len(devs) or any(
            m != g.chunk_len for _, m in placement):
        raise AssertionError(f"global SA is not spread evenly: {placement}")
    stats = [d.memory_stats() for d in devs]
    if all(stats):  # the CPU reports none
        idle = [str(d) for d, s in zip(devs, stats)
                if s["peak_bytes_in_use"] < 4 * g.chunk_len]
        if idle:
            raise AssertionError(f"{idle} never held a shard of the SA")
    report.line("h.build_global", n=n, shards=len(devs),
                sharding=str(g._sa_sharded.sharding.spec),
                placement=placement, rounds=g.rounds_run,
                bytes_per_s=n / warm, **_timing(first, warm))
    t0 = time.perf_counter()
    g.verify()
    report.line("h.global_verify", n=n, run_s=time.perf_counter() - t0)

    # the sharded index runs while the host oracle still sorts 2^30 bytes
    prefix = text[:sharded_n]
    sidx, first, warm = first_and_warm(
        lambda: _ready(ShardedSuffixArray(prefix, mesh)))
    report.line("h.sharded_build", n=sharded_n, **_timing(first, warm))
    needles = make_needles(prefix, QUERY_BATCH, SEED + 3)
    matches, first, warm = first_and_warm(
        lambda: sidx.longest_substring_match_batch(needles))
    check_lcs(prefix, oracle_sa_prefix.result(), needles, matches,
              sidx.partition_size)
    report.line("h.sharded_lcs_batch", batch=len(needles),
                **_timing(first, warm))
    del sidx

    t0 = time.perf_counter()
    want = oracle_sa.result()
    wait = time.perf_counter() - t0
    if not np.array_equal(g.suffix_array(), want):
        raise AssertionError("global SA differs from the oracle")
    report.line("h.global_oracle_byte_exact", n=n, oracle_wait_s=wait)
    return mesh


def phase_four_trace(report: Report, mesh, text: np.ndarray,
                     out_dir: str) -> dict:
    """h. One traced global build: each device's collective time and the
    part of it that no other kernel hides. Raises on a trace with no GPU
    plane."""
    import jax
    import jax.numpy as jnp

    from stringsearch_tpu.harness import profile
    from stringsearch_tpu.parallel.global_sa import build_global

    text_d = jnp.asarray(text)
    trace_dir = os.path.join(out_dir, f"trace_global_{len(text)}")
    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation(profile.WINDOW):
            _ready(build_global(text_d, mesh))
    return report.line("h.trace_global", n=len(text),
                       **profile.summarize_collectives(
                           profile.latest_xplane(trace_dir)))


# ---------------------------------------------------------------------------


def run_one(devs, card, logs: dict, out_dir: str = OUT_DIR) -> None:
    """Phases b-g at the sizes in `logs`, oracles on host threads."""
    from stringsearch_tpu import oracle
    from stringsearch_tpu.harness.corpus import enwik_like

    report = Report(devs, card)
    t0 = time.perf_counter()
    text = np.frombuffer(enwik_like(1 << logs["build"], seed=SEED), np.uint8)
    report.line("b.generate_text", n=len(text), run_s=time.perf_counter() - t0)
    oracle.load()
    bwt_text = text[:1 << logs["bwt"]]
    part_text = text[:1 << logs["part"]]
    engine_text = text[:1 << logs["engine"]]
    # ctypes releases the GIL: the host oracles run beside the device work
    with ThreadPoolExecutor(max_workers=4) as pool:
        sa_build = pool.submit(oracle.build, text)
        bwt_ref = pool.submit(oracle.bwt, bwt_text)
        sa_part = pool.submit(oracle.build, part_text)
        sa_engine = pool.submit(oracle.build, engine_text)
        idx = phase_build(report, text, sa_build)
        phase_trace(report, idx, out_dir)
        phase_queries(report, idx, text, sa_build)
        del idx
        phase_bwt(report, bwt_text, bwt_ref)
        phase_partitioned(report, part_text, sa_part)
        phase_engines(report, engine_text, sa_engine)


def run_four(devs, card, logs: dict, out_dir: str = OUT_DIR) -> None:
    from stringsearch_tpu import oracle
    from stringsearch_tpu.harness.corpus import enwik_like

    report = Report(devs, card)
    t0 = time.perf_counter()
    text = np.frombuffer(enwik_like(1 << logs["global"], seed=SEED), np.uint8)
    report.line("h.generate_text", n=len(text), run_s=time.perf_counter() - t0)
    oracle.load()
    sharded_n = 1 << logs["sharded"]
    with ThreadPoolExecutor(max_workers=2) as pool:
        sa_global = pool.submit(oracle.build, text)
        sa_prefix = pool.submit(oracle.build, text[:sharded_n])
        mesh = phase_four(report, devs, text, sa_global, sa_prefix,
                          sharded_n)
    phase_four_trace(report, mesh, text, out_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase h")
    args = ap.parse_args(argv)
    count = FOUR if args.four else 1
    devs, card = phase_device_check(count)
    print(f"card: {card}", flush=True)

    from stringsearch_tpu.utils.compile_cache import enable_persistent_cache

    cache = enable_persistent_cache()
    cache_warm = bool(cache and os.path.isdir(cache) and os.listdir(cache))
    Report(devs, card).line("a.device_check", devices=[str(d) for d in devs],
                            compile_cache=cache, cache_warm=cache_warm)
    if args.four:
        run_four(devs, card, {"global": GLOBAL_LOG2, "sharded": SHARDED_LOG2})
    else:
        run_one(devs, card, {"build": BUILD_LOG2, "bwt": BWT_LOG2,
                             "part": PART_LOG2, "engine": ENGINE_LOG2})
        phase_gpu_tests(Report(devs, card))
    import jax

    from stringsearch_tpu.harness.device import device_record

    print(json.dumps({"ok": True, "device": device_record(jax.devices())}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
