"""Continuous differential fuzzing — cargo-fuzz/libFuzzer equivalent.

Capability parity: the reference fuzzes `sort(arbitrary bytes)` with
libFuzzer and commits minimized crashers back into the regression corpus
(ref: crates/divsufsort/fuzz/fuzz_targets/fuzz_target_1.rs:4-6; corpus at
crates/divsufsort/src/testdata/, crash-<hash> naming; replay at
crates/divsufsort/src/lib.rs:31-92 — our replay is
tests/test_corpus_replay.py over tests/corpus/).

Each iteration generates adversarial bytes (mutation strategies biased
toward SACA-breaking patterns: runs, repeats, low alphabets, splices),
then exercises the selected targets:

  * engines      — sort with each engine, verify on-device, crosscheck
                   byte-exact against the C++ oracle;
  * partitioned  — PartitionedSuffixArray queries (2..4 partitions) must
                   return full-index-equivalent match lengths (this build
                   repairs boundary matches, so equality is exact);
  * global       — the distributed exact global SA over a virtual device
                   mesh, byte-exact vs the oracle, incl. distributed
                   sa_search slot parity;
  * transforms   — BWT == oracle BWT, unbwt roundtrips (device and
                   cross-implementation), sa_search/simplesearch parity
                   on sampled + random needles.

Input lengths are drawn from a fixed per-run pool (adversarial small
sizes + random sizes) rather than uniformly: every distinct length is a
fresh XLA compile, so a pool keeps 10k-iteration campaigns from spending
all their time in the compiler while still covering odd/prime/boundary
lengths.

Failures are shrunk by greedy bisection and written to
fuzz-crashes/crash-<sha1>, matching the reference's naming convention;
commit survivors under tests/corpus/ so CI replays them forever.

Run: python -m stringsearch_tpu.harness.fuzz --iters 200 --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np

# always-in-pool adversarial lengths: tiny, power-of-two straddles, and
# the reference corpus's size neighborhood (17 B - 4.7 KB crashers)
_FIXED_LENS = (
    1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65,
    100, 127, 128, 129, 255, 256, 257, 511, 512, 1000, 1023, 1024,
    2047, 2048,
)


def _length_pool(rng: np.random.Generator, max_len: int, extra: int = 32):
    pool = [n for n in _FIXED_LENS if n <= max_len]
    pool += [int(n) for n in rng.integers(1, max_len + 1, extra)]
    return sorted(set(pool))


def _mutate(rng: np.random.Generator, n: int) -> bytes:
    strategy = int(rng.integers(0, 6))
    if strategy == 0:  # uniform random
        return bytes(rng.integers(0, 256, n, dtype=np.uint8))
    if strategy == 1:  # tiny alphabet
        a = int(rng.choice([1, 2, 3, 4]))
        return bytes(rng.integers(0, a, n, dtype=np.uint8))
    if strategy == 2:  # periodic repeats
        p = int(rng.integers(1, 9))
        unit = bytes(rng.integers(0, 256, p, dtype=np.uint8))
        return (unit * (n // p + 1))[:n]
    if strategy == 3:  # long runs with rare breaks
        arr = np.full(n, int(rng.integers(0, 256)), dtype=np.uint8)
        for _ in range(int(rng.integers(0, 4))):
            arr[int(rng.integers(0, n))] = int(rng.integers(0, 256))
        return bytes(arr)
    if strategy == 4:  # splice of two periodic regions
        h = max(n // 2, 1)
        a = _mutate(rng, h)
        b = _mutate(rng, n - h) if n > h else b""
        return (a + b)[:n]
    # near-sorted bytes
    arr = np.sort(rng.integers(0, 256, n, dtype=np.uint8))
    idx = rng.integers(0, n, max(1, n // 10))
    arr[idx] = rng.integers(0, 256, len(idx), dtype=np.uint8)
    return bytes(arr)


def _check_engines(data: bytes, engines):
    """Differential check vs the C++ oracle.

    Returns (error string or None, oracle SA) — the SA is reused by the
    i64 check so `--idx64` iterations don't build it twice."""
    from stringsearch_tpu import oracle
    from stringsearch_tpu.core.types import NotSorted
    from stringsearch_tpu.engines import get_engine

    want = oracle.build(data)
    if oracle.sufcheck(data, want) != 0:
        return "oracle output failed sufcheck", want
    for name in engines:
        sa = get_engine(name)(data)
        try:
            sa.verify()
        except NotSorted as e:
            return f"{name}: verify failed: {e}", want
        if not np.array_equal(np.asarray(sa.sa), want):
            return f"{name}: mismatch vs oracle", want
    return None, want


def _input_rng(data: bytes) -> np.random.Generator:
    """Deterministic RNG derived from the input bytes.

    The partitioned check's needle draws come from here so a shrunken
    crash artifact reproduces its failure from the file alone (the
    reference's crash-<sha1> corpus has the same replay property,
    ref: crates/divsufsort/src/lib.rs:31-92)."""
    seed = int.from_bytes(hashlib.sha1(data).digest()[:8], "little")
    return np.random.default_rng(seed)


def _check_partitioned(data: bytes) -> str | None:
    """Partitioned query semantics vs the full index.

    Partitioned matches are DOCUMENTED as possibly shorter when every
    full-text-optimal occurrence crosses a partition boundary (the
    reference pins the same degradation, crates/sacapart/src/lib.rs:106-126
    worse_test; our full-text repair mitigates but the in-chunk search can
    surface a tie candidate that extends worse). The invariant is:
      1. the returned match is genuine (bytes really match, within text);
      2. never longer than the full-index optimum;
      3. equal to the optimum whenever SOME optimal occurrence lies
         entirely inside one partition.
    """
    from stringsearch_tpu import PartitionedSuffixArray, build_suffix_array

    if len(data) < 4:
        return None
    rng = _input_rng(data)
    full = build_suffix_array(data)
    nparts = int(rng.choice([2, 3, 4]))
    part = PartitionedSuffixArray(data, nparts)
    psize = part.partition_size
    needles = []
    for _ in range(4):
        s = int(rng.integers(0, len(data)))
        e = min(len(data), s + int(rng.integers(1, 48)))
        needles.append(data[s:e])
    needles.append(bytes(rng.integers(0, 256, 8, dtype=np.uint8)))
    for nd in needles:
        got = part.longest_substring_match(nd)
        want = full.longest_substring_match(nd)
        if data[got.start : got.start + got.len] != nd[: got.len]:
            return f"partitioned({nparts}) match bytes wrong for {nd[:16]!r}"
        if got.len > want.len:
            return (
                f"partitioned({nparts}) OVERclaims {got.len} > full "
                f"{want.len} for {nd[:16]!r}"
            )
        if got.len < want.len:
            # acceptable only if every optimal occurrence crosses a
            # partition boundary
            best = nd[: want.len]
            s = data.find(best)
            while s != -1:
                if s // psize == (s + want.len - 1) // psize:
                    return (
                        f"partitioned({nparts}) len {got.len} != full "
                        f"{want.len} with an in-partition occurrence at "
                        f"{s} for {nd[:16]!r}"
                    )
                s = data.find(best, s + 1)
    # partitioned sa_search: in-partition count vs host brute force
    nd = needles[0][:8]
    if nd:
        want_pos = []
        s = data.find(nd)
        while s != -1:
            if s // psize == (s + len(nd) - 1) // psize:
                want_pos.append(s)
            s = data.find(nd, s + 1)
        count, first = part.sa_search(nd)
        if count != len(want_pos) or (
            want_pos and first != min(want_pos)
        ):
            return (f"partitioned({nparts}) sa_search {count}@{first} vs "
                    f"brute {len(want_pos)}@"
                    f"{min(want_pos) if want_pos else -1} for {nd[:16]!r}")
    return None


def _check_global(data: bytes, mesh, idx64: bool = False) -> str | None:
    """Distributed exact global SA vs the oracle + sharded self-verify.

    (depth, fan) are randomized per input — derived from the input bytes
    like the needle draws, so crash artifacts replay deterministically —
    covering the non-default configurations the build path exposes.
    """
    import jax.numpy as jnp

    from stringsearch_tpu import oracle
    from stringsearch_tpu.core.types import NotSorted
    from stringsearch_tpu.parallel.global_sa import build_global

    rng = _input_rng(data + b"/cfg")
    depth = int(rng.choice([4, 8, 16]))
    fan = int(rng.choice([2, 3, 4]))
    compaction = bool(rng.integers(0, 2))
    idx = jnp.int64 if idx64 else jnp.int32
    want = oracle.build(data)
    g = build_global(data, mesh, idx=idx, depth=depth, fan=fan,
                     compaction=compaction)
    got = np.asarray(g.suffix_array())
    if not np.array_equal(got, want):
        return f"global SA mismatch vs oracle (depth={depth} fan={fan})"
    try:
        g.verify()  # the distributed no-materialization checker
    except NotSorted as e:
        return (f"global sharded verify rejected a correct SA "
                f"(depth={depth} fan={fan}): {e}")
    # distributed sa_search: slot-exact vs the oracle's flat-SA search
    if len(data) >= 2:
        s = int(rng.integers(0, len(data) - 1))
        e = min(len(data), s + int(rng.integers(1, 16)))
        for nd in (data[s:e], b"\x00"):
            wc, wl = oracle.search(data, nd, want)
            gc, gl = g.sa_search(nd)
            if gc != wc or (gc and gl != wl):
                return (f"global sa_search mismatch for {nd[:16]!r}: "
                        f"({gc},{gl}) vs ({wc},{wl})")
    return None


def _check_transforms(data: bytes) -> str | None:
    """BWT/unBWT and search-path differential checks vs the oracle
    (the r4 gap: transforms and search were corpus-tested, never fuzzed;
    ref fuzz surface: crates/divsufsort/fuzz/fuzz_targets/fuzz_target_1.rs
    covers only sort — this target goes wider than the reference).

      * device bwt == oracle bwt (bytes AND primary index);
      * unbwt(bwt(x)) == x (device roundtrip);
      * unbwt(oracle_bwt) == x (cross-implementation roundtrip);
      * sa_search / sa_simplesearch == oracle on text-sampled + random
        needles (counts and leftmost SA slots).
    """
    from stringsearch_tpu import build_suffix_array, oracle
    from stringsearch_tpu.transforms.bwt import divbwt, unbwt

    want_u, want_p = oracle.bwt(data)
    got_u, got_p = divbwt(data)
    if got_u != want_u or got_p != want_p:
        return f"bwt mismatch vs oracle (pidx {got_p} vs {want_p})"
    if unbwt(got_u, got_p) != data:
        return "unbwt(bwt(x)) != x"
    if unbwt(want_u, want_p) != data:
        return "unbwt(oracle bwt) != x"
    if len(data) == 0:
        return None
    sa = build_suffix_array(data)
    osa = oracle.build(data)
    rng = _input_rng(data + b"/search")
    needles = []
    for _ in range(3):
        s = int(rng.integers(0, len(data)))
        e = min(len(data), s + int(rng.integers(1, 32)))
        needles.append(data[s:e])
    needles.append(bytes(rng.integers(0, 256, 6, dtype=np.uint8)))
    for nd in needles:
        wc, wl = oracle.search(data, nd, osa)
        gc, gl = sa.search(nd)
        if gc != wc or (gc and gl != wl):
            return (f"sa_search mismatch for {nd[:16]!r}: "
                    f"({gc},{gl}) vs ({wc},{wl})")
    for c in (int(data[0]), int(rng.integers(0, 256))):
        wc, wl = oracle.simplesearch(data, c, osa)
        from stringsearch_tpu.core.search import sa_simplesearch

        gc, gl = sa_simplesearch(sa, c)
        if gc != wc or (gc and gl != wl):
            return f"simplesearch mismatch for byte {c}"
    return None


def _make_mesh():
    import jax
    from jax.sharding import Mesh

    devs = jax.devices("cpu") if any(
        d.platform == "cpu" for d in jax.devices()
    ) else jax.devices()
    n = len(devs)
    while n & (n - 1):
        n -= 1
    return Mesh(np.array(devs[:n]), ("parts",))


def _check_engines_i64(data: bytes, want: np.ndarray) -> str | None:
    """64-bit index mode parity (ref: BUILD_DIVSUFSORT64,
    c-sources/divsufsort_private.h:63-84) — the doubling engine with
    idx=int64 must match the oracle SA `want` already computed by
    `_check_engines` for this input."""
    import jax.numpy as jnp

    from stringsearch_tpu.engines.doubling import build_with_isa

    arr = np.frombuffer(data, dtype=np.uint8)
    if len(arr) < 3:
        return None
    sa, _isa = build_with_isa(arr, idx=jnp.int64)
    if not np.array_equal(np.asarray(sa), want):
        return "doubling idx=int64: mismatch vs oracle"
    return None


def _check(data: bytes, engines, targets, mesh, idx64: bool = False) -> str | None:
    """Run every selected target check on `data`.

    Deterministic in `data`: any randomness (partitioned needles, global
    build configs) is seeded from the input bytes, so crash artifacts
    replay exactly."""
    if "engines" in targets:
        err, want = _check_engines(data, engines)
        if err:
            return err
        if idx64:
            err = _check_engines_i64(data, want)
            if err:
                return err
    if "partitioned" in targets:
        err = _check_partitioned(data)
        if err:
            return err
    if "global" in targets and mesh is not None:
        err = _check_global(data, mesh, idx64)
        if err:
            return err
    if "transforms" in targets:
        err = _check_transforms(data)
        if err:
            return err
    return None


def _shrink(data: bytes, engines, targets, mesh, idx64: bool = False) -> bytes:
    """Greedy bisection shrink of a failing input (deterministic)."""
    changed = True
    while changed and len(data) > 1:
        changed = False
        for cut in (len(data) // 2, len(data) // 4, 1):
            if cut == 0:
                continue
            for cand in (data[cut:], data[:-cut]):
                if cand and _check(cand, engines, targets, mesh,
                                   idx64) is not None:
                    data = cand
                    changed = True
                    break
            if changed:
                break
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stringsearch-tpu-fuzz")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--engines", default="doubling")
    ap.add_argument(
        "--targets",
        default="engines",
        help="comma list: engines,partitioned,global,transforms",
    )
    ap.add_argument("--device", default=None, choices=[None, "cpu", "gpu"])
    ap.add_argument("--out", default="fuzz-crashes")
    ap.add_argument(
        "--replay", default=None, metavar="FILE",
        help="re-run the checks on a crash artifact and exit "
             "(deterministic: needles are derived from the bytes)",
    )
    ap.add_argument(
        "--idx64", action="store_true",
        help="also exercise the 64-bit index paths (doubling idx=int64 "
             "parity; global build with idx=int64); enables jax x64",
    )
    args = ap.parse_args(argv)

    if args.idx64:
        import jax

        jax.config.update("jax_enable_x64", True)
    from stringsearch_tpu.harness.device import select_device
    from stringsearch_tpu.utils.compile_cache import enable_persistent_cache

    if args.device is not None and not select_device(args.device):
        return 2
    # off on the CPU backend (see utils/compile_cache.py): CPU campaigns
    # rely on periodic jax.clear_caches() (mmap budget) instead
    enable_persistent_cache()


    seed = args.seed if args.seed is not None else int(time.time())
    rng = np.random.default_rng(seed)
    engines = args.engines.split(",")
    targets = set(args.targets.split(","))
    mesh = _make_mesh() if "global" in targets else None

    if args.replay is not None:
        with open(args.replay, "rb") as f:
            data = f.read()
        err = _check(data, engines, targets, mesh, args.idx64)
        print(f"replay {args.replay} ({len(data)}B): "
              f"{err if err else 'no failure'}")
        return 1 if err else 0
    lens = _length_pool(rng, args.max_len)
    print(
        f"fuzzing targets={sorted(targets)} engines={engines} seed={seed} "
        f"iters={args.iters} length-pool={len(lens)}",
        flush=True,
    )

    clear_every = int(os.environ.get("STRINGSEARCH_TPU_FUZZ_CLEAR_EVERY",
                                     "250"))
    failures = 0
    for i in range(args.iters):
        n = int(rng.choice(lens))
        data = _mutate(rng, n)
        err = _check(data, engines, targets, mesh, args.idx64)
        if err is not None:
            failures += 1
            shrunk = _shrink(data, engines, targets, mesh, args.idx64)
            digest = hashlib.sha1(shrunk).hexdigest()
            os.makedirs(args.out, exist_ok=True)
            path = os.path.join(args.out, f"crash-{digest}")
            with open(path, "wb") as f:
                f.write(shrunk)
            print(f"[{i}] FAILURE: {err} -> shrunk to {len(shrunk)}B at {path}",
                  flush=True)
        if (i + 1) % 25 == 0:
            print(f"[{i + 1}/{args.iters}] ok so far, {failures} failures",
                  flush=True)
        if (i + 1) % clear_every == 0:
            # long campaigns accumulate one compiled executable per
            # (length, target) pair; drop them before the process hits
            # memory limits (tunable: a larger interval trades memory
            # headroom for fewer recompile cycles)
            import jax

            jax.clear_caches()
    print(f"done: {args.iters} iterations, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
