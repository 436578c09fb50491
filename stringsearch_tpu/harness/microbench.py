"""Measured op-cost table + build-phase profiler for the doubling engine.

This regenerates (and extends) the README op-cost table that drives the
engine's design decisions (lax.sort vs scatter vs gather trade-offs), and
profiles where wall-clock goes inside `build_with_isa` — phase by phase,
round by round — so perf work has a reproducible footing.

Runs on the default JAX device (the GPU on a machine that has one; the
CPU numbers of a smoke run say nothing about the device):

    python -m stringsearch_tpu.harness.microbench ops --n 24
    python -m stringsearch_tpu.harness.microbench phases --n 24

Reference analog: the divsuftest `bench` harness measures engine-level
bytes/s only (ref: crates/divsuftest/src/main.rs:123-190); this goes one
level deeper because the design question is *which primitive* to spend
device-memory bandwidth on.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _timeit(fn, *args, reps: int = 5) -> float:
    """Median wall time of fn(*args) after one warm-up call, in seconds;
    each timed call ends in `block_until_ready`."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def op_costs(log_n: int, reps: int = 5) -> dict:
    """Cost table for the primitives the engine is built from."""
    import jax
    import jax.numpy as jnp

    n = 1 << log_n
    key = jax.random.PRNGKey(0)
    r32 = jax.random.randint(key, (n,), 0, n, dtype=jnp.int32)
    r32b = jax.random.randint(jax.random.PRNGKey(1), (n,), 0, n, jnp.int32)
    j = jnp.arange(n, dtype=jnp.int32)
    perm = jax.random.permutation(jax.random.PRNGKey(2), n).astype(jnp.int32)

    results = {}

    def add(name, fn, *args):
        results[name] = _timeit(jax.jit(fn), *args, reps=reps)

    add("sort_1key_1op", lambda a: jax.lax.sort((a,), num_keys=1)[0], r32)
    add("sort_1key_2op",
        lambda a, b: jax.lax.sort((a, b), num_keys=1), r32, j)
    add("sort_1key_3op",
        lambda a, b, c: jax.lax.sort((a, b, c), num_keys=1), r32, r32b, j)
    add("sort_2key_3op",
        lambda a, b, c: jax.lax.sort((a, b, c), num_keys=2), r32, r32b, j)
    add("sort_3key_3op",
        lambda a, b, c: jax.lax.sort((a, b, c), num_keys=3), r32, r32b, j)
    ks6 = tuple(
        jax.random.randint(jax.random.PRNGKey(10 + i), (n,), 0, n, jnp.int32)
        for i in range(6)
    )
    add("sort_4key_5op",
        lambda *a: jax.lax.sort(a, num_keys=4), *ks6[:4], j)
    add("sort_6key_7op",
        lambda *a: jax.lax.sort(a, num_keys=6), *ks6, j)
    # top_k as a stream-compaction candidate (extract the m smallest keys
    # + positions without a full-width sort)
    add("topk_n64",
        lambda a: jax.lax.top_k(-a, n // 64), r32)
    add("topk_n256",
        lambda a: jax.lax.top_k(-a, n // 256), r32)
    if n >= 16:
        add("topk_n16",
            lambda a: jax.lax.top_k(-a, n // 16), r32)
        add("topk_n4",
            lambda a: jax.lax.top_k(-a, n // 4), r32)
    add("gather", lambda a, p: jnp.take(a, p), r32, perm)
    # monotone and small-table lookups against the random gather above:
    # whether the index pattern changes a gather's cost
    add("gather_monotone", lambda a, p: jnp.take(a, p), r32, jnp.sort(perm))
    add("gather_table256",
        lambda t, i: jnp.take(t, i),
        jnp.arange(256, dtype=jnp.int32), r32 & 255)
    # row-slice gather (vmapped dynamic_slice): the one cheap gather form.
    # Row width shrinks with n so the probe stays valid for tiny --n
    # (dynamic_slice requires width <= n).
    row_w = min(4096, n)
    nrows = max(n // row_w, 1)
    starts = jax.random.randint(jax.random.PRNGKey(5), (nrows,), 0,
                                max(n - row_w, 1), jnp.int32)
    add(f"slice_gather_rows{row_w}",
        lambda a, s: jax.vmap(
            lambda st: jax.lax.dynamic_slice_in_dim(a, st, row_w))(s),
        r32, starts)
    # batched (segmented) sorts against the flat ones: the per-element
    # cost behind the compaction cascade's width shrinking
    if n >= (1 << 16):
        b = n // 4096
        a2 = r32.reshape(b, 4096)
        p2 = jnp.broadcast_to(jnp.arange(4096, dtype=jnp.int32), (b, 4096))
        add("batched_sort_1key_2op_rows4096",
            lambda a, p: jax.lax.sort((a, p), num_keys=1, dimension=1),
            a2, p2)
        ks5 = tuple(k.reshape(b, 4096) for k in ks6[:5])
        add("batched_sort_5key_6op_rows4096",
            lambda *a: jax.lax.sort(a, num_keys=5, dimension=1), *ks5, p2)
    add("scatter_set", lambda a, p: jnp.zeros_like(a).at[p].set(a), r32, perm)
    add("scatter_via_sort",
        lambda p, v: jax.lax.sort((p, v), num_keys=1)[1], perm, r32)
    add("cummax", jax.lax.cummax, r32)
    add("cumsum", jnp.cumsum, r32)
    add("shift_concat_slice",
        lambda a: jax.lax.dynamic_slice_in_dim(
            jnp.concatenate([a, jnp.full((n,), -1, a.dtype)]), 8, n),
        r32)
    add("elementwise_3in",
        lambda a, b, c: jnp.where(a > b, c, a + b), r32, r32b, j)
    # i64 single-key sort (packed-key rounds candidate)
    if jax.config.read("jax_enable_x64"):
        r64 = r32.astype(jnp.int64) * n + r32b.astype(jnp.int64)
        add("sort_1key_2op_i64",
            lambda a, b: jax.lax.sort((a, b), num_keys=1), r64, j)
    # f32 single-key sort (bit-packed key candidate: 2x24-bit ranks)
    rf = jax.lax.bitcast_convert_type(r32, jnp.float32)
    add("sort_1key_2op_f32_bitcast",
        lambda a, b: jax.lax.sort((a, b), num_keys=1), rf, j)
    return results


def phase_profile(log_n: int, reps: int = 3, depth: int = 12,
                  fan: int = 4) -> dict:
    """Per-phase timing + round counts of the r4 lazy-invert build on
    enwik text: initial sorted-order sort, the inverse permutation each
    round pays for its predecessor, and the fan round's sort — plus the
    compaction tail when anything stays tied."""
    import jax
    import jax.numpy as jnp

    from stringsearch_tpu.engines import doubling as D
    from stringsearch_tpu.harness.corpus import enwik_like

    n = 1 << log_n
    text = jnp.asarray(np.frombuffer(enwik_like(n), dtype=np.uint8))

    init = jax.jit(D._initial_sorted, static_argnames=("depth",))
    invert = jax.jit(D._scatter_to_text_order)
    full = jax.jit(D._full_round_sorted, static_argnames=("fan",))
    extract = jax.jit(D._extract, static_argnums=(2,))
    shrink = jax.jit(D._shrink, static_argnums=(2,))
    compact = jax.jit(D._compact_round)

    out = {"n": n, "depth": depth, "fan": fan}
    init_d = lambda t: init(t, depth=depth)  # noqa: E731
    out["t_initial_sorted"] = _timeit(init_d, text, reps=reps)
    sa_s, rank_s, count = init_d(text)
    out["t_invert"] = _timeit(invert, sa_s, rank_s, reps=reps)
    rank = invert(sa_s, rank_s)
    counts = [int(count)]
    t_full = []
    h = depth
    threshold = n // 4
    while counts[-1] > threshold and h < n:
        t_full.append(_timeit(
            lambda r: full(r, jnp.asarray(h, jnp.int32), fan=fan),
            rank, reps=reps))
        sa_s, rank_s, count = full(rank, jnp.asarray(h, jnp.int32), fan=fan)
        counts.append(int(count))
        h = min(h * fan, n)
        if counts[-1] > threshold:
            rank = invert(sa_s, rank_s)
    out["full_rounds"] = len(t_full)
    out["t_full_sorted_each"] = [round(t, 4) for t in t_full]
    out["tied_counts"] = counts
    if counts[-1] == 0:
        out["note"] = ("resolved in the full rounds: the fused build_sa "
                       "skips every phase below this line")
        from stringsearch_tpu.engines.doubling import build_sa

        out["t_total_fused"] = _timeit(
            lambda t: build_sa(t, depth=depth, fan=fan), text, reps=reps)
        out["bytes_per_s_fused"] = round(n / out["t_total_fused"], 1)
        return out
    rank = invert(sa_s, rank_s)
    m1 = max(n // 4, 1)
    m2 = min(n, max(n // 64, 64), m1)
    out["t_extract_l1"] = _timeit(extract, rank_s, sa_s, m1, reps=reps)
    g, pos = extract(rank_s, sa_s, m1)
    sa = sa_s
    t_comp = []
    comp_counts = []
    while int(count) > m2 and h < n:
        t_comp.append(_timeit(
            compact, g, pos, rank, sa, jnp.asarray(h, jnp.int32), reps=reps))
        g, pos, rank, sa, count = compact(
            g, pos, rank, sa, jnp.asarray(h, jnp.int32))
        comp_counts.append(int(count))
        h *= 2
    out["l1_rounds"] = len(t_comp)
    out["t_l1_each"] = [round(t, 4) for t in t_comp]
    out["t_shrink_l2"] = _timeit(shrink, g, pos, m2, reps=reps)
    g, pos = shrink(g, pos, m2)
    t2 = []
    while int(count) > 0 and h < n:
        t2.append(_timeit(
            compact, g, pos, rank, sa, jnp.asarray(h, jnp.int32), reps=reps))
        g, pos, rank, sa, count = compact(
            g, pos, rank, sa, jnp.asarray(h, jnp.int32))
        comp_counts.append(int(count))
        h *= 2
    out["l2_rounds"] = len(t2)
    out["t_l2_each"] = [round(t, 4) for t in t2]
    out["compact_tied_counts"] = comp_counts
    from stringsearch_tpu.engines.doubling import build_sa

    out["t_total_fused"] = _timeit(
        lambda t: build_sa(t, depth=depth, fan=fan), text, reps=reps)
    out["bytes_per_s_fused"] = round(n / out["t_total_fused"], 1)
    return out


def tied_curve(log_n: int, depth: int = 12, fan: int = 2,
               reps: int = 2) -> dict:
    """Tied-position counts vs resolved key depth on enwik-like text.

    Drives the (depth, fan) configuration choice: full rounds are worth
    their price exactly until the tied count fits a compaction level.
    """
    import jax
    import jax.numpy as jnp

    from stringsearch_tpu.engines import doubling as D
    from stringsearch_tpu.harness.corpus import enwik_like

    n = 1 << log_n
    text = jnp.asarray(np.frombuffer(enwik_like(n), dtype=np.uint8))
    init = jax.jit(D._initial_full, static_argnames=("depth",))
    full = jax.jit(D._full_round, static_argnames=("fan",))

    out = {"n": n, "depth": depth, "fan": fan, "rounds": []}
    t0 = _timeit(lambda t: init(t, depth=depth), text, reps=reps)
    rank, _sa, _rs, count = init(text, depth=depth)
    out["t_initial"] = round(t0, 4)
    out["rounds"].append({"h": depth, "tied": int(count),
                          "frac": round(int(count) / n, 4)})
    h = depth
    while int(count) > n // 4096 and h < n:
        t = _timeit(lambda r: full(r, jnp.asarray(h, jnp.int32), fan=fan),
                    rank, reps=reps)
        rank, _sa, _rs, count = full(rank, jnp.asarray(h, jnp.int32),
                                     fan=fan)
        h = min(h * fan, n)
        out["rounds"].append({"h": h, "tied": int(count),
                              "frac": round(int(count) / n, 4),
                              "t_round": round(t, 4)})
    return out


def extract_variants(log_n: int, depth: int = 12, fan: int = 4,
                     reps: int = 3) -> dict:
    """Cost of tied-group extraction: full-width sort vs lax.top_k at
    several capacities, measured on the real post-full-round state."""
    import jax
    import jax.numpy as jnp

    from stringsearch_tpu.engines import doubling as D
    from stringsearch_tpu.harness.corpus import enwik_like

    n = 1 << log_n
    text = jnp.asarray(np.frombuffer(enwik_like(n), dtype=np.uint8))
    init = jax.jit(D._initial_full, static_argnames=("depth",))
    full = jax.jit(D._full_round, static_argnames=("fan",))
    rank, sa_s, rank_s, count = init(text, depth=depth)
    if int(count) > n // 4:
        rank, sa_s, rank_s, count = full(
            rank, jnp.asarray(depth, jnp.int32), fan=fan)
    out = {"n": n, "tied": int(count)}
    ex = jax.jit(D._extract, static_argnums=(2,), static_argnames=("method",))
    for div in (4, 16, 64):
        m = n // div
        if m < int(count):
            continue
        for method in ("sort", "topk"):
            t = _timeit(lambda rs, ss: ex(rs, ss, m, method=method),
                        rank_s, sa_s, reps=reps)
            out[f"{method}_m_n{div}"] = round(t, 4)
    return out


def bucketed_initial(log_n: int, reps: int = 3) -> dict:
    """The bucketed-initial experiment: can a leading-key grouping sort +
    batched per-bucket sorts beat one flat multi-key sort for the initial
    ranking? (The reference's analog: per-(c0,c1)-bucket substring sorts,
    ref crates/divsufsort/src/divsufsort.rs:163-200.)

    Three formulations measured on enwik-like packed key words:
      flat:        lax.sort((w0,w1,w2,j)) — the incumbent depth-12 initial;
      carry+rows:  lax.sort((w0,w1,w2,j), num_keys=1) then a batched
                   per-row 3-key sort of the [rows, n/rows] reshape — the
                   payload-carrying regroup; NOTE rows are position blocks
                   of the w0-sorted order, so w0-groups spanning row
                   boundaries still need a repair pass this probe does NOT
                   pay for (its number is a LOWER bound on the true cost);
      gather+rows: 2-op grouping sort then n-width gathers of w1/w2 into
                   the grouped order + the same batched row sort.
    """
    import jax
    import jax.numpy as jnp

    from stringsearch_tpu.engines import doubling as D
    from stringsearch_tpu.harness.corpus import enwik_like

    n = 1 << log_n
    text = jnp.asarray(np.frombuffer(enwik_like(n), dtype=np.uint8))
    w0, w1, w2 = D._pack4_keys(text, 12)
    j = jnp.arange(n, dtype=jnp.int32)
    rows = 4096
    cols = n // rows
    out = {"n": n, "rows": rows}

    def flat(w0, w1, w2, j):
        return jax.lax.sort((w0, w1, w2, j), num_keys=3)

    def carry_rows(w0, w1, w2, j):
        s0, s1, s2, sj = jax.lax.sort((w0, w1, w2, j), num_keys=1)
        rs = jax.lax.sort(
            tuple(x.reshape(rows, cols) for x in (s0, s1, s2, sj)),
            num_keys=3, dimension=1)
        return rs

    def gather_rows(w0, w1, w2, j):
        s0, sj = jax.lax.sort((w0, j), num_keys=1)
        g1 = jnp.take(w1, sj)
        g2 = jnp.take(w2, sj)
        rs = jax.lax.sort(
            tuple(x.reshape(rows, cols) for x in (s0, g1, g2, sj)),
            num_keys=3, dimension=1)
        return rs

    out["flat_3key"] = round(
        _timeit(jax.jit(flat), w0, w1, w2, j, reps=reps), 4)
    out["carry_rows"] = round(
        _timeit(jax.jit(carry_rows), w0, w1, w2, j, reps=reps), 4)
    out["gather_rows"] = round(
        _timeit(jax.jit(gather_rows), w0, w1, w2, j, reps=reps), 4)
    return out


def walk_probe(log_n: int, reps: int = 3) -> dict:
    """Blocked-cycle-walk feasibility probe for the inverse BWT.

    The shipped unbwt is pointer jumping: ceil(log2 n) rounds of one
    full-width [m, 2] row gather (transforms/bwt.py). The alternative is
    B lockstep walkers doing n/B-ish TINY (B-index) gathers inside ONE jitted
    fori_loop: phase 1 walks marker-to-marker to stitch orbit offsets,
    phase 2 re-walks emitting bytes with a B-index scatter per step.
    Whether that wins is decided ENTIRELY by the per-step cost of a
    B-index gather (+ scatter) inside a compiled loop — measured here.

    Reports per-step microseconds and the extrapolated two-phase unbwt
    estimate at max interval ~ (n/B)(ln B + 2) lockstep steps (random
    marker spacing on the cycle), next to the pointer-jumping cost.
    """
    import math
    from functools import partial

    import jax
    import jax.numpy as jnp

    n = 1 << log_n
    perm = jax.random.permutation(jax.random.PRNGKey(0), n).astype(
        jnp.int32)
    steps = 2048
    out = {"n": n, "steps_measured": steps}

    results = {}
    for b in (1024, 4096, 16384):
        start = jax.random.randint(jax.random.PRNGKey(b), (b,), 0, n,
                                   dtype=jnp.int32)

        @partial(jax.jit, static_argnames=())
        def walk_g(perm, start):
            def body(_, cur):
                return jnp.take(perm, cur)

            return jax.lax.fori_loop(0, steps, body, start)

        @partial(jax.jit, static_argnames=())
        def walk_gs(perm, start):
            acc = jnp.zeros((n,), jnp.int32)

            def body(t, st):
                cur, acc = st
                nxt = jnp.take(perm, cur)
                acc = acc.at[cur].set(t, mode="drop")
                return nxt, acc

            return jax.lax.fori_loop(0, steps, body, (start, acc))

        t_g = _timeit(walk_g, perm, start, reps=reps)
        t_gs = _timeit(walk_gs, perm, start, reps=reps)
        per_g = t_g / steps * 1e6
        per_gs = t_gs / steps * 1e6
        # two-phase estimate: lockstep to the expected MAX inter-marker
        # interval (n/b)(ln b + 2); phase 1 gather-only, phase 2
        # gather+scatter
        maxlen = (n / b) * (math.log(b) + 2)
        est = maxlen * (per_g + per_gs) / 1e6
        results[b] = {
            "us_per_step_gather": round(per_g, 2),
            "us_per_step_gather_scatter": round(per_gs, 2),
            "est_two_phase_s": round(est, 3),
        }
    out["walkers"] = results

    # the incumbent's cost at this size, for the same table
    from stringsearch_tpu.transforms.bwt import _unbwt_kernel

    u = jax.random.randint(jax.random.PRNGKey(9), (n,), 0, 256,
                           dtype=jnp.int32).astype(jnp.uint8)
    rounds = max(1, int(n).bit_length())
    out["t_pointer_jumping"] = round(_timeit(
        lambda a: _unbwt_kernel(a, jnp.int32(0), rounds), u,
        reps=reps), 4)
    return out


def config_sweep(log_n: int, reps: int = 2, configs=None) -> dict:
    """End-to-end fused build wall time across configurations.

    `fn`: "sa" = build_sa (the headline path, no ISA / lazy final
    invert), "isa" = build_with_isa (the r3-equivalent with ISA)."""
    import jax.numpy as jnp

    from stringsearch_tpu.engines.doubling import build_sa, build_with_isa
    from stringsearch_tpu.harness.corpus import enwik_like

    n = 1 << log_n
    text = jnp.asarray(np.frombuffer(enwik_like(n), dtype=np.uint8))
    if configs is None:
        configs = [
            dict(fn="isa", depth=12, fan=4),  # r3-equivalent reference
            dict(fn="sa", depth=12, fan=4),   # lazy-invert headline
            dict(fn="sa", depth=12, fan=2),
            dict(fn="sa", depth=16, fan=2),
            dict(fn="sa", depth=16, fan=4),
        ]
    out = {"n": n, "configs": []}
    for cfg in configs:
        cfg = dict(cfg)
        if cfg.pop("fn", "sa") == "sa":
            fn, run = build_sa, (lambda x: build_sa(x, **cfg))
        else:
            fn, run = build_with_isa, (lambda x: build_with_isa(x, **cfg)[0])
        try:
            t = _timeit(run, text, reps=reps)
        except Exception as e:  # OOM candidates (deep initials) recorded
            rec = {**{k: str(v) for k, v in cfg.items()},
                   "fn": fn.__name__, "error": repr(e)[:160]}
            out["configs"].append(rec)
            print(json.dumps(rec), flush=True)
            continue
        rec = {**{k: str(v) for k, v in cfg.items()}, "fn": fn.__name__,
               "wall_s": round(t, 4), "mb_per_s": round(n / t / 1e6, 2)}
        out["configs"].append(rec)
        print(json.dumps(rec), flush=True)
    return out


def main() -> None:
    p = argparse.ArgumentParser(prog="microbench")
    p.add_argument("mode", choices=["ops", "phases", "tiedcurve",
                                    "extract", "bucketed", "sweep",
                                    "walk"])
    p.add_argument("--n", type=int, default=24, help="log2 of element count")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--depth", type=int, default=None,
                   help="initial key bytes (default: each mode's own "
                        "default — 12, the headline config)")
    p.add_argument("--fan", type=int, default=2)
    p.add_argument("--configs", default=None,
                   help="JSON list of sweep configs, e.g. "
                        '[{"fn":"sa","depth":12,"fan":4}]')
    args = p.parse_args()
    from stringsearch_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    # None → each mode's own signature default (12 everywhere, the
    # headline config), so `microbench phases` profiles what ships
    dkw = {} if args.depth is None else {"depth": args.depth}
    if args.mode == "ops":
        res = op_costs(args.n, args.reps)
        for k, v in res.items():
            print(f"{k:28s} {v * 1e3:10.3f} ms")
        print(json.dumps({"log_n": args.n, **{k: round(v, 5) for k, v in res.items()}}))
    elif args.mode == "phases":
        res = phase_profile(args.n, args.reps, fan=max(args.fan, 2), **dkw)
        print(json.dumps(res))
    elif args.mode == "tiedcurve":
        print(json.dumps(tied_curve(args.n, fan=max(args.fan, 2),
                                    reps=args.reps, **dkw)))
    elif args.mode == "extract":
        print(json.dumps(extract_variants(args.n, fan=max(args.fan, 2),
                                          reps=args.reps, **dkw)))
    elif args.mode == "bucketed":
        print(json.dumps(bucketed_initial(args.n, args.reps)))
    elif args.mode == "walk":
        print(json.dumps(walk_probe(args.n, args.reps)))
    elif args.mode == "sweep":
        cfgs = None
        if args.configs:
            cfgs = [
                {k: (tuple(v) if isinstance(v, list) else v)
                 for k, v in c.items()}
                for c in json.loads(args.configs)
            ]
        print(json.dumps(config_sweep(args.n, args.reps, cfgs)))


if __name__ == "__main__":
    main()
