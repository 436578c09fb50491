"""Reduction of a profiler trace and an optimized HLO module to metrics.

Used by `chip_smoke.py`; kept with the harness so that every run reduces
a trace the same way:

  * `sort_lowerings` lists every sort of an optimized HLO module and how
    XLA lowered it: a CUB radix-sort custom call, or XLA's own sort
    kernel;
  * `device_ops` reads the GPU operations of a `jax.profiler` trace:
    one list per device of (name, hlo_op, start_ns, duration_ns); a
    trace without a GPU plane is refused, never read from host events;
  * `summarize` gives each sort's device time and the device's idle
    share over the traced window: busy is the union of the device's
    operation intervals, idle share is 1 - busy / window;
  * `summarize_collectives` gives, per device, the time of each
    collective kind and the part of it during which no other operation
    ran on that device.

The window is the host span of a `jax.profiler.TraceAnnotation` named
`WINDOW` around the traced call; a trace without it is refused.
"""

from __future__ import annotations

import glob
import os
import re

WINDOW = "stringsearch.window"

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*?)\s+"
                    r"(sort|custom-call)\(")
_TARGET = re.compile(r'custom_call_target="([^"]+)"')
_OP_NAME = re.compile(r'op_name="([^"]+)"')
# collective kinds as they appear in HLO names and NCCL kernel names,
# compared with "-" and "_" removed; "nccl" catches kernels of other kinds
_COLLECTIVES = ("alltoall", "allgather", "allreduce", "collectivepermute",
                "reducescatter", "sendrecv", "nccl")


def sort_lowerings(hlo_text: str) -> list[dict]:
    """One dict per sort in an optimized HLO module: its instruction
    name, `lowering` ("cub" for a CUB radix-sort custom call, "xla_sort"
    for XLA's sort kernel), result type, and `site`: the op_name path
    without the jit prefix, which carries the engine's named scope
    (e.g. "while/body/round_sort/sort")."""
    out = []
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        name, result, op = m.groups()
        if op == "custom-call":
            t = _TARGET.search(line)
            target = t.group(1) if t else ""
            if "sort" not in target.lower():
                continue
            lowering = "cub" if "cub" in target.lower() else target
        else:
            lowering = "xla_sort"
        op_name = _OP_NAME.search(line)
        site = op_name.group(1).split("/", 1)[-1] if op_name else "?"
        out.append({"hlo_op": name, "lowering": lowering,
                    "result": result[:200], "site": site})
    return out


def latest_xplane(trace_dir: str) -> str:
    """Path of the newest `.xplane.pb` under a `jax.profiler.trace` dir."""
    found = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not found:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(found, key=os.path.getmtime)


def _stats(ev) -> dict:
    return {k: v for k, v in ev.stats}


def device_ops(xplane_path: str):
    """({device: [(name, hlo_op, start_ns, dur_ns)]}, window).

    Devices are the `/device:GPU:N` planes; their stream lines hold the
    kernels and copies. Kernels that run inside a CUDA graph carry
    hlo_op "command_buffer"; their names are the HLO instruction's name
    with "." replaced by "_", plus "__<k>" for its k-th extra kernel.
    Raises ValueError when the trace has no GPU plane (no card, or the
    profiler did not attach to it) or no `WINDOW` annotation.
    """
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    ops: dict[str, list] = {}
    window = None
    for plane in pd.planes:
        is_gpu = plane.name.startswith("/device:GPU:")
        for line in plane.lines:
            for ev in line.events:
                if ev.name == WINDOW:
                    window = (ev.start_ns, ev.start_ns + ev.duration_ns)
                elif is_gpu:
                    st = _stats(ev)
                    ops.setdefault(plane.name, []).append(
                        (ev.name, str(st.get("hlo_op", "")), ev.start_ns,
                         ev.duration_ns))
    if not ops:
        raise ValueError(f"{xplane_path} holds no GPU device operations")
    if window is None:
        raise ValueError(f"{xplane_path} has no {WINDOW!r} annotation")
    return ops, window


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _clip(intervals, window):
    lo, hi = window
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def _minus(a, b) -> float:
    """Length of the union `a` not covered by the union `b`."""
    total, j = 0.0, 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                total += b[k][0] - cur
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            total += e - cur
    return total


def idle_share(events, window) -> float:
    """1 - (union of the events' intervals inside the window) / window."""
    busy = _union(_clip([(s, s + d) for _n, _o, s, d in events], window))
    return 1.0 - _length(busy) / (window[1] - window[0])


def summarize(xplane_path: str, sorts: list[dict]) -> dict:
    """Per-sort device time and lowering, total device time, idle share
    (first device, over the traced window)."""
    return summarize_ops(*device_ops(xplane_path), sorts)


def summarize_ops(ops: dict, window, sorts: list[dict]) -> dict:
    """`summarize` on the output of `device_ops`."""
    device = sorted(ops)[0]
    events = ops[device]
    by_kernel: dict[str, float] = {}
    for name, hlo_op, _s, dur in events:
        # a kernel inside a CUDA graph is known only by its own name
        key = hlo_op if hlo_op != "command_buffer" else name.split("__")[0]
        by_kernel[key] = by_kernel.get(key, 0.0) + dur
    rows = [dict(s, device_s=(by_kernel.get(s["hlo_op"], 0.0)
                              + by_kernel.get(s["hlo_op"].replace(".", "_"),
                                              0.0)) / 1e9)
            for s in sorts]
    idle = idle_share(events, window)
    return {
        "device": device,
        "window_s": (window[1] - window[0]) / 1e9,
        "device_busy_s": (1.0 - idle) * (window[1] - window[0]) / 1e9,
        "idle_share": idle,
        "sorts": rows,
        "sort_device_s": sum(r["device_s"] for r in rows),
    }


def _collective_kind(name: str, hlo_op: str) -> str | None:
    text = f"{hlo_op} {name}".lower().replace("-", "").replace("_", "")
    for kind in _COLLECTIVES:
        if kind in text:
            return kind
    return None


def summarize_collectives(xplane_path: str) -> dict:
    """Per device: seconds in each collective kind, and the part of the
    collective time with no other operation running on that device."""
    return summarize_collectives_ops(*device_ops(xplane_path))


def summarize_collectives_ops(ops: dict, window) -> dict:
    """`summarize_collectives` on the output of `device_ops`."""
    out = {}
    for device, events in sorted(ops.items()):
        events = [e for e in events
                  if e[2] < window[1] and e[2] + e[3] > window[0]]
        kinds: dict[str, float] = {}
        coll, other = [], []
        for name, hlo_op, s, d in events:
            kind = _collective_kind(name, hlo_op)
            if kind is None:
                other.append((s, s + d))
            else:
                kinds[kind] = kinds.get(kind, 0.0) + d / 1e9
                coll.append((s, s + d))
        coll_u, other_u = _union(coll), _union(other)
        out[device] = {
            "collective_s": kinds,
            "collective_union_s": _length(coll_u) / 1e9,
            "collective_exposed_s": _minus(coll_u, other_u) / 1e9,
            "busy_s": _length(_union(coll + other)) / 1e9,
        }
    return {"devices": out, "window_s": (window[1] - window[0]) / 1e9}
