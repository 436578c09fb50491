"""Multi-process initialization — the mesh entry point across processes.

The reference is a single-node library (its only parallelism is a rayon
thread pool, ref: crates/sacapart/src/lib.rs:45-51); this framework
scales past one process by running the SAME shard_map programs
(parallel/mesh.py, parallel/global_sa.py) over a mesh whose devices span
processes. JAX handles the cross-process plumbing once
`jax.distributed.initialize` has run in every process, and
`jax.devices()` then shows the global device list.

Usage (one command per process; under a cluster manager JAX detects,
such as Slurm, Open MPI or Kubernetes, the variables may be left out):

    JAX_COORDINATOR_ADDRESS=host0:8476 JAX_NUM_PROCESSES=2 \
        JAX_PROCESS_ID=0 python your_build.py

    # your_build.py
    from stringsearch_tpu.parallel import multihost
    multihost.initialize()            # env-driven, else auto-detect
    mesh = multihost.device_mesh()    # ("parts",) over ALL devices
    g = build_global(text, mesh)      # exact global SA across processes

Simulated multi-process run — two local processes, each with N virtual
CPU devices, collectives over localhost gRPC:

    python -m stringsearch_tpu.parallel.multihost --selftest

This is also exercised by tests/test_multihost.py.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

_INITIALIZED = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Idempotent `jax.distributed.initialize` wrapper.

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). With neither a coordinator nor a
    process count this is `jax.distributed.initialize()`, which detects
    the clusters JAX knows (Slurm, Open MPI, Kubernetes); where it finds
    none this stays a single process.
    Returns True if distributed mode is active after the call.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        # let JAX detect a cluster (Slurm, Open MPI, Kubernetes); with
        # none detected it raises and this stays a single process
        try:
            jax.distributed.initialize()
            _INITIALIZED = True
        except Exception:
            return False
        return True

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _INITIALIZED = True
    return True


def device_mesh(batch_axis: int = 1):
    """A ("parts", "batch") mesh over ALL devices (across processes).

    The "parts" axis is trimmed to the largest power of two so the
    merge-split distributed sort (parallel/distsort.py) can run on it.
    """
    import jax

    from stringsearch_tpu.parallel.mesh import make_mesh

    devs = list(jax.devices())
    n = len(devs)
    while n & (n - 1):
        n -= 1
    return make_mesh(n, batch_axis=batch_axis, devices=devs[:n])


def gather_to_host(sharded):
    """Fetch a cross-process sharded array to every host (np.ndarray)."""
    import jax

    if getattr(sharded, "is_fully_addressable", True):
        import numpy as np

        return np.asarray(jax.device_get(sharded))
    from jax.experimental import multihost_utils

    return multihost_utils.process_allgather(sharded, tiled=True)


# ---------------------------------------------------------------------------
# simulated 2-process self-test (CPU backend, localhost coordinator)
# ---------------------------------------------------------------------------


def _selftest_child(coordinator: str, nproc: int, pid: int,
                    devs_per_proc: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devs_per_proc}"
    ).strip()
    import jax

    initialize(coordinator, nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    mesh = device_mesh()

    import numpy as np

    from stringsearch_tpu.parallel.global_sa import build_global

    rng = np.random.default_rng(7)
    text = rng.integers(0, 8, 4096).astype(np.uint8).tobytes()
    g = build_global(text, mesh)
    got = gather_to_host(g._sa_sharded)[g.pad :]
    if pid == 0:
        want = np.asarray(
            sorted(range(len(text)), key=lambda i: text[i:]), dtype=got.dtype
        )
        assert np.array_equal(got, want), "multihost global SA mismatch"
        print(f"multihost selftest OK: {nproc} processes x "
              f"{devs_per_proc} devices, n={len(text)}", flush=True)


def run_selftest(nproc: int = 2, devs_per_proc: int = 2,
                 timeout: float = 600.0) -> None:
    """Spawn `nproc` local processes and build a global SA across them."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo

    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "stringsearch_tpu.parallel.multihost",
             "--child", coordinator, str(nproc), str(pid),
             str(devs_per_proc)],
            env=env,
        )
        for pid in range(nproc)
    ]
    rcs = [p.wait(timeout=timeout) for p in procs]
    assert all(rc == 0 for rc in rcs), f"selftest children exited {rcs}"


if __name__ == "__main__":
    if "--child" in sys.argv:
        i = sys.argv.index("--child")
        _selftest_child(
            sys.argv[i + 1], int(sys.argv[i + 2]), int(sys.argv[i + 3]),
            int(sys.argv[i + 4])
        )
    else:
        nproc = 2
        if "--nproc" in sys.argv:
            nproc = int(sys.argv[sys.argv.index("--nproc") + 1])
        run_selftest(nproc=nproc)
        print("selftest passed")
