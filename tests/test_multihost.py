"""Simulated multi-process (multi-"host") global SA build.

Spawns 2 local processes, each exposing 2 virtual CPU devices, wires them
with `jax.distributed.initialize` over a localhost coordinator, and
builds the exact global suffix array over the resulting 4-device
cross-process mesh — the same code path a job spanning several hosts runs
(ref ancestor: the reference has no multi-host story at all; its
parallelism ends at rayon threads, crates/sacapart/src/lib.rs:45-51).
"""

import pytest

from stringsearch_tpu.parallel.multihost import run_selftest


@pytest.mark.slow
def test_two_process_global_build():
    run_selftest(nproc=2, devs_per_proc=2, timeout=600.0)
