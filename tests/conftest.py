"""Test config: run everything on a virtual 8-device CPU mesh.

Tests pin JAX's default device to the host CPU backend and expose 8
virtual CPU devices so multi-device sharding paths execute for real.
Tests marked `gpu` take the card from the `gpu_device` fixture, which
skips when JAX has none; `python chip_smoke.py` runs them on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Tests must never touch the persistent XLA compilation cache: harness
# entry points invoked in-process (e.g. the fuzz runner) would otherwise
# flip the global cache config for the whole pytest process, and
# serializing big CPU/virtual-mesh executables into a cache dir that
# campaign processes are concurrently writing segfaulted reproducibly
# (jax compilation_cache.put_executable_and_time). The harness honors
# this opt-out (utils/compile_cache.py).
os.environ.setdefault("STRINGSEARCH_TPU_NO_COMPILE_CACHE", "1")

import jax  # noqa: E402

jax.config.update("jax_default_device", jax.devices("cpu")[0])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables at module boundaries.

    A full-suite run accumulates hundreds of XLA:CPU executables; with
    that state built up, compiling a further large program (nested
    while_loops under a lax.switch) segfaulted XLA reproducibly at the
    same test, while every module passes in isolation. Clearing between
    modules bounds the live-executable population (same class of issue
    as the fuzz runner's periodic clear_caches; see
    utils/compile_cache.py notes on the mmap budget)."""
    yield
    jax.clear_caches()


def naive_suffix_array(b: bytes) -> np.ndarray:
    """O(n^2 log n) oracle for small inputs."""
    return np.asarray(sorted(range(len(b)), key=lambda i: b[i:]), dtype=np.int32)


@pytest.fixture(scope="session")
def cpu_devices():
    return jax.devices("cpu")


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU; skips the test when JAX has none. Decided here, at
    run time, never while a test module is imported."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:  # no GPU backend in this process
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run `python chip_smoke.py` on one)")
    return devs[0]


@pytest.fixture(params=["cpu", pytest.param("gpu", marks=pytest.mark.gpu)])
def device(request):
    """Each test that takes it runs once on the CPU and once, marked
    `gpu`, on the GPU."""
    if request.param == "gpu":
        return request.getfixturevalue("gpu_device")
    return jax.devices("cpu")[0]


@pytest.fixture(scope="session")
def corpus():
    from stringsearch_tpu.harness.corpus import regression_corpus

    return regression_corpus()
