"""Harness device handling: no CPU fallback, and where the compile
cache lives."""

import os
import subprocess
import sys

import jax
import pytest

from stringsearch_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _has_gpu() -> bool:
    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:
        return False


def test_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.delenv("STRINGSEARCH_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_default_is_fixed_ignored_repo_path(monkeypatch):
    monkeypatch.delenv("STRINGSEARCH_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_opt_out(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("STRINGSEARCH_TPU_NO_COMPILE_CACHE", "1")
    assert compile_cache.cache_dir() is None
    assert compile_cache.enable_persistent_cache() is None


def test_cache_stays_off_on_cpu(monkeypatch):
    monkeypatch.delenv("STRINGSEARCH_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_persistent_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("module", ["cli", "fuzz", "scaling"])
def test_device_gpu_without_card_exits_nonzero(module, tmp_path, capsys):
    if _has_gpu():
        pytest.skip("a GPU is present")
    import importlib

    main = importlib.import_module(f"stringsearch_tpu.harness.{module}").main
    if module == "cli":
        p = tmp_path / "in.bin"
        p.write_bytes(b"abracadabra")
        argv = ["run", str(p), "--device", "gpu"]
    elif module == "fuzz":
        argv = ["--iters", "1", "--device", "gpu", "--out", str(tmp_path)]
    else:
        argv = ["1k", "--device", "gpu"]
    assert main(argv) != 0
    assert "no gpu device" in capsys.readouterr().err


def test_bench_without_card_exits_nonzero():
    if _has_gpu():
        pytest.skip("a GPU is present")
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_SIZE="4096")
    r = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "needs a GPU" in r.stderr
