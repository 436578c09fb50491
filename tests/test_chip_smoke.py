"""chip_smoke.py's phases at tiny sizes on the CPU, phase h on four
virtual CPU devices; the trace reduction on synthetic intervals.

The script itself refuses to run without a GPU; these tests call its
phase functions directly so that their control flow and checks are
exercised where there is no card.
"""

import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import Future

import jax
import numpy as np
import pytest

import chip_smoke as cs
from stringsearch_tpu import oracle
from stringsearch_tpu.harness import profile
from stringsearch_tpu.harness.corpus import enwik_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _done(value) -> Future:
    f = Future()
    f.set_result(value)
    return f


def _records(capsys) -> dict:
    out = capsys.readouterr().out
    return {r["phase"]: r for r in
            (json.loads(x) for x in out.splitlines() if x.startswith("{"))}


@pytest.fixture(scope="module")
def text():
    return np.frombuffer(enwik_like(1 << 12, seed=cs.SEED), np.uint8)


@pytest.fixture()
def report():
    return cs.Report(jax.devices("cpu")[:1], "test card, 0 W")


@pytest.fixture(scope="module")
def built(text):
    import stringsearch_tpu as st

    return st.build_suffix_array(text)


def test_device_check_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cs.phase_device_check()


def test_script_fails_without_gpu_and_alone(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    # a directory that holds the script and nothing else of the repo
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_phase_build(report, text, capsys):
    idx = cs.phase_build(report, text, _done(oracle.build(text)))
    assert np.array_equal(np.asarray(idx.sa), oracle.build(text))
    recs = _records(capsys)
    assert {"b.build_suffix_array", "b.verify", "b.build_with_isa",
            "b.oracle_byte_exact"} <= set(recs)
    assert recs["b.build_suffix_array"]["run_s"] > 0


def test_phase_build_rejects_wrong_oracle(report, text):
    wrong = oracle.build(text).copy()
    wrong[[0, 1]] = wrong[[1, 0]]
    with pytest.raises(AssertionError, match="oracle"):
        cs.phase_build(report, text, _done(wrong))


def test_phase_trace(report, built, tmp_path, capsys):
    compiled, sorts, compile_s = cs.build_sorts(built.text, str(tmp_path))
    assert compile_s > 0
    assert np.array_equal(np.asarray(compiled(built.text)),
                          np.asarray(built.sa))
    assert sorts, "no sort found in the build's HLO"
    assert all(s["lowering"] == "xla_sort" for s in sorts)
    assert any("initial_sort" in s["site"] for s in sorts)
    # a CPU trace has no GPU plane: the phase refuses it, reads no host events
    with pytest.raises(ValueError, match="no GPU device operations"):
        cs.phase_trace(report, built, str(tmp_path))
    assert "c.trace_build" not in _records(capsys)


def test_phase_queries(report, built, text, capsys):
    cs.phase_queries(report, built, text, _done(oracle.build(text)))
    assert {"d.lcs_batch", "d.sa_search_batch"} <= set(_records(capsys))


def test_query_checks_catch_wrong_answers(text):
    import stringsearch_tpu as st
    from stringsearch_tpu.core.types import LongestCommonSubstring

    sa = oracle.build(text)
    idx = st.build_suffix_array(text)
    needles = cs.make_needles(text, 16, 1)
    matches = idx.longest_substring_match_batch(needles)
    cs.check_lcs(text, sa, needles, matches)
    short = [LongestCommonSubstring(m.text, m.start, max(m.len - 1, 0))
             for m in matches]
    with pytest.raises(AssertionError, match="LCS"):
        cs.check_lcs(text, sa, needles, short)
    from stringsearch_tpu.core.search import sa_search_batch

    results = sa_search_batch(idx, needles)
    cs.check_search(text, sa, needles, results)
    with pytest.raises(AssertionError, match="search"):
        cs.check_search(text, sa, needles, [(c + 1, l) for c, l in results])


def test_phase_bwt(report, text, capsys):
    t = text[:1 << 10]
    cs.phase_bwt(report, t, _done(oracle.bwt(t)))
    assert {"e.bwt", "e.unbwt"} <= set(_records(capsys))


def test_phase_partitioned(report, text, capsys):
    # partitions cut through the text: crossing occurrences must not count
    cs.phase_partitioned(report, text, _done(oracle.build(text)))
    assert "f.partitioned_sa_search_batch" in _records(capsys)


def test_phase_engines(report, text, capsys):
    t = text[:1 << 10]
    cs.phase_engines(report, t, _done(oracle.build(t)))
    assert {"g.dc3", "g.bstar"} <= set(_records(capsys))


def test_phase_four_on_virtual_devices(text, tmp_path, capsys):
    devs = jax.devices("cpu")[:cs.FOUR]
    if len(devs) < cs.FOUR:
        pytest.skip("needs 4 virtual CPU devices")
    report = cs.Report(devs, "test card, 0 W")
    prefix_n = 1 << 11
    mesh = cs.phase_four(report, devs, text, _done(oracle.build(text)),
                         _done(oracle.build(text[:prefix_n])), prefix_n)
    recs = _records(capsys)
    assert len(recs["h.build_global"]["placement"]) == cs.FOUR
    assert "h.sharded_lcs_batch" in recs
    assert "h.global_oracle_byte_exact" in recs
    with pytest.raises(ValueError, match="no GPU device operations"):
        cs.phase_four_trace(report, mesh, text, str(tmp_path))


def test_summarize_ops_attributes_sort_kernels():
    # XLA's sort kernel inside a CUDA graph is named after its instruction;
    # CUB's custom call keeps its hlo_op
    ops = {"/device:GPU:0": [
        ("sort_61_1", "command_buffer", 0, 30),
        ("sort_61_1__7", "command_buffer", 40, 20),
        ("DeviceRadixSortOnesweepKernel", "custom-call.6", 70, 10),
        ("fusion_3", "fusion.3", 85, 5),
    ]}
    sorts = [{"hlo_op": "sort.61.1", "lowering": "xla_sort", "site": "s"},
             {"hlo_op": "custom-call.6", "lowering": "cub", "site": "i"}]
    out = profile.summarize_ops(ops, (0, 100), sorts)
    assert [r["device_s"] for r in out["sorts"]] == [50e-9, 10e-9]
    assert out["sort_device_s"] == pytest.approx(60e-9)
    assert out["idle_share"] == pytest.approx(1 - 65 / 100)
    assert out["device"] == "/device:GPU:0"


def test_summarize_collectives_ops_clips_to_window():
    ops = {"/device:GPU:1": [
        ("ncclDevKernel_AllGather_RING", "all-gather.1", 10, 10),
        ("fusion_2", "fusion.2", 15, 10),
        ("ncclDevKernel_SendRecv", "collective-permute.4", 200, 5),
    ]}
    out = profile.summarize_collectives_ops(ops, (0, 100))
    dev = out["devices"]["/device:GPU:1"]
    assert dev["collective_s"] == {"allgather": 10e-9}
    assert dev["collective_exposed_s"] == pytest.approx(5e-9)
    assert dev["busy_s"] == pytest.approx(15e-9)
    assert out["window_s"] == pytest.approx(100e-9)


def test_interval_arithmetic():
    events = [("k", "a", 0, 10), ("k", "b", 5, 10), ("k", "c", 30, 10)]
    assert profile.idle_share(events, (0, 50)) == pytest.approx(1 - 25 / 50)
    u = profile._union([(0, 10), (5, 15), (30, 40)])
    assert u == [(0, 15), (30, 40)]
    # collective [0,15)+[30,40) minus compute [10,32): exposed 10 + 8
    assert profile._minus(u, [(10, 32)]) == 18
    assert profile._collective_kind("ncclDevKernel_AllGather_RING", "") \
        == "allgather"
    assert profile._collective_kind("fusion", "all-to-all.3") == "alltoall"
    assert profile._collective_kind("sort_61_1__2", "command_buffer") is None


def test_sort_lowerings_parses_cub_and_xla_sorts():
    hlo = "\n".join([
        '  %custom-call.3 = (s32[64]{0}, s32[64]{0}, u8[99]{0}) '
        'custom-call(s32[64]{0} %a, s32[64]{0} %b), '
        'custom_call_target="__cub$DeviceRadixSort", metadata={op_name='
        '"jit(f)/sort" source_file="/x/doubling.py" source_line=111}',
        '  %sort.1 = (u32[64]{0}, s32[64]{0}) sort(u32[64]{0} %c, '
        's32[64]{0} %d), dimensions={0}, is_stable=true, to_apply=%cmp',
        '  %add.2 = s32[64]{0} add(s32[64]{0} %a, s32[64]{0} %b)',
    ])
    rows = profile.sort_lowerings(hlo)
    assert [(r["hlo_op"], r["lowering"]) for r in rows] == [
        ("custom-call.3", "cub"), ("sort.1", "xla_sort")]
    assert rows[0]["site"] == "sort"
