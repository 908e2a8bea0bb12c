"""The trace's reduction and the result line's keys, on made-up data."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench import run
from bench.harness import cells, trace


def _trace(extra=()):
    dev = [("k1<float>", 10.0, 20.0), ("k2", 15.0, 30.0),
           ("k1<float>", 50.0, 60.0), ("before", -20.0, -10.0), *extra]
    host = [("cudaDeviceSynchronize", -20.0, -19.0),
            ("cudaStreamSynchronize", 60.0, 99.0),
            ("cudaMemcpyAsync", 31.0, 49.0), ("late", 101.0, 120.0)]
    return trace.Trace(dev, host)


def test_busy_kernels_and_gaps():
    t = _trace()
    assert t.window_s == pytest.approx(140e-6)       # -20 .. 120
    assert t.busy_s == pytest.approx(40e-6)
    assert t.device_ops == 4
    assert t.kernel(("k1",)) == (pytest.approx(20e-6), 2)
    assert t.gaps() == [(-10.0, 10.0), (30.0, 50.0), (60.0, 120.0)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1<float>", pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize",
                                 pytest.approx(60e-6)]
    assert b["idle_gaps"][1] == [trace.BETWEEN_CALLS, pytest.approx(20e-6)]
    assert b["idle_gaps"][2] == ["cudaMemcpyAsync", pytest.approx(20e-6)]


def test_nothing_recorded():
    t = trace.Trace([], [], 2.5)
    assert t.window_s == 2.5 and t.busy_s == 0 and t.device_ops == 0


@dataclasses.dataclass
class _Out:
    correct: bool = True
    attempted: int = 7
    failed: int = 0
    e2e: dict = None
    checks: dict = None
    memory_peak_bytes: int = 123
    trace: object = None
    run: dict = None


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    cell = cells.cell("dist-toy-logistic.sync-p8")
    out = _Out(e2e={"convex_solve_ms_p95": 1.0,
                    "convex_samples_per_s": 2.0, "peak_mem_gib": 3.0,
                    "setup_s": 4.0},
               checks={"x_gap": (1e-14, 1e-10), "rel_gap": (2e-14, 1e-10)},
               trace=_trace([("vr_epoch_kernel<0>", 70.0, 80.0)]),
               run={"kind": "convex_sync", "workers": 2, "rows": 3,
                    "features": 4, "rounds": 1, "units_traced": 1,
                    "units_timed": 2, "seconds_timed": 1.0})
    line = run.result_line(cell, out, traced, {"platform": "gpu",
                                               "kind": "x", "count": 1})
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + [
        "checks"]
    json.dumps(line)
    want = {m["name"] for m in (cell.per_layer if traced
                                else cell.end_to_end)}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if traced:
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert line["checks"]["x_gap"] == {"value": 1e-14, "limit": 1e-10}


def test_no_result_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "dist-toy-logistic.sync-p8", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_no_result_without_the_program(tmp_path):
    """A directory with BENCHMARK.json and bench/ alone gives no result."""
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "dist-toy-logistic.sync-p8", "--seed", "1",
                        "--seconds", "1"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
