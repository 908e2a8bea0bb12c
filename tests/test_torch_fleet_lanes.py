"""The port's two-process fleet on the CPU: the launcher
``python -m repro_torch.launch.distributed --verify`` in the four lanes of
the reference's ``tests/test_multihost.py``, each process on the CPU.

``--verify`` makes the launcher re-run the spec in its own process
through the event-serial engines (``run_async``, ``run_sync``, or the
elastic engine replaying the membership transitions process 0 observed)
and exit nonzero unless the fleet's trajectory equals it: bit for bit for
the asynchronous lanes (``--x64``: tolerance 0), within 1e-12 for the
synchronous one. The processes share one ``TCPStore`` served by process
0; the heartbeat timeout is cut to 2 s so the fault lanes stay short.
"""
import json
import os
import subprocess
import sys

from repro_torch.obs import schema

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _launch(tmp_path, *extra):
    argv = [sys.executable, "-m", "repro_torch.launch.distributed",
            "--nprocs", "2", "--workers", "4", "--rounds", "5",
            "--n", "12", "--d", "8", "--timeout", "100", "--device", "cpu",
            "--hb-timeout", "2", "--logdir", str(tmp_path / "logs"),
            "--json", str(tmp_path / "results.json"), "--x64",
            "--verify", *extra]
    env = dict(os.environ,
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(argv, env=env, capture_output=True, text=True,
                       timeout=150)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "fleet ok" in r.stdout and "-> OK" in r.stdout, r.stdout
    return json.loads((tmp_path / "results.json").read_text())


def test_two_process_async_lane(tmp_path):
    results = _launch(tmp_path, "--algo", "centralvr_async",
                      "--speeds", "1,1,2,4")
    assert results["dropped"] is False and results["transitions"] == []
    assert len(results["rels"]) == 5 and results["device"] == "cpu"


def test_two_process_sync_lane(tmp_path):
    results = _launch(tmp_path, "--algo", "centralvr_sync")
    assert len(results["rels"]) == 5


def test_two_process_elastic_dropout_lane(tmp_path):
    """Process 1 exits at the round-2 boundary; the survivor repartitions,
    records schema-valid worker_lost/repartition events (with the time it
    waited for the heartbeat) and the dropped process its fault_exit, and
    the run after the drop equals the planned-membership replay."""
    obs_base = str(tmp_path / "obs")
    results = _launch(tmp_path, "--algo", "centralvr_async",
                      "--speeds", "1,1,2,4", "--elastic",
                      "--drop-process", "1", "--drop-round", "2",
                      "--drop-mode", "exit", "--obs", obs_base)
    assert [t["round"] for t in results["transitions"]] == [2]
    assert results["transitions"][0]["live"] == [0, 1]
    rows = schema.load_rows(obs_base + "-p0.jsonl")
    assert schema.validate_rows(rows) == len(rows)
    names = [row["name"] for row in rows if row["kind"] == "event"]
    assert names.count("worker_lost") == 2       # workers 2 and 3
    assert names.count("repartition") == 1
    lost = [row for row in rows if row["name"] == "worker_lost"]
    assert all(row["detect_s"] >= 2.0 for row in lost)
    beats = [row for row in rows if row["name"] == "elastic/heartbeat"]
    assert [row["round"] for row in beats] == list(range(5))
    rows1 = schema.load_rows(obs_base + "-p1.jsonl")
    exits = [row for row in rows1 if row["name"] == "fault_exit"]
    assert [(row["process"], row["round"]) for row in exits] == [(1, 2)]


def test_two_process_elastic_rejoin_lane(tmp_path):
    results = _launch(tmp_path, "--algo", "centralvr_async", "--rounds", "7",
                      "--speeds", "1,1,2,4", "--elastic",
                      "--drop-process", "1", "--drop-round", "2",
                      "--drop-mode", "stall", "--rejoin-after", "2")
    assert [t["round"] for t in results["transitions"]] == [2, 4]
    assert results["transitions"][1]["joined"] == [2, 3]
    assert len(results["rels"]) == 7


def test_launcher_refuses_to_drop_process_0(capsys):
    from repro_torch.launch import distributed as launchd
    assert launchd.main(["--elastic", "--drop-process", "0"]) == 2
    assert "process 0" in capsys.readouterr().err
