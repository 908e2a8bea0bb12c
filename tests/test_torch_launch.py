"""The port's command lines against the reference's:
``repro_torch.launch.solve`` (``build_spec`` and ``resolve_prox`` on a
grid of flags for every algorithm, in sweep and single-algorithm mode;
``--list``; a CPU sweep with ``--json``, ``--obs`` and ``--profile``
whose rows equal direct solves; the spmd backend over gloo ranks),
``repro_torch.launch.obs`` (the reference CLI's exit codes on the same
files) and ``repro_torch.launch.train``'s ``--obs`` and ``--profile``.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

import repro_torch
from repro.launch import obs as jobs_cli
from repro.launch import solve as jsolve_cli
from repro_torch.config import ConvexConfig
from repro_torch.launch import obs as obs_cli
from repro_torch.launch import solve as solve_cli
from repro_torch.obs import schema

torch.set_num_threads(1)

ALGOS = tuple(repro_torch.REGISTRY)
# one value a flag left at its default, one or two set
FLAG_GRID = {
    "--backend": ("vmap", "spmd"),
    "--tau": (None, "5"),
    "--fetch": (None, "stale"),
    "--speeds": (None, "1,2"),
    "--prox": (None, "l1:0.01", "group_l2:0.1:2"),
    "--lam2": (None, "0.5"),
    "--snapshot": (None, "avg"),
}


def _outcome(module, argv, name):
    """(asdict of the spec, note) that ``module.build_spec`` makes of
    ``argv``, or the refusal's (type name, message)."""
    args = module.parse_args(argv)
    try:
        spec, note = module.build_spec(args, name, 2, 3)
    except (ValueError, NotImplementedError, SystemExit) as e:
        return type(e).__name__, str(e)
    return dataclasses.asdict(spec), note


@pytest.mark.parametrize("sweep", [False, True], ids=["single", "sweep"])
@pytest.mark.parametrize("algo", ALGOS)
def test_build_spec_equals_the_reference(algo, sweep):
    """For every flag combination of ``FLAG_GRID`` the port's spec is the
    reference's field for field, with the same sweep note, or both
    refuse with the same error."""
    specs = refusals = 0
    for values in itertools.product(*FLAG_GRID.values()):
        argv = ["--sweep"] if sweep else ["--algo", algo]
        for flag, v in zip(FLAG_GRID, values):
            if v is not None:
                argv += [flag, v]
        have = _outcome(solve_cli, argv, algo)
        want = _outcome(jsolve_cli, argv, algo)
        assert have == want, argv
        if isinstance(have[0], dict):
            specs += 1
        else:
            refusals += 1
    assert specs and (refusals or sweep)


def test_list_matches_the_reference(capsys):
    assert solve_cli.main(["--list"]) == 0
    have = capsys.readouterr().out.splitlines()
    assert jsolve_cli.main(["--list"]) == 0
    want = capsys.readouterr().out.splitlines()

    def names_and_flags(lines):
        return [(ln.split()[0], ln[ln.index("["):ln.index("]") + 1])
                for ln in lines]

    assert names_and_flags(have) == names_and_flags(want)
    assert [ln.split()[0] for ln in have] == list(ALGOS)


def test_cli_refusals_match_the_reference(capsys):
    assert solve_cli.main([]) == jsolve_cli.main([]) == 2
    for argv, err in ((["--algo", "sgd", "--lam2", "0.5"], SystemExit),
                      (["--algo", "sgd", "--prox", "box:0:1",
                        "--lam2", "0.5"], SystemExit)):
        with pytest.raises(err) as have:
            solve_cli.main(argv + ["--device", "cpu"])
        with pytest.raises(err) as want:
            jsolve_cli.main(argv)
        assert str(have.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="no SPMD program"):
        solve_cli.main(["--algo", "sgd", "--backend", "spmd", "--device",
                        "cpu"])


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_cli.main(["--algo", "centralvr", "--quick"])


def test_cpu_sweep_rows_equal_direct_solves(tmp_path, capsys):
    """``--sweep --quick --device cpu`` with ``--json``, ``--obs`` and
    ``--profile``: exit 0; each of its 11 provenance rows equals a direct
    ``solve`` of the same spec (its wall aside); the record validates
    under both packages' validators and CLIs; the trace parses."""
    out, rec, prof = (str(tmp_path / "sweep.json"),
                      str(tmp_path / "sweep.jsonl"), tmp_path / "prof")
    assert solve_cli.main(["--sweep", "--quick", "--device", "cpu",
                           "--json", out, "--obs", rec,
                           "--profile", str(prof)]) == 0
    printed = capsys.readouterr().out
    assert "wrote 11 provenance rows" in printed
    with open(out) as f:
        rows = json.load(f)
    assert [r["spec"]["algo"] for r in rows] == list(ALGOS)
    cfg = ConvexConfig(problem="logistic", n=64, d=8, seed=0)
    for row in rows:
        spec = repro_torch.RunSpec(**{**row["spec"], "eta": None})
        direct = repro_torch.solve(spec, cfg, device="cpu").provenance()
        assert {k: v for k, v in row.items() if k != "wall_s"} == {
            k: v for k, v in json.loads(json.dumps(direct)).items()
            if k != "wall_s"}
    assert obs_cli.main(["validate", rec]) == 0
    assert jobs_cli.main(["validate", rec]) == 0
    records = schema.load_rows(rec)
    execute = [r["name"] for r in records if r["kind"] == "span"
               and r["name"].endswith("/execute")]
    assert execute == [f"solve/{a}/execute" for a in ALGOS]
    assert sum(r["name"] == "provenance" for r in records) == 11
    traces = list(prof.glob("trace-rank0-*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_spmd_cli_runs_on_gloo_ranks_and_rank0_records(tmp_path, capsys):
    """``--backend spmd --workers 2`` over two gloo ranks on the CPU: rank
    0 writes the one row and the record (an ``spmd/<algo>/execute`` span
    and the ``comms_measured`` event of its collectives); the result
    agrees with the vmap run of the same flags."""
    out, rec = str(tmp_path / "spmd.json"), str(tmp_path / "spmd.jsonl")
    argv = ["--algo", "centralvr_sync", "--quick", "--device", "cpu"]
    assert solve_cli.main(argv + ["--backend", "spmd", "--workers", "2",
                                  "--json", out, "--obs", rec]) == 0
    vmap = str(tmp_path / "vmap.json")
    assert solve_cli.main(argv + ["--json", vmap]) == 0
    with open(out) as f:
        rows = json.load(f)
    with open(vmap) as f:
        want = json.load(f)
    assert len(rows) == 1 and rows[0]["spec"]["backend"] == "spmd"
    np.testing.assert_allclose(rows[0]["rels_tail"], want[0]["rels_tail"],
                               rtol=1e-9)
    records = schema.load_rows(rec)
    assert [r["name"] for r in records if r["kind"] == "span"
            and not r["name"].startswith("sync/")] == [
        "solve/build", "spmd/centralvr_sync/execute", "solve/out", "solve"]
    comms = [r for r in records if r["name"] == "comms_measured"]
    assert len(comms) == 1 and comms[0]["collectives"] > 0
    assert comms[0]["carried_bytes"] == rows[0]["comms"]["carried_bytes"]


def test_obs_cli_exit_codes_match_the_reference(tmp_path, capsys):
    from repro_torch import obs

    path = str(tmp_path / "run.jsonl")
    with obs.recording(path) as rec:
        rec.metric("rel", step=0, value=1.0)
        with rec.span("kernels/build", built=[], cached=1):
            pass
    summary = str(tmp_path / "summary.json")
    assert obs_cli.main(["report", path, "--json", summary]) == 0
    with open(summary) as f:
        assert json.load(f)["n_rows"] == 3
    assert "phase split: build" in capsys.readouterr().out
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 1, "kind": "event"}\n')
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    for argv in (["validate", path], ["validate", path, str(bad)],
                 ["validate", str(empty)],
                 ["validate", str(tmp_path / "missing.jsonl")],
                 ["report", path]):
        assert obs_cli.main(argv) == jobs_cli.main(argv), argv
    for module in (obs_cli, jobs_cli):
        with pytest.raises(ValueError, match="missing base fields"):
            module.main(["report", str(bad)])


def test_train_launcher_records_and_profiles(tmp_path, capsys,
                                            monkeypatch):
    from repro_torch.kernels import build
    from repro_torch.launch import train

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)

    rec, prof = str(tmp_path / "train.jsonl"), tmp_path / "prof"
    train.main(["--arch", "mamba2-130m", "--reduced", "--steps", "4",
                "--vr-table-size", "2", "--num-workers", "2",
                "--seq-len", "16", "--global-batch", "4", "--microbatch",
                "1", "--optimizer", "sgd", "--lr", "0.1", "--device", "cpu",
                "--obs", rec, "--profile", str(prof),
                "--compile-cache", str(tmp_path / "cc")])
    out = capsys.readouterr().out
    assert "wrote telemetry to" in out and "done: 4 steps" in out
    assert obs_cli.main(["validate", rec]) == 0
    names = [r["name"] for r in schema.load_rows(rec)]
    for want in ("train/epoch/execute", "train/epoch", "train_epoch",
                 "train/eval", "train_done"):
        assert want in names
    assert len(list(prof.glob("trace-rank0-*.json"))) == 1
