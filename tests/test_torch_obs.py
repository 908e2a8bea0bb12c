"""The port's run telemetry (``repro_torch.obs``) against the reference's
(``repro.obs``), case by case with ``tests/test_obs.py``:

  * recorder/schema — JSONL rows round-trip through the v1 schema, the
    stream cadence holds, malformed rows are refused, telemetry is off by
    default, and a record of either package validates under the other's
    validator;
  * recording changes nothing — a recorded run of every algorithm is
    bit-identical to an unrecorded one (x, rels, launches), its streamed
    metric rows are its rels, and an unrecorded run opens no metric
    stream and makes no CUDA event;
  * the analytical records — ``staleness_stats`` and the async runs'
    ``RunResult.staleness`` equal the reference's exactly; the golden
    provenance row; ``RunResult.final_rel``;
  * the LM loop's rows, the ``kernels/build`` span, and ``report``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.config import ConvexConfig as JConvexConfig
from repro.core import distributed as jdistributed
from repro.core import runtime as jruntime
from repro.obs import schema as jschema
from repro.obs import staleness as jstaleness
from repro_torch import convert, obs
from repro_torch.config import TrainConfig, get_arch
from repro_torch.core import runtime
from repro_torch.obs import report, schema, staleness, stream

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONVEX_TOL = 1e-10
KEY = jax.random.PRNGKey(3)
P, ROUNDS = 2, 3
SPEEDS = (2.0, 1.0)
ALGOS = tuple(repro_torch.REGISTRY)
STREAMED = ("centralvr", "centralvr_sync", "centralvr_async", "dsvrg",
            "dsaga")


# the spans a recorded solve's driver opens besides its execute span (the
# rows in the order the spans end); every driver's solve also has the
# root span ``solve``, ``solve/build`` and ``solve/out``
DRIVER_SPANS = {"centralvr_sync": [
    "solve/orders", "solve/init", "solve/rel0",
    *["solve/epoch", "solve/average", "solve/rel", "solve/round"] * ROUNDS]}


def _phases(rows):
    """The names of a record's span rows, less the host reads'."""
    return [r["name"] for r in rows if r["kind"] == "span"
            and not r["name"].startswith("sync/")]


def _sharded(p=P, n=24, d=6):
    cfg = JConvexConfig(problem="logistic", n=n, d=d, workers=p)
    return jdistributed.make_distributed(jax.random.PRNGKey(0), cfg)


def _problem(algo):
    """(reference problem, port problem) for ``algo``'s topology."""
    sp = _sharded()
    if not repro_torch.REGISTRY[algo].caps.distributed:
        sp = sp.merged()
    return sp, convert.to_problem(sp, device="cpu")


def _spec(algo, **kw):
    caps = repro_torch.REGISTRY[algo].caps
    if caps.distributed:
        kw.setdefault("p", P)
    if caps.accepts_speeds and "speeds" not in kw:
        kw["speeds"] = SPEEDS
    return dict(algo=algo, eta=0.05, rounds=ROUNDS, **kw)


# ---------------------------------------------------------------------------
# Recorder + schema
# ---------------------------------------------------------------------------

def test_recorder_rows_validate_and_roundtrip(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path, run_id="fixed-id") as rec:
        rec.event("custom", payload={"k": 1})
        rec.metric("loss", step=3, value=0.25)
        with rec.span("phase/a", tag="x"):
            pass
    n = schema.validate_file(path)
    rows = schema.load_rows(path)
    assert n == len(rows) == 4          # run_start + event + metric + span
    assert all(r["run"] == "fixed-id" for r in rows)
    assert [r["kind"] for r in rows] == ["event", "event", "metric", "span"]
    span_row = rows[-1]
    assert span_row["name"] == "phase/a" and span_row["dur_s"] >= 0.0
    assert span_row["tag"] == "x"
    assert [r["t"] for r in rows] == sorted(r["t"] for r in rows)
    # the reference's validator reads the port's record
    assert jschema.validate_file(path) == n


def test_stream_every_gates_metric_cadence(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path, stream_every=3) as rec:
        for step in range(10):
            rec.metric("rel", step=step, value=float(step))
    steps = [r["step"] for r in schema.load_rows(path)
             if r["kind"] == "metric"]
    assert steps == [0, 3, 6, 9]
    with pytest.raises(ValueError, match="stream_every"):
        obs.Recorder(str(tmp_path / "x.jsonl"), stream_every=0)


def test_schema_rejects_malformed_rows():
    ok = {"v": schema.SCHEMA_VERSION, "run": "r", "t": 0.0,
          "kind": "metric", "name": "m", "step": 0, "value": 1.0}
    assert schema.validate_row(dict(ok)) == ok
    with pytest.raises(schema.SchemaError, match="missing base fields"):
        schema.validate_row({"kind": "event", "name": "e"})
    with pytest.raises(schema.SchemaError, match="schema version"):
        schema.validate_row({**ok, "v": 999})
    with pytest.raises(schema.SchemaError, match="unknown row kind"):
        schema.validate_row({**ok, "kind": "frobnicate"})
    bad = dict(ok)
    del bad["value"]
    with pytest.raises(schema.SchemaError, match="missing required fields"):
        schema.validate_row(bad)
    with pytest.raises(schema.SchemaError, match="is not a number"):
        schema.validate_row({**ok, "value": "x"})
    with pytest.raises(schema.SchemaError, match="worker_lost event"):
        schema.validate_row({"v": 1, "run": "r", "t": 0.0, "kind": "event",
                             "name": "worker_lost", "worker": 0})
    with pytest.raises(schema.SchemaError, match="has no rows"):
        schema.validate_rows([])


def test_schema_tables_are_the_reference_s():
    assert schema.SCHEMA_VERSION == jschema.SCHEMA_VERSION == 1
    assert schema.BASE_FIELDS == jschema.BASE_FIELDS
    assert schema.KIND_FIELDS == jschema.KIND_FIELDS
    assert schema.EVENT_FIELDS == jschema.EVENT_FIELDS
    assert schema.PROVENANCE_SPEC_KEYS == jschema.PROVENANCE_SPEC_KEYS
    want = list(jschema.PROVENANCE_KEYS)
    want[want.index("traces"):want.index("traces") + 1] = ["launches",
                                                           "device"]
    assert list(schema.PROVENANCE_KEYS) == want
    # the port's RunSpec has the reference's fields, in its order
    assert (tuple(f.name for f in dataclasses.fields(repro_torch.RunSpec))
            == jschema.PROVENANCE_SPEC_KEYS)
    # the reference's names, less scan_metric (the port's drivers stream
    # through MetricStream), and the span log's
    assert set(obs.__all__) == (set(repro.obs.__all__) - {"scan_metric"}
                                | {"spans", "host_read", "counters"})


def test_telemetry_off_is_the_default_and_recording_scopes():
    assert obs.active() is None
    assert not obs.stream_active()
    with obs.recording(os.devnull) as rec:
        assert obs.active() is rec
        assert obs.stream_active()
    assert obs.active() is None
    with obs.span("nothing") as r:
        assert r is None


def test_import_repro_torch_obs_imports_neither_jax_nor_the_reference():
    code = ("import sys; import repro_torch.obs; "
            "import repro_torch.launch.obs; "
            "sys.exit(1 if any(m.split('.')[0] in ('jax', 'repro') "
            "for m in sys.modules) else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_reference_record_validates_under_the_port(tmp_path):
    """A reference run's record (staged spans, streamed metrics,
    comms_hlo, traces, provenance) passes the port's validator, and the
    port's report renders it."""
    path = str(tmp_path / "ref.jsonl")
    with repro.obs.recording(path):
        repro.solve(repro.RunSpec(algo="centralvr_async", p=P, eta=0.05,
                                  rounds=ROUNDS, speeds=SPEEDS), _sharded())
    n = schema.validate_file(path)
    assert n == jschema.validate_file(path)
    rows = schema.load_rows(path)
    assert report.summarize(rows)["metrics"]["rel"]["count"] == ROUNDS
    assert "streamed metrics" in report.render(rows)


# ---------------------------------------------------------------------------
# Recording changes nothing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_recorded_async_solve_is_bit_identical_with_full_record(tmp_path,
                                                                fused):
    """Algorithm 3 with speeds, fused and not, unrecorded then recorded:
    x, rels and launches exactly equal; the record carries the root
    solve span with solve/build, execute and solve/out inside it, one
    streamed metric row per round equal to rels,
    and the launches and provenance events; both validators accept it."""
    jsp, sp = _problem("centralvr_async")
    spec = repro_torch.RunSpec(**_spec("centralvr_async", fused=fused))
    orders = convert.async_orders(jax.random, KEY, P, sp.ns, ROUNDS)
    off = repro_torch.solve(spec, sp, device="cpu", orders=orders)
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path):
        on = repro_torch.solve(spec, sp, device="cpu", orders=orders)
    np.testing.assert_array_equal(off.rels, on.rels)
    np.testing.assert_array_equal(off.x, on.x)
    assert off.launches == on.launches

    assert schema.validate_file(path) == jschema.validate_file(path)
    rows = schema.load_rows(path)
    assert _phases(rows) == ["solve/build", "solve/centralvr_async/execute",
                             "solve/out", "solve"]
    ex = rows[[r["name"] for r in rows].index(
        "solve/centralvr_async/execute")]
    assert ex["launches"]["vr_epoch"] == on.launches["vr_epoch"]
    assert "device_ms" not in ex            # CUDA events on a card only
    metric = [r for r in rows if r["kind"] == "metric"]
    assert [r["value"] for r in metric] == [float(v) for v in on.rels]
    assert [r["step"] for r in metric] == list(range(ROUNDS))
    events = {r["name"]: r for r in rows if r["kind"] == "event"}
    assert events["launches"] == {**events["launches"], **on.launches}
    prov = events["provenance"]
    assert prov["final_rel"] == on.final_rel
    assert prov["staleness"] == on.staleness
    text = report.render(rows)
    assert "phase split" in text and "streamed metrics" in text


@pytest.mark.parametrize("algo", ALGOS)
def test_every_algorithm_records_one_execute_span(tmp_path, algo):
    """Every registry algorithm, recorded, runs bit-identically to its
    unrecorded run inside one ``solve/<algo>/execute`` span (the
    reference's labels); Algorithms 1-5 stream their rels, the baselines
    nothing, as in the reference."""
    jsp, sp = _problem(algo)
    caps = repro_torch.REGISTRY[algo].caps
    spec = repro_torch.RunSpec(**_spec(algo, fused=caps.accepts_fused))
    off = repro_torch.solve(spec, sp, device="cpu")
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path):
        on = repro_torch.solve(spec, sp, device="cpu")
    np.testing.assert_array_equal(off.rels, on.rels)
    np.testing.assert_array_equal(off.x, on.x)
    rows = schema.load_rows(path)
    assert _phases(rows) == ["solve/build", *DRIVER_SPANS.get(algo, []),
                             f"solve/{algo}/execute", "solve/out", "solve"]
    metric = [r["value"] for r in rows if r["kind"] == "metric"]
    assert metric == ([float(v) for v in on.rels] if algo in STREAMED
                      else [])


def test_unrecorded_runs_open_no_stream_and_make_no_event(monkeypatch):
    """Telemetry off: no driver opens a metric stream (so no pinned buffer)
    and no CUDA event is made."""
    def refuse(*a, **kw):
        raise AssertionError("telemetry off made a stream or an event")

    monkeypatch.setattr(stream, "MetricStream", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    for algo in STREAMED:
        _, sp = _problem(algo)
        caps = repro_torch.REGISTRY[algo].caps
        repro_torch.solve(repro_torch.RunSpec(
            **_spec(algo, fused=caps.accepts_fused)), sp, device="cpu")
    assert stream.open_stream("rel", 3, "cpu") is None


def test_stream_emits_in_round_order_and_disable_drops_late_rows(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path, stream_every=2):
        s = stream.open_stream("rel", 4, "cpu")
        for i in range(4):
            s.push(i, torch.tensor(0.5 ** i, dtype=torch.float64))
        s.close()
    rows = [r for r in schema.load_rows(path) if r["kind"] == "metric"]
    assert [(r["name"], r["step"], r["value"]) for r in rows] == [
        ("rel", 0, 1.0), ("rel", 2, 0.25)]


def test_staged_call_records_one_execute_span(tmp_path):
    from repro_torch.obs import stage

    assert stage.staged_call(lambda v, k=1: v * k, 3, k=2,
                             _label="t/plain") == 6
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path):
        out = stage.staged_call(lambda v: v * 2, torch.arange(3.0),
                                _label="t/plain", _device="cpu")
        with pytest.raises(ZeroDivisionError):
            stage.staged_call(lambda: 1 / 0, _label="t/fail")
    np.testing.assert_array_equal(out.numpy(), [0.0, 2.0, 4.0])
    rows = schema.load_rows(path)
    spans = [r for r in rows if r["kind"] == "span"]
    assert [r["name"] for r in spans] == ["t/plain/execute",
                                          "t/fail/execute"]
    assert spans[0]["launches"] == dict.fromkeys(
        repro_torch.kernels.COUNTERS, 0)
    assert spans[1]["failed"] is True
    # the port has no compile step to fall back from
    assert not any(r["name"] == "stage_fallback" for r in rows)


# ---------------------------------------------------------------------------
# The LM loop
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The span log and the counted host reads
# ---------------------------------------------------------------------------

def _cpu_profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _sync_solve(fused=True, **kw):
    """A centralvr_sync solve on the CPU at the test size, with the
    reference's draws."""
    _, sp = _problem("centralvr_sync")
    spec = repro_torch.RunSpec(**{**_spec("centralvr_sync", fused=fused),
                                  **kw})
    orders = convert.sync_orders(jax.random, KEY, P, sp.ns, ROUNDS)
    return repro_torch.solve(spec, sp, device="cpu", orders=orders)


def test_spans_and_host_reads_are_off_without_recorder_or_profiler(
        monkeypatch):
    """Neither a recorder nor a profiler: a span is the one shared null
    context, a host read is its call, and neither makes an event or an
    entry of the log."""
    from repro_torch.obs import recorder

    def refuse(*a, **kw):
        raise AssertionError("tracing off made a CUDA event")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not recorder.tracing()
    before = obs.spans()
    assert obs.span("solve/epoch", device="cuda") is recorder._NULL
    with obs.span("solve/rel", device="cuda") as r:
        assert r is None
    assert obs.host_read("test_off", float, torch.tensor(2.5)) == 2.5
    _sync_solve()
    assert obs.spans() == before


def test_host_reads_are_counted_by_site():
    """Each read counts once under its site, traced or not; a solve of
    Algorithm 2 reads eight device values: auto_eta, the two ends of each
    of its two order arrays, the fused init epoch's permutation check,
    rels and x."""
    before = obs.counters()
    obs.host_read("test_site", int, torch.tensor(3))
    obs.host_read("test_site", int, torch.tensor(4))
    with _cpu_profiler():
        assert obs.host_read("test_other", list, (1, 2)) == [1, 2]
        assert obs.counters(traced=True) == {"test_other": 1}
    after = obs.counters()
    assert after["test_site"] - before.get("test_site", 0) == 2
    assert after["test_other"] - before.get("test_other", 0) == 1
    before = obs.counters()
    _sync_solve(eta=None)
    after = obs.counters()
    reads = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    assert reads == {"auto_eta": 1, "orders_min": 2, "orders_max": 2,
                     "init_perm": 1, "solve_rels": 1, "solve_x": 1}


def test_span_log_is_bounded_and_starts_afresh_with_each_session(
        monkeypatch):
    """The log keeps the last ``LOG_ENTRIES`` spans, reading it clears
    nothing, and a new profiler session starts it empty."""
    from repro_torch.obs import recorder

    monkeypatch.setattr(recorder, "LOG_ENTRIES", 5)
    with _cpu_profiler():
        assert recorder.tracing() and obs.spans() == []
        for i in range(8):
            with obs.span(f"t/{i}", i=i):
                pass
        got = obs.spans()
        assert [s["name"] for s in got] == [f"t/{i}" for i in range(3, 8)]
        assert obs.spans() == got
        assert all(s["parent"] is None and s["root"] == s["id"]
                   and s["t0_ns"] <= s["t1_ns"] and s["device_ms"] is None
                   for s in got)
    assert not recorder.tracing()
    with obs.span("t/untraced"):
        pass
    assert obs.spans() == got
    with _cpu_profiler():
        assert obs.spans() == [] and obs.counters(traced=True) == {}


def test_profiled_solve_logs_its_spans_as_profiler_ranges():
    """Under a profiler and no recorder, a solve's spans go to the log,
    nested by id under one root, in start order, and each is a
    ``record_function`` range of the profiler's trace."""
    with _cpu_profiler() as prof:
        res = _sync_solve()
    got = obs.spans()
    root = got[0]
    assert root["name"] == "solve" and root["parent"] is None
    assert root["algo"] == "centralvr_sync"
    ids = {s["id"]: s for s in got}
    for s in got[1:]:
        up = ids[s["parent"]]
        assert s["root"] == root["id"]
        assert up["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= up["t1_ns"]
    rounds = [s for s in got if s["name"] == "solve/round"]
    assert len(rounds) == ROUNDS
    for r in rounds:
        kids = [s["name"] for s in got if s["parent"] == r["id"]]
        assert kids == ["solve/epoch", "solve/average", "solve/rel"]
    assert {s["name"] for s in got} <= {e.name for e in prof.events()}
    np.testing.assert_array_equal(res.rels, _sync_solve().rels)


@pytest.mark.parametrize("fused", [False, True])
def test_recorded_sync_solve_span_rows_validate_with_consistent_ids(
        tmp_path, fused):
    """A recorded Algorithm 2 solve: its span rows validate under both
    validators (schema v1, the log's keys as extra fields), every row's
    parent is another row's id, all share the root row's id, the rows are
    the log's spans, and its host reads are its ``sync/<site>`` rows."""
    path = str(tmp_path / "run.jsonl")
    before = obs.counters()
    with obs.recording(path):
        on = _sync_solve(fused=fused, eta=None)
        got = obs.spans()
    after = obs.counters()
    np.testing.assert_array_equal(on.rels, _sync_solve(fused=fused,
                                                       eta=None).rels)
    assert schema.validate_file(path) == jschema.validate_file(path)
    rows = [r for r in schema.load_rows(path) if r["kind"] == "span"]
    assert _phases(rows) == ["solve/build", *DRIVER_SPANS["centralvr_sync"],
                             "solve/centralvr_sync/execute", "solve/out",
                             "solve"]
    ids = {r["id"]: r for r in rows}
    root = rows[-1]
    assert root["parent"] is None and root["root"] == root["id"]
    for r in rows[:-1]:
        assert r["parent"] in ids and r["root"] == root["id"]
        assert ids[r["parent"]]["t0"] <= r["t0"]
    assert sorted(ids) == sorted(s["id"] for s in got
                                 if s["root"] == root["id"])
    reads = {}
    for r in rows:
        if r["name"].startswith("sync/"):
            site = r["name"][len("sync/"):]
            reads[site] = reads.get(site, 0) + 1
    assert reads == {k: after[k] - before.get(k, 0) for k in after
                     if after[k] != before.get(k, 0)}
    assert ("init_perm" in reads) == fused


def test_staged_call_under_a_profiler_is_a_span_and_waits_for_nothing(
        tmp_path, monkeypatch):
    """A profiler and no recorder: the execute span goes to the log, and
    the call neither synchronises nor writes a row."""
    from repro_torch.obs import stage

    def refuse(*a, **kw):
        raise AssertionError("staged_call synchronised under a profiler")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with _cpu_profiler():
        assert stage.staged_call(lambda v: v + 1, 1, _label="t/prof",
                                 _device="cpu") == 2
        with pytest.raises(ZeroDivisionError):
            stage.staged_call(lambda: 1 / 0, _label="t/prof_fail")
        got = obs.spans()
    assert [(s["name"], s["failed"]) for s in got] == [
        ("t/prof/execute", False), ("t/prof_fail/execute", True)]


def test_train_loop_emits_structured_epoch_rows(tmp_path):
    """``mamba2-130m.reduced()`` at W = 2: the first epoch staged, the
    second a ``train/epoch`` span, ``train_epoch`` rows with epoch, step,
    loss and workers, ``train/eval`` and ``train_done``; the losses
    bit-identical with and without recording."""
    from repro_torch.train import loop

    cfg = get_arch("mamba2-130m").reduced()
    tcfg = TrainConfig(seq_len=16, global_batch=4, microbatch=1,
                       optimizer="sgd", learning_rate=0.1, vr="centralvr",
                       vr_table_size=2, local_epoch=1)
    bare = loop.run_training(cfg, tcfg, epochs=2, workers=2, device="cpu",
                             log_every=0)
    path = str(tmp_path / "train.jsonl")
    lines = []
    with obs.recording(path):
        res = loop.run_training(cfg, tcfg, epochs=2, workers=2,
                                device="cpu", log_fn=lines.append)
    assert res.losses == bare.losses
    assert res.final_eval_loss == bare.final_eval_loss
    assert schema.validate_file(path) == jschema.validate_file(path)
    rows = schema.load_rows(path)
    E = tcfg.vr_table_size * tcfg.local_epoch
    epoch_rows = [r for r in rows if r["name"] == "train_epoch"]
    assert [(r["epoch"], r["step"], r["workers"]) for r in epoch_rows] == [
        (0, E, 2), (1, 2 * E, 2)]
    assert [r["loss"] for r in epoch_rows] == [res.losses[E - 1],
                                               res.losses[-1]]
    assert len(lines) == 2
    spans = [r for r in rows if r["kind"] == "span"]
    assert [r["name"] for r in spans] == ["train/epoch/execute",
                                          "train/epoch", "train/eval"]
    assert spans[1]["epoch"] == 1
    done = [r for r in rows if r["name"] == "train_done"]
    assert len(done) == 1 and done[0]["epochs"] == 2
    assert done[0]["eval_loss"] == res.final_eval_loss


# ---------------------------------------------------------------------------
# Staleness, provenance, final_rel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("speeds", [None, "heterogeneous"])
@pytest.mark.parametrize("rounds", [1, 3, 10])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_staleness_stats_equal_the_reference(p, rounds, speeds):
    if speeds:
        speeds = tuple(float(1 + (3 * i) % 5) for i in range(p))
    have = staleness.staleness_stats(
        runtime.event_schedule(p, rounds, speeds), p)
    want = jstaleness.staleness_stats(
        jruntime.event_schedule(p, rounds, speeds), p)
    assert have == want
    assert json.loads(json.dumps(have)) == have


def test_staleness_rejects_ragged_schedule():
    with pytest.raises(ValueError, match="not a multiple"):
        staleness.staleness_stats(np.zeros(5, dtype=np.int64), p=2)


@pytest.mark.parametrize("algo,fetch", [("centralvr_async", None),
                                        ("dsaga", "instant"),
                                        ("dsaga", "stale")])
def test_async_runs_carry_the_reference_staleness(algo, fetch):
    jsp, sp = _problem(algo)
    kw = _spec(algo) if fetch is None else _spec(algo, fetch=fetch, tau=5)
    want = repro.solve(repro.RunSpec(**kw), jsp, key=KEY)
    have = repro_torch.solve(repro_torch.RunSpec(**kw), sp, device="cpu")
    assert have.staleness == want.staleness
    assert have.provenance()["staleness"] == want.provenance()["staleness"]


def test_provenance_row_matches_golden_schema():
    _, sp = _problem("centralvr_async")
    res = repro_torch.solve(repro_torch.RunSpec(**_spec("centralvr_async")),
                            sp, device="cpu")
    row = res.provenance()
    assert tuple(row) == schema.PROVENANCE_KEYS
    assert tuple(row["spec"]) == schema.PROVENANCE_SPEC_KEYS
    assert row["schema_v"] == schema.SCHEMA_VERSION
    assert row["comms"]["algo"] == "centralvr_async"
    assert sum(row["staleness"]["histogram"].values()) == P * ROUNDS
    json.dumps(row)
    sync = repro_torch.solve(repro_torch.RunSpec(**_spec("centralvr_sync")),
                             sp, device="cpu").provenance()
    assert tuple(sync) == schema.PROVENANCE_KEYS
    assert sync["staleness"] is None
    assert sync["comms"]["n_allreduce_per_round"] == 2


@pytest.mark.parametrize("algo", ["centralvr", "centralvr_sync", "dsvrg",
                                  "saga"])
def test_final_rel_is_the_last_rel_and_the_reference_s(algo):
    """``RunResult.final_rel`` (``repro/core/solver.py:471-473``): the last
    recorded rel, equal to the reference's on the same draws."""
    jsp, sp = _problem(algo)
    kw = _spec(algo)
    want = repro.solve(repro.RunSpec(**kw), jsp, key=KEY)
    r = jax.random
    orders = {"centralvr": lambda: convert.centralvr_orders(
                  r, KEY, sp.n, ROUNDS),
              "centralvr_sync": lambda: convert.sync_orders(
                  r, KEY, P, sp.ns, ROUNDS),
              "dsvrg": lambda: convert.dsvrg_orders(r, KEY, P, sp.ns,
                                                    ROUNDS),
              "saga": lambda: convert.saga_orders(r, KEY, sp.n, ROUNDS)}
    have = repro_torch.solve(repro_torch.RunSpec(**kw), sp, device="cpu",
                             orders=orders[algo]())
    assert have.final_rel == float(have.rels[-1])
    assert isinstance(have.final_rel, float)
    np.testing.assert_allclose(have.final_rel, want.final_rel,
                               rtol=CONVEX_TOL, atol=CONVEX_TOL)


# ---------------------------------------------------------------------------
# kernels/build span, compile cache, report
# ---------------------------------------------------------------------------

def _fake_nvcc(tmp_path):
    """A stand-in for nvcc that writes its ``-o`` target."""
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                      "echo built > \"$2\"\n")
    script.chmod(0o755)
    return str(script)


def test_build_span_counts_built_and_cached(tmp_path, monkeypatch):
    """``kernels/build`` spans: a cold build names the sources it
    compiled; a second build into the same directory (what a second
    process on one ``--compile-cache`` does) compiles nothing."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.vr_update import epoch
    from repro_torch.launch import compile_cache

    monkeypatch.setattr(build, "nvcc", lambda: _fake_nvcc(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.enable_compile_cache(None) is None
    cache = tmp_path / "cc"
    assert compile_cache.enable_compile_cache(str(cache)) == str(cache)
    assert build.BUILD_DIR == cache
    assert build.build(epoch.SOURCE) == [build.library_path(epoch.SOURCE)]
    path = str(tmp_path / "b.jsonl")
    with obs.recording(path):
        libs = build.build(epoch.SOURCE, rms.SOURCE)
        build.build(epoch.SOURCE, rms.SOURCE)
    assert all(lib.parent == cache and lib.exists() for lib in libs)
    spans = [r for r in schema.load_rows(path) if r["kind"] == "span"]
    assert [(r["name"], r["built"], r["cached"]) for r in spans] == [
        ("kernels/build", [rms.SOURCE.name], 1),
        ("kernels/build", [], 2)]
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
    assert compile_cache.enable_compile_cache(None) == str(tmp_path / "env")
    assert build.BUILD_DIR == tmp_path / "env"


def test_report_splits_build_warm_and_device():
    def span(name, dur, **kw):
        return {"v": 1, "run": "r", "t": 0.0, "kind": "span", "name": name,
                "t0": 0.0, "dur_s": dur, **kw}
    rows = [span("kernels/build", 2.0, built=["a.cu"], cached=0),
            span("solve/x/execute", 0.5, device_ms=400.0),
            span("train/epoch/execute", 0.25),
            span("solve/build", 0.125)]
    s = report.summarize(rows)
    assert (s["compile_s"], s["warm_s"], s["device_s"]) == (2.0, 0.75, 0.4)
    assert "lower_s" not in s
    assert ("phase split: build 2.000s  warm(execute) 0.750s  device "
            "0.400s") in report.render(rows)
