"""The readers of the program's span log and host-read counter
(``host_syncs_per_solve.convex``, ``prologue_ms_per_solve.convex``,
``rel_ms_per_round.convex``, ``solve_idle_ms.convex``) on a made-up trace
and log; on the card (marked ``cuda``), a traced solve of the p8 cell
held to the device trace."""
import numpy as np
import pytest

from bench.harness import cells, trace
from repro_torch import obs
from repro_torch.obs import timeline

READERS = ("host_syncs_per_solve.convex", "prologue_ms_per_solve.convex",
           "rel_ms_per_round.convex", "solve_idle_ms.convex")
ORIGIN = 1_790_000_000_000_000_000     # the trace's zero on the host clock
LAG = 4.0     # us from a read's start to its first call; its end lags
#               its last call by 3, 4 or 5 us
ROUNDS = 2


class _Log:
    """A made-up span log of solves, each from ``start`` (us on the
    trace's time base): build 0-100 (a read ending at 90), orders 100-150
    (two reads), two rounds of 1000 us, each with a rel span of device
    time 0.5 + round / 10 ms, and out 2200-4000 (a read that waits 1.5 ms
    for the device)."""

    def __init__(self):
        self.spans, self.host, self.reads = [], [], {}
        self.ids = iter(range(1, 10 ** 6))

    def span(self, name, t0, t1, parent=None, device_ms=None):
        sid = next(self.ids)
        root = sid if parent is None else parent["root"]
        s = {"name": name, "id": sid, "root": root,
             "parent": None if parent is None else parent["id"],
             "t0_ns": ORIGIN + int(t0 * 1e3), "t1_ns": ORIGIN + int(t1 * 1e3),
             "device_ms": device_ms, "failed": False}
        self.spans.append(s)
        return s

    def read(self, site, t1, parent, wait=0.0):
        """A host read ending at ``t1`` after waiting ``wait`` us for the
        device: its span, and the runtime calls it ends in on the
        trace."""
        lag = LAG - 1.0 + len(self.host) // 2 % 3      # 3, 4 or 5 us
        self.span(f"sync/{site}", t1 - 20.0 - wait, t1, parent)
        self.host += [("cudaMemcpyAsync", t1 - 20.0 - wait + LAG, t1 - 12.0),
                      ("cudaStreamSynchronize", t1 - 11.0, t1 - lag)]
        self.reads[site] = self.reads.get(site, 0) + 1

    def solve(self, start):
        root = self.span("solve", start, start + 4000.0)
        build = self.span("solve/build", start, start + 100.0, root, 0.05)
        self.read("auto_eta", start + 90.0, build)
        orders = self.span("solve/orders", start + 100.0, start + 150.0, root)
        self.read("orders_min", start + 120.0, orders)
        self.read("orders_max", start + 145.0, orders)
        for r in range(ROUNDS):
            t = start + 200.0 + 1000.0 * r
            rnd = self.span("solve/round", t, t + 1000.0, root)
            self.span("solve/epoch", t, t + 700.0, rnd, 0.9)
            self.span("solve/rel", t + 800.0, t + 900.0, rnd, 0.5 + r / 10)
            self.host.append(("cudaLaunchKernel", t + 10.0, t + 15.0))
        out = self.span("solve/out", start + 2200.0, start + 4000.0, root)
        self.read("solve_rels", start + 3990.0, out, wait=1500.0)


def _made_up(solves=2):
    log = _Log()
    for k in range(solves):
        log.solve(5000.0 * k)
    # the device is busy but for: 10 us inside each solve's build, 40 us
    # in its first round, and 1000 us between the solves
    dev = []
    for k in range(solves):
        s = 5000.0 * k
        dev += [("op", s, s + 30.0), ("op", s + 40.0, s + 250.0),
                ("op", s + 290.0, s + 4000.0)]
    run = {"kind": "convex_sync", "workers": 8, "rows": 10, "features": 4,
           "rounds": ROUNDS, "units_traced": solves, "units_timed": 1,
           "seconds_timed": 1.0}
    return log, trace.Trace(dev, log.host), run


@pytest.fixture
def made_up(monkeypatch):
    log, tr, run = _made_up()
    monkeypatch.setattr(obs, "spans", lambda: list(log.spans))
    monkeypatch.setattr(obs, "counters",
                        lambda traced=False: dict(log.reads))
    return log, tr, run


def _read(name, tr, run):
    return cells.metric_reader(name).read(tr, run)


def test_alignment_finds_the_trace_zero(made_up):
    log, tr, _ = made_up
    al = timeline.align(log.spans, tr.host)
    assert al.pairs == al.reads == 8
    # each pair's difference is the mean of the lead into its read and
    # the lag out of it, less the true zero: 0 or 0.5 us
    assert al.origin_ns == ORIGIN
    assert al.residual_us == 0.5


def test_each_reader_s_value(made_up):
    _, tr, run = made_up
    assert _read("host_syncs_per_solve.convex", tr, run) == 4.0
    # build 100 us and orders 50 us a solve
    assert _read("prologue_ms_per_solve.convex", tr, run) == \
        pytest.approx(0.150)
    # rounds of 0.5 and 0.6 ms
    assert _read("rel_ms_per_round.convex", tr, run) == pytest.approx(0.55)
    # 10 + 40 us of each solve's gaps; the 1000 us between solves is not
    # inside one
    assert _read("solve_idle_ms.convex", tr, run) == \
        pytest.approx(0.050, abs=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_nothing_on_a_solve_count_mismatch(made_up, name):
    _, tr, run = made_up
    assert _read(name, tr, dict(run, units_traced=3)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_from_a_program_without_the_span_log(monkeypatch, name):
    _, tr, run = _made_up()
    monkeypatch.delattr(obs, "spans")
    monkeypatch.delattr(obs, "counters")
    assert _read(name, tr, run) is None


def test_gaps_fall_to_the_innermost_span(made_up):
    log, tr, _ = made_up
    al = timeline.align(log.spans, tr.host)
    gaps = tr.gaps()
    assert gaps[:3] == [(30.0, 40.0), (250.0, 290.0), (4000.0, 5000.0)]
    inner = timeline.innermost(log.spans, al, [0.5 * (a + b)
                                               for a, b in gaps[:3]])
    # 35 us: in build, before its read; 270 us: the first round's epoch
    assert [s and s["name"] for s in inner] == [
        "solve/build", "solve/epoch", None]
    split = timeline.by_span(log.spans, al, gaps)
    assert split["solve/build"]["idle_ms"] == pytest.approx(0.020)
    assert split["solve/epoch"]["idle_ms"] == pytest.approx(0.080)
    assert split["solve/rel"] == {"n": 4, "host_ms": pytest.approx(0.4),
                                  "device_ms": pytest.approx(2.2),
                                  "idle_ms": 0.0}
    assert sum(v["idle_ms"] for v in split.values()) == pytest.approx(0.1)


def test_a_read_that_matches_no_call_is_left_out(made_up):
    """A read with no runtime call of the trace (one the profiler lost,
    or a read of a CPU value) is not a pair, and moves nothing."""
    log, tr, _ = made_up
    spans = log.spans + [{"name": "sync/cpu", "id": -1, "parent": None,
                          "root": -1, "t0_ns": ORIGIN + 3_000_000,
                          "t1_ns": ORIGIN + 3_100_000, "device_ms": None,
                          "failed": False}]
    al = timeline.align(spans, tr.host)
    assert (al.pairs, al.reads) == (8, 9)
    assert al.origin_ns == ORIGIN


# -- on the card ------------------------------------------------------------

P8 = "dist-toy-logistic.sync-p8"
TOLERANCE_US = 20.0


def _traced(solve, problem, order_sets, spans: bool):
    """Three solves under the benchmark's profiler; ``spans=False`` with
    the span log switched off, as a program without it runs."""
    import torch

    from repro_torch.obs import recorder

    prof = trace.profiler()
    prof.start()
    recorder._TRACING = spans       # the profiler's stop sets it anew
    torch.cuda.synchronize()
    for k in range(3):
        solve(problem, order_sets[k % len(order_sets)])
    torch.cuda.synchronize()
    prof.stop()
    return prof


@pytest.fixture(scope="module")
def traced_p8():
    """Three traced solves of the p8 cell's problem on the card, after one
    untraced and three traced with the spans off: (trace, the profiler's
    raw events, its start on the host clock, the span log, the host reads,
    the run's record, the trace with the spans off)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    from bench.kinds import convex_sync
    device = torch.device("cuda", 0)
    cell = cells.cell(P8)
    conf, traffic = cell.config, cell.traffic
    problem = convex_sync._problem(conf, traffic, 2 ** 31 + 5, device)
    order_sets = convex_sync._orders(conf, traffic, 2 ** 31 + 5, device)
    solve = convex_sync._solver(conf, traffic)
    solve(problem, order_sets[0])
    torch.cuda.synchronize()
    off = trace.Trace.from_profiler(_traced(solve, problem, order_sets,
                                            spans=False))
    assert obs.spans() == []
    prof = _traced(solve, problem, order_sets, spans=True)
    tr = trace.Trace.from_profiler(prof)
    results = prof.profiler.kineto_results
    run = {"kind": "convex_sync", "rounds": traffic["rounds"],
           "units_traced": 3}
    return (tr, list(results.events()), results.trace_start_ns(),
            obs.spans(), obs.counters(traced=True), run, off)


def _rel_us(e, start_ns):
    return ((e.start_ns() - start_ns) * 1e-3, (e.end_ns() - start_ns) * 1e-3)


@pytest.mark.cuda
def test_epoch_launches_fall_inside_their_epoch_spans(traced_p8):
    """Each round's vr_epoch launch (the runtime call of the kernel, by
    the raw events' correlation ids) lies inside that round's
    ``solve/epoch`` span once the log is aligned, within 20 us; the
    alignment's zero is the trace's own start, within 20 us."""
    from torch.autograd import DeviceType

    tr, events, start_ns, spans, _, _, _ = traced_p8
    al = timeline.align(spans, tr.host)
    assert al is not None and al.residual_us <= TOLERANCE_US
    assert abs(al.origin_ns - start_ns) <= TOLERANCE_US * 1e3
    calls = {e.correlation_id(): e for e in events
             if e.device_type() == DeviceType.CPU}
    launches = sorted(_rel_us(calls[e.correlation_id()], start_ns)
                      for e in events if e.device_type() == DeviceType.CUDA
                      and "vr_epoch_kernel" in e.name())
    epochs = [s for s in spans if s["name"] == "solve/epoch"]
    inits = [s for s in spans if s["name"] == "solve/init"]
    assert len(epochs) == 3 * 10 and len(launches) == len(epochs) + 3
    t0, t1 = al.us([s["t0_ns"] for s in epochs]), \
        al.us([s["t1_ns"] for s in epochs])
    init_t1 = al.us([s["t1_ns"] for s in inits])
    rounds = [c for c in launches
              if not any(a <= c[0] <= b for a, b in zip(
                  al.us([s["t0_ns"] for s in inits]), init_t1))]
    assert len(rounds) == len(epochs)
    for (a, b), lo, hi in zip(rounds, t0, t1):
        assert lo - TOLERANCE_US <= a and b <= hi + TOLERANCE_US


@pytest.mark.cuda
def test_counted_reads_are_the_device_to_host_copies(traced_p8):
    """In each traced solve, the counted host reads (its ``sync/<site>``
    spans) are its device-to-host copies, one each, and the counter over
    the solves holds them all."""
    from torch.autograd import DeviceType

    tr, events, start_ns, spans, reads, _, _ = traced_p8
    al = timeline.align(spans, tr.host)
    calls = {e.correlation_id(): e for e in events
             if e.device_type() == DeviceType.CPU}
    copies = np.array([_rel_us(calls[e.correlation_id()], start_ns)[0]
                       for e in events if e.device_type() == DeviceType.CUDA
                       and "DtoH" in e.name()])
    solves = timeline.roots(spans, "solve")
    assert len(solves) == 3
    for root in solves:
        lo, hi = al.us([root["t0_ns"], root["t1_ns"]])
        synced = sum(s["root"] == root["id"] and s["name"].startswith("sync/")
                     for s in spans)
        assert synced == int(((copies >= lo) & (copies <= hi)).sum()) == 8
    assert sum(reads.values()) == 3 * 8


@pytest.mark.cuda
def test_spans_add_no_device_operation(traced_p8, monkeypatch):
    """The spans' CUDA events are no device operations: the traced
    solves run the device operations, by name, that they run with the
    span log off, as the program before it did, and
    ``launches_per_round.convex`` reads the same; every reader reads the
    traced solves."""
    from collections import Counter

    tr, _, _, spans, reads, run, off = traced_p8
    ops = Counter(n for n, _, _ in tr.dev)
    ops_off = Counter(n for n, _, _ in off.dev)
    assert ops == ops_off, (ops - ops_off, ops_off - ops)
    launches = cells.metric_reader("launches_per_round.convex")
    assert launches.read(tr, run) == launches.read(off, run)
    monkeypatch.setattr(obs, "spans", lambda: list(spans))
    monkeypatch.setattr(obs, "counters", lambda traced=False: dict(reads))
    for name in READERS:
        assert _read(name, tr, run) is not None, name
