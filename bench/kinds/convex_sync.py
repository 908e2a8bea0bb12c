"""The distributed convex cells: the port's solver
(``repro_torch.solve``) running CentralVR-Sync (Algorithm 2) on the
paper's §6.2 problem, p workers batched on one card, the fused path (one
``vr_epoch`` launch an epoch for all workers).

A request is one ``solve`` of the cell's problem to its fixed rounds,
from x = 0, with visit orders of its own. Set-up makes the data and
``order_sets`` draws of orders from the seed on the card and runs one
solve, which loads every kernel the window uses. The window runs solves
back to back, taking the order sets in turn, each timed on the host from
its call to its return (``solve`` returns the iterate and the rel series
on the host). It holds whole solves.

After the window the plain reference (``bench/reference/convex_sync.py``)
solves each order set once in float64, and every solve of the window is
compared with the reference of its orders:

  x_gap    max |x - x_ref| over max |x_ref| of the final iterate;
  rel_gap  the largest relative gap of a round's |grad f| / |grad f(0)|.
"""
from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from bench.cost import convex as cost
from bench.data import convex as data
from bench.harness import trace as tracelib
from bench.harness.runs import Outcome, free, peak, reset_peak, sync
from bench.reference import convex_sync as ref

TRACE_SECONDS = 4.0


def _problem(conf: dict, traffic: dict, seed: int, device):
    from repro_torch.core import distributed
    if conf["problem"] != "logistic" or conf["dtype"] != "float64":
        raise ValueError("convex_sync drives float64 l2-logistic problems")
    A, b = data.logistic(seed, p=traffic["workers"],
                         n=conf["rows_per_worker"], d=conf["features"],
                         device=device)
    lam = _lam(conf)
    return distributed.ShardedProblem(A, b, lam, "logistic")


def _lam(conf: dict) -> float:
    """The l2 coefficient as the configuration states it: a float32
    value (the paper's code and the port both store it so)."""
    return float(np.float32(conf["lam"]))


def _orders(conf, traffic, seed, device):
    return data.orders(seed, sets=traffic["order_sets"],
                       rounds=traffic["rounds"], p=traffic["workers"],
                       n=conf["rows_per_worker"], device=device)


def _solver(conf: dict, traffic: dict, variant=None):
    """``solve(problem, orders) -> (x, rels)`` on the host: the port's, or
    with ``variant="control"`` the reference in float32 in its place."""
    if variant == "control":
        def solve_ref(problem, orders):
            x, rels = ref.solve(problem.A, problem.b, problem.lam,
                                orders[0][None], orders[1][None],
                                dtype=torch.float32)
            return x[0].cpu().numpy(), rels[0].cpu().numpy()
        return solve_ref
    from repro_torch import RunSpec, solve
    spec = RunSpec(algo=conf["algorithm"], p=traffic["workers"],
                   rounds=traffic["rounds"], fused=conf["fused"])

    def solve_port(problem, orders):
        res = solve(spec, problem, device=problem.A.device, orders=orders)
        return res.x, res.rels
    return solve_port


def _gaps(answers, refs):
    """(x_gap, rel_gap) of each answer [(set, x, rels)] against the
    reference answers {set: (x, rels)}."""
    out = []
    for s, x, rels in answers:
        xr, rr = refs[s]
        x_gap = float(abs(x - xr).max() / abs(xr).max())
        rel_gap = float((abs(rels - rr) / abs(rr)).max())
        out.append((x_gap, rel_gap))
    return out


def references(problem, order_sets) -> dict:
    """{order set: (x, rels)} of the reference, every set in one pass."""
    x, rels = ref.solve(problem.A, problem.b, problem.lam,
                        torch.stack([o[0] for o in order_sets]),
                        torch.stack([o[1] for o in order_sets]))
    x, rels = x.cpu().numpy(), rels.cpu().numpy()
    return {s: (x[s], rels[s]) for s in range(len(order_sets))}


def readings(cell, seed: int, device, variant=None) -> dict:
    """The check's numbers of one seed with no window: one solve of each
    order set, then the reference."""
    conf, traffic = cell.config, cell.traffic
    problem = _problem(conf, traffic, seed, device)
    order_sets = _orders(conf, traffic, seed, device)
    solve = _solver(conf, traffic, variant)
    answers = [(s, *solve(problem, o)) for s, o in enumerate(order_sets)]
    gaps = _gaps(answers, references(problem, order_sets))
    return {"x_gap": max(g[0] for g in gaps),
            "rel_gap": max(g[1] for g in gaps)}


def run(cell, *, seed: int, seconds: float, trace: bool, device, clock0,
        variant=None):
    conf, traffic = cell.config, cell.traffic
    problem = _problem(conf, traffic, seed, device)
    order_sets = _orders(conf, traffic, seed, device)
    solve = _solver(conf, traffic, variant)
    solve(problem, order_sets[0])                  # loads every kernel
    sync(device)
    setup_peak = peak(device)
    reset_peak(device)
    setup_s = time.perf_counter() - clock0

    answers, times = [], []

    def one():
        s = len(answers) % len(order_sets)
        t = time.perf_counter()
        x, rels = solve(problem, order_sets[s])
        times.append(time.perf_counter() - t)
        answers.append((s, x, rels))

    prof = tracelib.profiler() if trace else None
    if prof is not None:
        prof.start()            # the profiler's own start is not timed
        sync(device)
    t0 = time.perf_counter()
    if prof is not None:
        while not answers or time.perf_counter() - t0 < min(seconds,
                                                            TRACE_SECONDS):
            one()
        sync(device)
        traced_s = time.perf_counter() - t0
        prof.stop()
    traced, t_traced = len(answers), time.perf_counter()
    while not answers or time.perf_counter() - t0 < seconds:
        one()
    t1 = time.perf_counter()
    wall = t1 - t0
    window_peak = peak(device)

    run_info, tr = None, None
    p, n = traffic["workers"], conf["rows_per_worker"]
    if prof is not None:
        tr = tracelib.Trace.from_profiler(prof, traced_s)
        # the solve rate of the untraced rest of the window, or of the
        # traced stretch where nothing is left
        timed = ((len(answers) - traced, t1 - t_traced)
                 if len(answers) > traced else (traced, tr.window_s))
        run_info = {"kind": "convex_sync", "config": conf,
                    "traffic": traffic, "workers": p, "rows": n,
                    "features": conf["features"], "rounds": traffic["rounds"],
                    "units_traced": traced, "units_timed": timed[0],
                    "seconds_timed": timed[1]}
    t_ref = time.perf_counter()
    refs = references(problem, order_sets)
    reference_s = time.perf_counter() - t_ref
    gaps = _gaps(answers, refs)
    limits = cell.limits
    per_solve = [{"x_gap": xg, "rel_gap": rg} for xg, rg in gaps]
    # a gap that is not a number fails too
    failed = sum(not all(g[k] <= lim for k, lim in limits.items())
                 for g in per_solve)
    checks = {k: (max(g[k] for g in per_solve), lim)
              for k, lim in limits.items()}
    samples = len(answers) * cost.samples_per_solve(p, n, traffic["rounds"])
    e2e = {"convex_solve_ms_p95": float(np.percentile(times, 95)) * 1e3,
           "convex_samples_per_s": samples / wall,
           "peak_mem_gib": window_peak / 2 ** 30, "setup_s": setup_s,
           "solve_ms_median": statistics.median(times) * 1e3,
           "reference_s": reference_s}
    del problem
    free(device)
    return Outcome(failed == 0, len(answers), failed, e2e, checks,
                   max(setup_peak, window_peak), tr, run_info)


# -- the faults that the correctness check has to catch (planted in the
# program; the benchmark's own runs never use them)

@contextlib.contextmanager
def _patched_round(round_fn):
    from repro_torch.core import distributed
    saved = distributed.sync_round
    distributed.sync_round = round_fn(saved)
    try:
        yield
    finally:
        distributed.sync_round = saved


def fault_frozen():
    """Every round hands back its state unchanged."""
    return _patched_round(lambda saved: (
        lambda sp, st, *args, **kwargs: st))


def fault_half_workers():
    """The central average taken over half of the workers."""
    def make(saved):
        from repro_torch.core import distributed

        def half(sp, st, eta, perms, fused=None, prox=None):
            xs, tables, accs = distributed._local_centralvr_epoch(
                sp.A, sp.b, sp.lam, sp.kind, st.x.expand(sp.p, sp.d),
                st.tables, st.gbar, eta, perms, fused=fused, prox=prox)
            k = max(sp.p // 2, 1)
            return distributed.SyncState(x=xs[:k].mean(0), tables=tables,
                                         gbar=accs[:k].mean(0))
        return half
    return _patched_round(make)


def fault_altered():
    """Each round's iterate altered where it is produced: its first
    coordinate moved by a millionth of its largest."""
    def make(saved):
        def altered(*args, **kwargs):
            st = saved(*args, **kwargs)
            x = st.x.clone()
            x[0] += 1e-6 * x.abs().max()
            return st._replace(x=x)
        return altered
    return _patched_round(make)


FAULTS = {"frozen": fault_frozen, "half_workers": fault_half_workers,
          "altered": fault_altered}
