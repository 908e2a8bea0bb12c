"""The PyTorch port's Algorithms 3-5 (``centralvr_async``, ``dsvrg``,
``dsaga``) and its event-schedule algebra (``core/runtime.py``) against
the JAX reference.

The drivers run through ``repro_torch.solve`` against ``repro.solve`` on
every fused × prox × snapshot × fetch × speeds cell the reference accepts
with backend="vmap", and ``literal_scaling`` through ``run_dsaga`` on
both sides; single events continue from the reference's own states
(``convert.to_async_state``, ``convert.to_dsaga_state``). Both packages
get the same data and the same draws (the reference's key splits,
replayed by ``repro_torch.convert``). The schedule functions are pure
numpy and must match the reference byte for byte.
"""
import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.config import ConvexConfig as JConvexConfig
from repro.core import convex as jconvex
from repro.core import distributed as jdistributed
from repro.core import fused as jfused
from repro.core import runtime as jruntime
from repro_torch import convert
from repro_torch.core import distributed, runtime
from repro_torch.core import fused as tfused

torch.set_num_threads(1)

# the reference's own convex-trajectory tolerance in float64
# (tests/test_fused_agreement.py)
CONVEX_TOL = 1e-10
KEY = jax.random.PRNGKey(7)
ROUNDS = 3
P = 2


def _close(have, want, tol=CONVEX_TOL):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=tol,
                               atol=tol)


def _sharded(p=P):
    cfg = JConvexConfig(problem="logistic", n=24, d=8, workers=p)
    sp = jdistributed.make_distributed(jax.random.PRNGKey(2), cfg)
    return sp, jconvex.auto_eta(sp.merged(), 0.3)


def _orders(algo, kw, sp):
    r = jax.random
    if algo == "centralvr_async":
        return convert.async_orders(r, KEY, sp.p, sp.ns, ROUNDS)
    if algo == "dsvrg":
        return convert.dsvrg_orders(r, KEY, sp.p, sp.ns, ROUNDS,
                                    kw.get("tau") or 0,
                                    kw.get("snapshot") or "last")
    return convert.dsaga_orders(r, KEY, sp.p, sp.ns, ROUNDS,
                                kw.get("tau") or 100)


def _cells():
    cells = []
    for prox in (None, "l1:0.01"):
        for fused in (False, True):
            for speeds in (None, (1.0, 2.5)):
                cells.append(("centralvr_async",
                              dict(fused=fused, prox=prox, speeds=speeds)))
                for fetch in ("instant", "stale"):
                    cells.append(("dsaga", dict(fused=fused, prox=prox,
                                                speeds=speeds, fetch=fetch,
                                                tau=5)))
            cells.append(("dsvrg", dict(fused=fused, prox=prox)))
        # avg and rand run unfused only
        for snapshot, tau in (("avg", None), ("rand", 7)):
            cells.append(("dsvrg", dict(prox=prox, snapshot=snapshot,
                                        tau=tau)))
    cells += [("dsvrg", dict(fused=True, tau=7)), ("dsvrg", dict(tau=7)),
              ("dsaga", dict()), ("dsaga", dict(fused="auto", tau=5)),
              ("centralvr_async", dict(fused="auto",
                                       prox="group_l2:0.01:4"))]
    return cells


@pytest.mark.parametrize("algo,kw", _cells(), ids=lambda v: (
    v if isinstance(v, str)
    else ",".join(f"{k}={x}" for k, x in v.items()) or "default"))
def test_distributed_matches_reference(algo, kw):
    sp, eta = _sharded()
    want = repro.solve(repro.RunSpec(algo, p=P, eta=eta, rounds=ROUNDS,
                                     **kw), sp, key=KEY)
    have = repro_torch.solve(
        repro_torch.RunSpec(algo, p=P, eta=eta, rounds=ROUNDS, **kw),
        convert.to_problem(sp, device="cpu"), device="cpu",
        orders=_orders(algo, kw, sp))
    _close(have.x, want.x)
    _close(have.rels, want.rels)
    assert have.rels.shape == (ROUNDS,) and have.grad_evals is None
    if algo == "dsvrg":
        _close(have.state, want.state)
    else:
        assert type(have.state).__name__ == type(want.state).__name__
        for h, w in zip(have.state, want.state):
            _close(h, w)
    assert have.launches == {"vr_update": 0, "vr_epoch": 0, "lazy_epoch": 0}
    assert have.device == "cpu"
    # the port counts float64's 8 bytes an element, the reference 4
    assert have.comms["bytes_per_round"] == 2 * want.comms["bytes_per_round"]
    assert have.comms["events_per_round"] == want.comms["events_per_round"]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("fetch", ["instant", "stale"])
def test_dsaga_literal_scaling_matches_reference(fetch, fused):
    sp, eta = _sharded()
    st_w, rels_w = jdistributed.run_dsaga(sp, eta=eta, rounds=ROUNDS,
                                          key=KEY, tau=5, fetch=fetch,
                                          literal_scaling=True, fused=fused)
    st_h, rels_h = distributed.run_dsaga(
        convert.to_problem(sp, device="cpu"), eta=eta, rounds=ROUNDS, tau=5,
        fetch=fetch, literal_scaling=True, fused=fused,
        orders=convert.dsaga_orders(jax.random, KEY, P, sp.ns, ROUNDS, 5))
    _close(rels_h, rels_w)
    for h, w in zip(st_h, st_w):
        _close(h, w)


@pytest.mark.parametrize("fused", [False, True])
def test_events_continue_the_reference_state(fused):
    """The reference's states in, one event of each kind on both sides:
    Algorithm 3 from ``async_init``, Algorithm 5 instant from
    ``dsaga_init`` after one reference event, stale from
    ``dsaga_init_stale`` after one."""
    sp, eta = _sharded()
    tsp = convert.to_problem(sp, device="cpu")
    jfp = jfused.make_params(fused, eta, sp.lam)
    tfp = tfused.make_params(fused, eta, float(sp.lam), "cpu")
    k1, k2, k3 = jax.random.split(KEY, 3)

    jst = jdistributed.async_init(sp, eta, k1)
    jst = jdistributed.async_event(sp, jst, 0, eta, k2, fused=jfp)
    want = jdistributed.async_event(sp, jst, 1, eta, k3, fused=jfp)
    have = distributed.async_event(
        tsp, convert.to_async_state(jst, device="cpu"), 1, eta,
        torch.from_numpy(np.array(jax.random.permutation(k3, sp.ns))),
        fused=tfp)
    assert isinstance(have, distributed.AsyncState)
    for h, w in zip(have, want):
        _close(h, w)

    idx = torch.from_numpy(np.array(jax.random.randint(k3, (5,), 0,
                                                       sp.ns)))
    for init, event, to_state in (
            (jdistributed.dsaga_init, "dsaga_event", convert.to_dsaga_state),
            (jdistributed.dsaga_init_stale, "dsaga_event_stale",
             convert.to_async_state)):
        jst = getattr(jdistributed, event)(sp, init(sp), 0, eta, 5, k2,
                                           fused=jfp)
        want = getattr(jdistributed, event)(sp, jst, 1, eta, 5, k3,
                                            fused=jfp)
        tst = to_state(jst, device="cpu")
        have = getattr(distributed, event)(tsp, tst, 1, eta, idx, fused=tfp)
        assert type(have).__name__ == type(want).__name__
        for h, w in zip(have, want):
            _close(h, w)
        # the event leaves the state it was given as it was
        for t, w in zip(tst, jst):
            _close(t, w, tol=0.0)


def test_async_runs_on_its_own_draws_and_checks_theirs():
    sp = convert.to_problem(_sharded()[0], device="cpu")
    a = distributed.run_async(sp, eta=0.1, rounds=2, seed=5,
                              speeds=(1.0, 3.0))
    b = distributed.run_async(sp, eta=0.1, rounds=2, seed=5,
                              speeds=(1.0, 3.0), fused=True)
    _close(a[1], b[1])
    _close(a[0].x_c, b[0].x_c)
    assert a[1].shape == (2,) and bool(torch.isfinite(a[1]).all())
    with pytest.raises(ValueError, match="per-event orders have shape"):
        distributed.run_async(sp, eta=0.1, rounds=2, orders=(
            np.zeros((P, sp.ns), np.int64), np.zeros((2, sp.ns), np.int64)))


# ---------------------------------------------------------------------------
# the event-schedule algebra, byte for byte
# ---------------------------------------------------------------------------

SCHEDULES = [(1, 3, None), (4, 5, None), (3, 6, (1.0, 2.0, 0.5)),
             (5, 4, (1.0, 1.0, 3.0, 0.7, 1.3)), (2, 7, (0.3, 0.3)),
             (8, 3, tuple(1.0 + 0.25 * s for s in range(8)))]


def _same(have, want):
    have, want = np.asarray(have), np.asarray(want)
    assert have.dtype == want.dtype and have.shape == want.shape
    assert have.tobytes() == want.tobytes()


@pytest.mark.parametrize("p,rounds,speeds", SCHEDULES)
def test_schedule_algebra_is_byte_identical(p, rounds, speeds):
    sched = runtime.event_schedule(p, rounds, speeds)
    _same(sched, jruntime.event_schedule(p, rounds, speeds))
    if speeds is not None:
        _same(runtime._event_schedule_loop(p, rounds, speeds),
              jruntime._event_schedule_loop(p, rounds, speeds))
        _same(runtime._event_schedule_loop(p, rounds, speeds), sched)
    for h, w in zip(runtime.wave_partition(sched, p),
                    jruntime.wave_partition(sched, p)):
        _same(h, w)
    active, rank, _ = runtime.wave_partition(sched, p)
    _same(runtime.wave_flatten(active, rank),
          jruntime.wave_flatten(active, rank))
    _same(runtime.wave_flatten(active, rank), sched)
    draws = np.arange(sched.size * 3).reshape(sched.size, 3)
    for h, w in zip(runtime.per_round(sched, draws, p),
                    jruntime.per_round(sched, draws, p)):
        _same(h, w)
    survivors = list(range(p))[::2] or [0]
    for h, w in zip(runtime.repartition_schedule(survivors, rounds, speeds),
                    jruntime.repartition_schedule(survivors, rounds,
                                                  speeds)):
        _same(h, w)


@pytest.mark.parametrize("call", [
    lambda rt: rt.event_schedule(3, 2, (1.0, 2.0)),
    lambda rt: rt.wave_partition(np.zeros(5, np.int32), 2),
    lambda rt: rt.repartition_schedule([], 2),
    lambda rt: rt.repartition_schedule([1, 1], 2),
])
def test_schedule_algebra_refuses_like_the_reference(call):
    with pytest.raises(ValueError) as want:
        call(jruntime)
    with pytest.raises(ValueError) as have:
        call(runtime)
    assert str(have.value) == str(want.value)
