"""The PyTorch port's per-round host drivers (``core/host_loop.py``)
against the JAX reference's (``repro/core/host_loop.py``) and against the
port's own drivers, which they pin, at 1e-10 in float64.

Both packages get the same data (built by the reference, passed through
numpy) and the same draws: the reference's host loops split their keys as
its drivers do, so ``repro_torch.convert``'s ``*_orders`` replay them.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import ConvexConfig
from repro.core import convex as jconvex
from repro.core import distributed as jdistributed
from repro.core import host_loop as jhost
from repro_torch import convert
from repro_torch.core import centralvr, distributed, host_loop

torch.set_num_threads(1)

CONVEX_TOL = 1e-10
KEY = jax.random.PRNGKey(3)
ROUNDS = 4


def _close(have, want, tol=CONVEX_TOL):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=tol,
                               atol=tol)


def _single(kind):
    gen = (jconvex.make_logistic_data if kind == "logistic"
           else jconvex.make_ridge_data)
    prob = gen(jax.random.PRNGKey(0), 96, 9)
    return prob, convert.to_problem(prob, device="cpu"), jconvex.auto_eta(
        prob, 0.3)


def _sharded(kind, p=4):
    cfg = ConvexConfig(problem=kind, n=64, d=9, workers=p)
    sp = jdistributed.make_distributed(jax.random.PRNGKey(0), cfg)
    return sp, convert.to_problem(sp, device="cpu"), jconvex.auto_eta(
        sp.merged(), 0.3)


def _run(jp, tp, eta, sampling):
    orders = convert.centralvr_orders(jax.random, KEY, jp.n, ROUNDS,
                                      sampling)
    want = jhost.run(jp, eta=eta, epochs=ROUNDS, key=KEY, sampling=sampling)
    have = host_loop.run(tp, eta=eta, epochs=ROUNDS, orders=orders,
                         sampling=sampling)
    own = centralvr.run(tp, eta=eta, epochs=ROUNDS, orders=orders,
                        sampling=sampling)
    np.testing.assert_array_equal(have[2], np.asarray(want[2]))
    np.testing.assert_array_equal(have[2], own[2])
    return have[0].x, have[1], want[0].x, want[1], own[0].x, own[1]


def _sync(jp, tp, eta, _):
    orders = convert.sync_orders(jax.random, KEY, jp.p, jp.ns, ROUNDS)
    want = jhost.run_sync(jp, eta=eta, rounds=ROUNDS, key=KEY)
    have = host_loop.run_sync(tp, eta=eta, rounds=ROUNDS, orders=orders)
    own = distributed.run_sync(tp, eta=eta, rounds=ROUNDS, orders=orders)
    return have[0].x, have[1], want[0].x, want[1], own[0].x, own[1]


def _async(jp, tp, eta, speeds):
    orders = convert.async_orders(jax.random, KEY, jp.p, jp.ns, ROUNDS)
    want = jhost.run_async(jp, eta=eta, rounds=ROUNDS, key=KEY,
                           speeds=speeds)
    have = host_loop.run_async(tp, eta=eta, rounds=ROUNDS, orders=orders,
                               speeds=speeds)
    own = distributed.run_async(tp, eta=eta, rounds=ROUNDS, orders=orders,
                                speeds=speeds)
    return have[0].x_c, have[1], want[0].x_c, want[1], own[0].x_c, own[1]


def _dsvrg(jp, tp, eta, _):
    orders = convert.dsvrg_orders(jax.random, KEY, jp.p, jp.ns, ROUNDS)
    want = jhost.run_dsvrg(jp, eta=eta, rounds=ROUNDS, key=KEY)
    have = host_loop.run_dsvrg(tp, eta=eta, rounds=ROUNDS, orders=orders)
    own = distributed.run_dsvrg(tp, eta=eta, rounds=ROUNDS, orders=orders)
    return have[0], have[1], want[0], want[1], own[0], own[1]


def _dsaga(jp, tp, eta, literal):
    orders = convert.dsaga_orders(jax.random, KEY, jp.p, jp.ns, ROUNDS,
                                  tau=20)
    want = jhost.run_dsaga(jp, eta=eta, rounds=ROUNDS, key=KEY, tau=20,
                           literal_scaling=literal)
    have = host_loop.run_dsaga(tp, eta=eta, rounds=ROUNDS, orders=orders,
                               tau=20, literal_scaling=literal)
    own = distributed.run_dsaga(tp, eta=eta, rounds=ROUNDS, orders=orders,
                                tau=20, literal_scaling=literal)
    return have[0].x_c, have[1], want[0].x_c, want[1], own[0].x_c, own[1]


CASES = {
    "run permutation": (_run, False, "permutation"),
    "run uniform": (_run, False, "uniform"),
    "run_sync": (_sync, True, None),
    "run_async round-robin": (_async, True, None),
    "run_async speeds": (_async, True, (1.0, 2.0, 1.0, 3.0)),
    "run_dsvrg": (_dsvrg, True, None),
    "run_dsaga": (_dsaga, True, False),
    "run_dsaga literal scaling": (_dsaga, True, True),
}


@pytest.mark.parametrize("kind", ["logistic", "ridge"])
@pytest.mark.parametrize("case", list(CASES))
def test_host_driver_matches_the_reference_and_the_driver(case, kind):
    fn, sharded, arg = CASES[case]
    jp, tp, eta = (_sharded if sharded else _single)(kind)
    x, rels, jx, jrels, ox, orels = fn(jp, tp, eta, arg)
    assert rels.shape == (ROUNDS,) and rels.dtype == torch.float64
    assert np.isfinite(rels.numpy()).all()
    _close(x, jx)
    _close(rels, jrels)
    _close(x, ox)
    _close(rels, orels)


def test_host_drivers_draw_their_own_orders_from_the_seed():
    _, tp, eta = _sharded("logistic", p=2)
    a = host_loop.run_sync(tp, eta=eta, rounds=2, seed=5)
    b = host_loop.run_sync(tp, eta=eta, rounds=2, seed=5)
    own = distributed.run_sync(tp, eta=eta, rounds=2, seed=5)
    assert torch.equal(a[0].x, b[0].x)
    _close(a[0].x, own[0].x)
    _close(a[1], own[1])
    with pytest.raises(ValueError, match="per-round orders"):
        host_loop.run_sync(tp, eta=eta, rounds=2,
                           orders=(np.zeros((2, 64), np.int64),
                                   np.zeros((3, 2, 64), np.int64)))
