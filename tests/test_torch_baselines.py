"""The PyTorch port's baselines against the JAX reference: the Fig. 1
single-worker algorithms (``sgd``, ``svrg``, ``saga``) and the
distributed ones (``dist_sgd``, ``easgd``, ``ps_svrg``), through
``repro_torch.solve`` against ``repro.solve``, on every fused × prox ×
snapshot cell the reference accepts with backend="vmap"; and the fused
SAGA and SVRG inner loops (``fused.saga_steps``, ``fused.svrg_steps``)
against the unfused bodies and against the reference's.

Both packages get the same data (built by the reference, passed through
numpy) and the same draws (the reference's ``jax.random`` key splits,
replayed by ``repro_torch.convert``). The reference's fused runs execute
its Pallas kernel in interpret mode; the port's go through its kernel
wrapper, which runs the kernel's plain version on CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.config import ConvexConfig as JConvexConfig
from repro.core import convex as jconvex
from repro.core import distributed as jdistributed
from repro.core import fused as jfused
from repro_torch import convert
from repro_torch.core import baselines, distributed
from repro_torch.core import fused as tfused

torch.set_num_threads(1)

# the reference's own convex-trajectory tolerance in float64
# (tests/test_fused_agreement.py)
CONVEX_TOL = 1e-10
KEY = jax.random.PRNGKey(7)
ROUNDS = 3


def _close(have, want, tol=CONVEX_TOL):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=tol,
                               atol=tol)


def _single():
    prob = jconvex.make_logistic_data(jax.random.PRNGKey(2), 48, 8)
    return prob, jconvex.auto_eta(prob, 0.3)


def _sharded(p=2):
    cfg = JConvexConfig(problem="logistic", n=24, d=8, workers=p)
    sp = jdistributed.make_distributed(jax.random.PRNGKey(2), cfg)
    return sp, jconvex.auto_eta(sp.merged(), 0.3)


def _orders(algo, kw, prob):
    """The reference's draws of one run, in the port's layout."""
    r = jax.random
    tau = kw.get("tau") or 0
    if algo == "sgd":
        return convert.sgd_orders(r, KEY, prob.n, ROUNDS)
    if algo == "svrg":
        return convert.svrg_orders(r, KEY, prob.n, ROUNDS, tau,
                                   kw.get("snapshot") or "last")
    if algo == "saga":
        return convert.saga_orders(r, KEY, prob.n, ROUNDS)
    if algo == "dist_sgd":
        return convert.dist_sgd_orders(r, KEY, prob.p, prob.ns, ROUNDS, tau)
    if algo == "easgd":
        return convert.easgd_orders(r, KEY, prob.p, prob.ns, ROUNDS,
                                    tau or 16)
    return convert.ps_svrg_orders(r, KEY, prob.p, prob.ns, ROUNDS)


def _cells():
    cells = [("sgd", {}), ("sgd", dict(decay=0.5))]
    for prox in (None, "l1:0.01"):
        for fused in (False, True):
            cells.append(("svrg", dict(fused=fused, prox=prox)))
            cells.append(("saga", dict(fused=fused, prox=prox)))
        # avg and rand run unfused only
        for snapshot, tau in (("avg", None), ("rand", 30)):
            cells.append(("svrg", dict(prox=prox, snapshot=snapshot,
                                       tau=tau)))
    cells += [("svrg", dict(fused=True, snapshot="last", tau=30)),
              ("svrg", dict(fused="auto")), ("saga", dict(fused="auto")),
              ("dist_sgd", dict(p=2)), ("dist_sgd", dict(p=2, tau=5,
                                                         decay=0.3)),
              ("easgd", dict(p=2)), ("easgd", dict(p=2, tau=5, decay=0.1)),
              ("ps_svrg", dict(p=2))]
    return cells


@pytest.mark.parametrize("algo,kw", _cells(), ids=lambda v: (
    v if isinstance(v, str)
    else ",".join(f"{k}={x}" for k, x in v.items()) or "default"))
def test_baseline_matches_reference(algo, kw):
    prob, eta = _sharded() if kw.get("p", 1) > 1 else _single()
    want = repro.solve(repro.RunSpec(algo, eta=eta, rounds=ROUNDS, **kw),
                       prob, key=KEY)
    have = repro_torch.solve(
        repro_torch.RunSpec(algo, eta=eta, rounds=ROUNDS, **kw),
        convert.to_problem(prob, device="cpu"), device="cpu",
        orders=_orders(algo, kw, prob))
    _close(have.x, want.x)
    _close(have.rels, want.rels)
    assert have.rels.shape == (ROUNDS,)
    assert have.grad_evals is None and want.grad_evals is None
    assert have.launches == {"vr_update": 0, "vr_epoch": 0, "lazy_epoch": 0}
    assert have.device == "cpu"
    assert have.comms["n_allreduce_per_round"] == \
        want.comms["n_allreduce_per_round"]


def test_drivers_draw_their_own_orders_from_the_seed():
    """Without orders, each driver draws from a torch.Generator seeded with
    ``seed``: two runs agree exactly, fused == unfused on the same seed,
    and a third seed differs."""
    prob = convert.to_problem(_single()[0], device="cpu")
    a = baselines.run_saga(prob, eta=0.1, epochs=2, seed=3)
    b = baselines.run_saga(prob, eta=0.1, epochs=2, seed=3, fused=True)
    c = baselines.run_saga(prob, eta=0.1, epochs=2, seed=4)
    _close(a[0], b[0])
    assert not torch.equal(a[0], c[0])
    x1, r1 = baselines.run_svrg(prob, eta=0.1, epochs=2, seed=3,
                                snapshot="rand")
    x2, r2 = baselines.run_svrg(prob, eta=0.1, epochs=2, seed=3,
                                snapshot="rand")
    assert torch.equal(x1, x2) and torch.equal(r1, r2)
    assert bool(torch.isfinite(r1).all()) and r1[-1] < r1[0]


def test_explicit_draws_are_shape_checked():
    sp = convert.to_problem(_sharded()[0], device="cpu")
    with pytest.raises(ValueError, match="sample indices have shape"):
        baselines.run_easgd(sp, eta=0.1, rounds=2, tau=5,
                            orders=np.zeros((2, 2, 5), np.int64))
    with pytest.raises(ValueError, match="anchor indices"):
        baselines.run_svrg(sp.merged(), eta=0.1, epochs=2, snapshot="rand",
                           orders=(np.zeros((2, 48), np.int64), None))


# ---------------------------------------------------------------------------
# the fused SAGA and SVRG inner loops
# ---------------------------------------------------------------------------

def _loop_inputs(p, n=16, d=8, T=24, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, n, d))
    b = np.where(rng.random((p, n)) < 0.5, -1.0, 1.0)
    x = 0.1 * rng.standard_normal((p, d))
    table = 0.3 * rng.standard_normal((p, n))
    gbar = 0.1 * rng.standard_normal((p, d))
    idx = rng.integers(0, n, (p, T))
    return A, b, x, table, gbar, idx


@pytest.mark.parametrize("prox", [None, "l1:0.01"])
@pytest.mark.parametrize("p", [1, 3])
def test_saga_steps_match_unfused_body_and_reference(p, prox):
    A, b, x, table, gbar, idx = _loop_inputs(p)
    t = [torch.from_numpy(v) for v in (A, b, x, table, gbar, idx)]
    eta, lam, n_global = 0.05, float(np.float32(1e-3)), 16 * p
    fp = tfused.make_params(True, eta, lam, "cpu", prox=prox)
    have = tfused.saga_steps(t[0], t[1], "logistic", t[2], t[3], t[4],
                             n_global, t[5], fp)
    from repro_torch.prox import operators as proxops
    want = distributed._local_saga_steps(
        t[0], t[1], lam, "logistic", t[2], t[3], t[4], eta, n_global, t[5],
        prox=proxops.parse(prox) if prox else None)
    for h, w in zip(have, want):
        _close(h, w)
    jfp = jfused.make_params(True, eta, lam, prox=prox)
    for w in range(p):
        ref = jfused.saga_steps(jnp.asarray(A[w]), jnp.asarray(b[w]),
                                "logistic", jnp.asarray(x[w]),
                                jnp.asarray(table[w]), jnp.asarray(gbar[w]),
                                n_global, jnp.asarray(idx[w]), jfp)
        for h, r in zip(have, ref):
            _close(h[w], r)
    _close(t[2], x)           # inputs left as they were
    _close(t[3], table)


@pytest.mark.parametrize("prox", [None, "l1:0.01"])
@pytest.mark.parametrize("p", [1, 3])
def test_svrg_steps_match_unfused_body_and_reference(p, prox):
    A, b, x, _, _, idx = _loop_inputs(p, seed=1)
    xbar = x[0]
    tA, tb, tidx = (torch.from_numpy(v) for v in (A, b, idx))
    txbar = torch.from_numpy(xbar)
    eta, lam = 0.05, float(np.float32(1e-3))
    # the full regularized gradient at the snapshot over all p shards
    merged = distributed.ShardedProblem(tA, tb, lam, "logistic").merged()
    from repro_torch.core import convex
    gbar = convex.full_grad(merged, txbar)
    fp = tfused.make_params(True, eta, lam, "cpu", prox=prox)
    sbar = convex._pointwise_residual(tA @ txbar, tb, "logistic")
    have = tfused.svrg_steps(tA, tb, "logistic", txbar.expand(p, -1), sbar,
                             gbar, tidx, fp)
    from repro_torch.prox import operators as proxops
    want = distributed._svrg_anchors(
        tA, tb, lam, "logistic", txbar, gbar, eta, tidx,
        prox=proxops.parse(prox) if prox else None)
    _close(have, want)
    jfp = jfused.make_params(True, eta, lam, prox=prox)
    for w in range(p):
        ref = jfused.svrg_steps(jnp.asarray(A[w]), jnp.asarray(b[w]),
                                "logistic", jnp.asarray(xbar),
                                jnp.asarray(sbar[w].numpy()),
                                jnp.asarray(gbar.numpy()),
                                jnp.asarray(idx[w]), jfp)
        _close(have[w], ref)
