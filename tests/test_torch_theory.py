"""The PyTorch port's Theorem 1 constants (``core/theory.py``), exact
solutions (``convex.solve_exact``), ``sample_grad``, ``x0=`` and
``track_iterates=`` against the JAX reference, and the port's own
versions of the paper's exact invariants (``tests/test_paper_invariants.py``)
and of Theorem 1's Lyapunov contraction (``tests/test_theory.py``), at
the sizes those files use.

Both packages get the same data (built by the reference, passed through
numpy) and the same draws (``jax.random``, replayed by
``repro_torch.convert``). The port's fused route runs the ``vr_epoch``
kernel's plain version on CPU tensors; the reference's runs its Pallas
kernel in interpret mode.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core import centralvr as jcentralvr
from repro.core import convex as jconvex
from repro.core import fused as jfused
from repro.core import theory as jtheory
from repro_torch import convert
from repro_torch.core import baselines, centralvr, convex, theory
from repro_torch.core import fused as tfused

torch.set_num_threads(1)

CONVEX_TOL = 1e-10


def _close(have, want, tol=CONVEX_TOL):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=tol,
                               atol=tol)


def _problem(seed=0, n=64, d=8, kind="logistic"):
    """The reference's problem, as test_paper_invariants draws it, and the
    port's copy."""
    gen = (jconvex.make_logistic_data if kind == "logistic"
           else jconvex.make_ridge_data)
    prob = gen(jax.random.PRNGKey(seed), n, d)
    return prob, convert.to_problem(prob, device="cpu")


def _perm(seed, n):
    return np.array(jax.random.permutation(jax.random.PRNGKey(seed), n))


# ---------------------------------------------------------------------------
# theory.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mu,L", [(0.1, 2.0), (1e-3, 10.0), (0.5, 0.6)])
def test_theory_matches_the_reference(mu, L):
    assert theory.max_step(mu, L) == jtheory.max_step(mu, L)
    for eta in (0.5 * theory.max_step(mu, L), 0.99 * theory.max_step(mu, L),
                0.3 / L, 0.499 / L, 0.5 / L, 2.0 / L):
        assert theory.alpha(eta, mu, L) == jtheory.alpha(eta, mu, L)
        for n in (1, 80, 5000):
            assert (theory.lyapunov_c(eta, n, L)
                    == jtheory.lyapunov_c(eta, n, L))
            assert (theory.lyapunov(0.3, 0.02, eta, n, L)
                    == jtheory.lyapunov(0.3, 0.02, eta, n, L))
    assert theory.alpha(1.0 / L, mu, L) == math.inf
    for eps, a in ((1e-6, 0.9), (1e-3, 0.5), (0.1, 0.999)):
        assert theory.epochs_to_eps(eps, a) == jtheory.epochs_to_eps(eps, a)


def test_theory_is_exported_like_the_reference():
    import repro.core
    import repro_torch.core
    for name in ("baselines", "centralvr", "convex", "distributed",
                 "host_loop", "runtime", "theory"):
        assert hasattr(repro.core, name)
        assert hasattr(repro_torch.core, name)


# ---------------------------------------------------------------------------
# solve_exact, sample_grad
# ---------------------------------------------------------------------------

def _robust(kind, delta=1.0):
    prob = jconvex.make_huber_data(jax.random.PRNGKey(4), 64, 5, lam=1e-3,
                                   delta=delta, kind=kind)
    return prob, convert.to_problem(prob, device="cpu")


@pytest.mark.parametrize("case", ["ridge", "logistic", "huber", "huber@0.5",
                                  "pseudo_huber"])
def test_solve_exact_matches_the_reference(case):
    if case in ("ridge", "logistic"):
        jp, tp = _problem(3, n=64, d=6, kind=case)
    else:
        kind, _, delta = case.partition("@")
        jp, tp = _robust(kind, float(delta) if delta else 1.0)
    want = jconvex.solve_exact(jp)
    have = convex.solve_exact(tp)
    _close(have, want)
    # the stationary point of the loss
    assert float(torch.linalg.norm(convex.full_grad(tp, have))) < 1e-9


@pytest.mark.parametrize("kind", ["logistic", "ridge"])
def test_sample_grad_matches_the_reference(kind):
    jp, tp = _problem(2, n=20, d=5, kind=kind)
    x = np.random.default_rng(0).standard_normal(5)
    for i in (0, 7, 19):
        _close(convex.sample_grad(tp, torch.from_numpy(x), i),
               jconvex.sample_grad(jp, jnp.asarray(x), i), 1e-12)


# ---------------------------------------------------------------------------
# x0= and track_iterates=
# ---------------------------------------------------------------------------

def _fused_params(fused, eta, prob):
    return tfused.make_params(fused, eta, prob.lam, "cpu")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("sampling", ["permutation", "uniform"])
def test_tracked_epochs_from_x0_match_the_reference(sampling, fused):
    jp, tp = _problem(5, n=48, d=6)
    eta = jconvex.auto_eta(jp, 0.3)
    x0 = 0.2 * np.random.default_rng(3).standard_normal(jp.d)
    key = jax.random.PRNGKey(11)
    jst = jcentralvr.init_state(jp, eta, key, x0=jnp.asarray(x0))
    init = np.array(jax.random.permutation(key, jp.n))
    st = centralvr.init_state(tp, eta, torch.from_numpy(init),
                              x0=torch.from_numpy(x0))
    for h, w in zip(st, jst):
        _close(h, w)
    jfp = jfused.make_params(fused, eta, jp.lam)
    fp = _fused_params(fused, eta, tp)
    for e, k in enumerate(jax.random.split(jax.random.PRNGKey(12), 2)):
        if sampling == "permutation":
            order = jax.random.permutation(k, jp.n)
            jst, jtraj = jcentralvr.epoch(jp, jst, eta, order,
                                          track_iterates=True, fused=jfp)
            st, traj = centralvr.epoch(tp, st, eta,
                                       torch.from_numpy(np.array(order)),
                                       track_iterates=True, fused=fp)
        else:
            idx = jax.random.randint(k, (jp.n,), 0, jp.n)
            jst, jtraj = jcentralvr.epoch_uniform(jp, jst, eta, k,
                                                  track_iterates=True,
                                                  fused=jfp)
            st, traj = centralvr.epoch_uniform(
                tp, st, eta, torch.from_numpy(np.array(idx)),
                track_iterates=True, fused=fp)
        assert traj.shape == (jp.n, jp.d)
        _close(traj, jtraj)
        for h, w in zip(st, jst):
            _close(h, w)
    # the flag off: (state, None), as the reference returns; not passed:
    # the state alone, as before
    out = centralvr.epoch(tp, st, eta, torch.arange(jp.n),
                          track_iterates=False, fused=fp)
    assert out[1] is None and isinstance(out[0], centralvr.VRState)
    assert isinstance(centralvr.epoch(tp, st, eta, torch.arange(jp.n),
                                      fused=fp), centralvr.VRState)


@pytest.mark.parametrize("fused", [False, True])
def test_run_from_x0_matches_the_reference(fused):
    jp, tp = _problem(6, n=40, d=5, kind="ridge")
    eta = jconvex.auto_eta(jp, 0.3)
    x0 = np.full(jp.d, 0.3)
    key = jax.random.PRNGKey(4)
    jst, jrels, _ = jcentralvr.run(jp, eta=eta, epochs=3, key=key,
                                   x0=jnp.asarray(x0), fused=fused)
    st, rels, _ = centralvr.run(
        tp, eta=eta, epochs=3, x0=torch.from_numpy(x0), fused=fused,
        orders=convert.centralvr_orders(jax.random, key, jp.n, 3))
    _close(st.x, jst.x)
    _close(rels, jrels)


@pytest.mark.parametrize("fused", [False, True])
def test_trajectory_is_the_iterate_before_each_step(fused):
    """traj[t] is the iterate after the first t steps of the epoch, bit
    for bit, on the unfused body and on the fused route (on CPU tensors
    vr_epoch's plain version)."""
    _, tp = _problem(8, n=30, d=4)
    eta = convex.auto_eta(tp, 0.3)
    fp = _fused_params(fused, eta, tp)
    st = centralvr.init_state(tp, eta, torch.from_numpy(_perm(1, 30)),
                              fused=fp)
    order = torch.from_numpy(_perm(2, 30))
    new, traj = centralvr.epoch(tp, st, eta, order, track_iterates=True,
                                fused=fp)
    assert torch.equal(traj[0], st.x)
    for t in (1, 7, 29):
        part = centralvr.epoch(tp, st, eta, order[:t], fused=fp)
        assert torch.equal(traj[t], part.x)
    assert torch.equal(centralvr.epoch(tp, st, eta, order, fused=fp).x,
                       new.x)


# ---------------------------------------------------------------------------
# the paper's invariants, on the port (tests/test_paper_invariants.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["logistic", "ridge"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_corrected_gradient_unbiased(seed, kind):
    """mean_i [ (s_i(x) - table_i) a_i + gbar + 2 lam x ] == grad f(x)
    for ANY stored table (Eq. 6)."""
    _, prob = _problem(seed, n=32, d=6, kind=kind)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal(prob.d))
    table = torch.from_numpy(rng.standard_normal(prob.n))
    gbar = convex.data_grad_from_scalars(prob, table)
    s_fresh = convex.scalar_residual_all(prob, x)
    corrected = ((s_fresh - table)[:, None] * prob.A + gbar
                 + 2.0 * prob.lam * x)
    np.testing.assert_allclose(corrected.mean(0).numpy(),
                               convex.full_grad(prob, x).numpy(),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["logistic", "ridge"])
def test_eq7_telescoping(kind, fused):
    """Eq. 7: x_{m+2}^0 = x_{m+1}^0 - eta * sum_j grad f_j(xtilde_{m+1}^j),
    xtilde^j the iterate at which index j was visited."""
    _, prob = _problem(3, n=40, d=5, kind=kind)
    eta = 0.01
    fp = _fused_params(fused, eta, prob)
    state = centralvr.init_state(prob, eta, torch.from_numpy(_perm(7, 40)),
                                 fused=fp)
    perm = torch.from_numpy(_perm(8, 40))
    new_state, traj = centralvr.epoch(prob, state, eta, perm,
                                      track_iterates=True, fused=fp)
    grads = torch.stack([convex.sample_grad(prob, xk, int(i))
                         for i, xk in zip(perm, traj)])
    expected = state.x - eta * grads.sum(0)
    np.testing.assert_allclose(new_state.x.numpy(), expected.numpy(),
                               rtol=1e-8, atol=1e-10)


def test_accumulator_equals_table_mean():
    """line 11: gbar for the next epoch == (1/n) sum_j s_j a_j."""
    _, prob = _problem(5, n=48, d=6)
    state = centralvr.init_state(prob, 0.02, torch.from_numpy(_perm(0, 48)))
    new_state = centralvr.epoch(prob, state, 0.02,
                                torch.from_numpy(_perm(1, 48)))
    for st in (new_state, state):
        np.testing.assert_allclose(
            st.gbar.numpy(),
            convex.data_grad_from_scalars(prob, st.table).numpy(),
            rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("kind", ["logistic", "ridge"])
def test_constant_step_linear_convergence(kind):
    """VR: a constant step converges to x* with a geometric decrease."""
    jp, prob = _problem(11, n=200, d=10, kind=kind)
    eta = 0.05 if kind == "logistic" else 0.004
    _, rels, _ = centralvr.run(
        prob, eta=eta, epochs=40,
        orders=convert.centralvr_orders(jax.random, jax.random.PRNGKey(2),
                                        200, 40))
    r = rels.numpy()
    assert r[-1] < 1e-9, f"no linear convergence: {r[-5:]}"
    above = r[r > 1e-10]
    assert np.median(above[1:] / above[:-1]) < 0.9


def test_centralvr_beats_sgd_equal_gradient_budget():
    """Fig. 1: at the same gradient budget CentralVR reaches a far lower
    gradient norm than tuned constant-step SGD."""
    jp, prob = _problem(13, n=300, d=12)
    epochs = 20
    key = jax.random.PRNGKey(3)
    _, rels_cvr, _ = centralvr.run(
        prob, eta=0.05, epochs=epochs,
        orders=convert.centralvr_orders(jax.random, key, 300, epochs))
    best_sgd = np.inf
    for eta in (0.2, 0.05, 0.01):
        _, rels = baselines.run_sgd(
            prob, eta=eta, epochs=epochs,
            orders=convert.sgd_orders(jax.random, key, 300, epochs))
        best_sgd = min(best_sgd, float(rels[-1]))
        _, jrels = jbaselines.run_sgd(jp, eta=eta, epochs=epochs, key=key)
        _close(rels, jrels)
    assert float(rels_cvr[-1]) < best_sgd * 1e-2


def test_gradient_evals_per_iteration_table1():
    """Table 1: one gradient an iteration, an epoch costs n evaluations."""
    _, prob = _problem(17, n=50, d=4)
    _, _, evals = centralvr.run(prob, eta=0.02, epochs=3)
    np.testing.assert_array_equal(evals, [100, 150, 200])
    # the sparse driver counts the same (it needs lam = 0)
    _, _, evals = centralvr.run(prob._replace(lam=0.0), eta=0.02, epochs=3,
                                sampling="sparse")
    np.testing.assert_array_equal(evals, [100, 150, 200])


# ---------------------------------------------------------------------------
# Theorem 1 (tests/test_theory.py)
# ---------------------------------------------------------------------------

def _well_conditioned_ridge(n=80, d=6, lam=0.05, seed=0):
    prob = jconvex.make_ridge_data(jax.random.PRNGKey(seed), n, d, lam)
    A = prob.A / jnp.linalg.norm(prob.A, axis=1, keepdims=True)
    return convert.to_problem(jconvex.Problem(A, prob.b, prob.lam, "ridge"),
                              device="cpu")


def test_alpha_and_step_bound_consistency():
    mu, L = 0.1, 2.0
    a = theory.alpha(theory.max_step(mu, L) * 0.99, mu, L)
    assert 0.0 < a < 1.0
    assert theory.alpha(0.499 / L, mu, L) > 1.0


def test_theorem1_lyapunov_contraction():
    """Uniform sampling inside the remark's step bound: the Lyapunov
    function V_m contracts at least at the guaranteed rate alpha (with
    slack for one sample path), measured with tracked epochs."""
    prob = _well_conditioned_ridge()
    mu, L = (float(v) for v in convex.constants(prob))
    eta = 0.5 * theory.max_step(mu, L)
    a = theory.alpha(eta, mu, L)
    assert 0.0 < a < 1.0
    xstar = convex.solve_exact(prob)
    fstar = float(convex.full_loss(prob, xstar))
    c = theory.lyapunov_c(eta, prob.n, L)
    init = np.array(jax.random.permutation(
        jax.random.split(jax.random.PRNGKey(1))[0], prob.n))
    state = centralvr.init_state(prob, eta, torch.from_numpy(init))
    Vs = []
    for k in jax.random.split(jax.random.PRNGKey(2), 60):
        idx = torch.from_numpy(np.array(jax.random.randint(
            k, (prob.n,), 0, prob.n)))
        new_state, traj = centralvr.epoch_uniform(prob, state, eta, idx,
                                                  track_iterates=True)
        fbar = float(torch.stack([convex.full_loss(prob, x)
                                  for x in traj]).mean())
        V = theory.lyapunov(float(torch.sum((traj[0] - xstar) ** 2)),
                            fbar - fstar, eta, prob.n, L)
        Vs.append(max(V, 1e-300))
        state = new_state
    log_rate = (np.log(Vs[-1]) - np.log(Vs[0])) / (len(Vs) - 1)
    assert log_rate < np.log(a) + 0.05, (
        f"measured rate {np.exp(log_rate):.4f} vs guaranteed alpha {a:.4f}")
    assert Vs[-1] < Vs[0] * 1e-3


def test_divergence_outside_any_reasonable_step():
    prob = _well_conditioned_ridge(seed=3)
    _, L = convex.constants(prob)
    eta = 5.0 / float(L)
    gen = torch.Generator().manual_seed(0)
    state = centralvr.init_state(prob, eta, torch.randperm(prob.n,
                                                           generator=gen))
    for _ in range(10):
        state = centralvr.epoch_uniform(
            prob, state, eta, torch.randint(0, prob.n, (prob.n,),
                                            generator=gen))
    assert (not bool(torch.isfinite(state.x).all())
            or float(torch.linalg.norm(convex.full_grad(prob, state.x)))
            > 1e2)
