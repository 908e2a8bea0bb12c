"""Convex substrate and prox operators of the PyTorch port against the
JAX reference, on the same seeded numpy inputs, at 1e-12 in float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convex as jconvex
from repro.prox import operators as jprox
from repro_torch import convert
from repro_torch.config import ConvexConfig
from repro_torch.core import convex
from repro_torch.prox import operators as proxops

torch.set_num_threads(1)

TOL = 1e-12
KINDS = ["logistic", "ridge", "huber", "huber@0.5", "pseudo_huber",
         "pseudo_huber@2"]
PROXES = ["l1:0.05", "elasticnet:0.05:0.3", "box:-0.2:0.3",
          "group_l2:0.2:3"]


def _close(have, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=tol,
                               atol=tol)


def _problems(kind, n=24, d=6, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d))
    if kind == "logistic":
        b = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    else:
        b = A @ rng.standard_normal(d) + 2.0 * rng.standard_normal(n)
    ref = jconvex.Problem(jnp.asarray(A), jnp.asarray(b), jnp.float32(1e-3),
                          kind)
    return ref, convert.to_problem(ref, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_losses_gradients_and_constants(kind):
    ref, prob = _problems(kind)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(prob.d)
    s = rng.standard_normal(prob.n)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    z = ref.A @ jx
    _close(convex._pointwise_loss(prob.A @ tx, prob.b, kind),
           jconvex._pointwise_loss(z, ref.b, kind))
    _close(convex._pointwise_residual(prob.A @ tx, prob.b, kind),
           jconvex._pointwise_residual(z, ref.b, kind))
    _close(convex.full_loss(prob, tx), jconvex.full_loss(ref, jx))
    _close(convex.full_grad(prob, tx), jconvex.full_grad(ref, jx))
    _close(convex.scalar_residual(prob, tx, 5),
           jconvex.scalar_residual(ref, jx, 5))
    _close(convex.scalar_residual(prob, tx, torch.tensor([3, 1, 3])),
           jconvex.scalar_residual(ref, jx, jnp.array([3, 1, 3])))
    _close(convex.scalar_residual_all(prob, tx),
           jconvex.scalar_residual_all(ref, jx))
    _close(convex.data_grad_from_scalars(prob, torch.from_numpy(s)),
           jconvex.data_grad_from_scalars(ref, jnp.asarray(s)))
    for have, want in zip(convex.constants(prob), jconvex.constants(ref)):
        _close(float(have), float(want))
    assert convex.auto_eta(prob) == pytest.approx(jconvex.auto_eta(ref),
                                                  rel=TOL)
    assert convex.loss_params(kind) == jconvex.loss_params(kind)


@pytest.mark.parametrize("prox", [None] + PROXES)
def test_rel_grad_norm_and_normalizer(prox):
    ref, prob = _problems("logistic")
    x = np.random.default_rng(2).standard_normal(prob.d)
    jp = jprox.parse(prox) if prox else None
    tp = proxops.parse(prox) if prox else None
    _close(convex.grad_norm0(prob, prox=tp, eta=0.4),
           jconvex.grad_norm0(ref, prox=jp, eta=0.4))
    g0 = convex.grad_norm0(prob, prox=tp, eta=0.4)
    _close(convex.rel_grad_norm(prob, torch.from_numpy(x), g0, prox=tp,
                                eta=0.4),
           jconvex.rel_grad_norm(ref, jnp.asarray(x),
                                 jconvex.grad_norm0(ref, prox=jp, eta=0.4),
                                 prox=jp, eta=0.4))


def test_normalizer_falls_back_to_one_at_a_fixed_point():
    """A threshold eta*lam1 above every coordinate of eta*grad f(0) makes
    x0 = 0 an exact prox-gradient fixed point."""
    ref, prob = _problems("logistic")
    want = jconvex.grad_norm0(ref, prox=jprox.parse("l1:100"), eta=0.4)
    have = convex.grad_norm0(prob, prox=proxops.parse("l1:100"), eta=0.4)
    assert float(want) == float(have) == 1.0


@pytest.mark.parametrize("spec", PROXES)
def test_prox_operators_match(spec):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 12)) * 0.4
    for eta in (0.0, 0.5, 2.0):
        _close(proxops.apply(spec, torch.from_numpy(w), eta),
               jprox.apply(spec, jnp.asarray(w), eta))
        _close(proxops.grad_map(spec, torch.from_numpy(w[0]),
                                torch.from_numpy(w[1]), eta),
               jprox.grad_map(spec, jnp.asarray(w[0]), jnp.asarray(w[1]),
                              eta))
    for v in (w[0], np.clip(w[0], -0.2, 0.3)):
        _close(proxops.penalty(spec, torch.from_numpy(v)),
               jprox.penalty(spec, jnp.asarray(v)))
    assert proxops.parse(spec) == tuple(jprox.parse(spec))
    assert proxops.canonical(spec) == jprox.canonical(spec)
    assert proxops.is_elementwise(spec) == jprox.is_elementwise(spec)


def test_group_l2_closed_form_at_an_underflowing_group_norm():
    """The input of the reference's recorded numeric-oracle failure: the
    group norm is far below eta*lam1, so the true prox is zero."""
    u = np.zeros(4)
    u[-1] = 2.38e-201
    have = proxops.apply("group_l2:0.1:4", torch.from_numpy(u), 1.0)
    want = jprox.apply("group_l2:0.1:4", jnp.asarray(u), 1.0)
    assert not have.any() and not np.asarray(want).any()


@pytest.mark.parametrize("bad", ["nope:1", "l1:1:2", "l1:x", "box:1:-1",
                                 "group_l2:0.1:2.5", "elasticnet:-1",
                                 "elasticnet:0.1:-1", "group_l2:0.1:0"])
def test_prox_parse_errors_match(bad):
    with pytest.raises(ValueError) as want:
        jprox.parse(bad)
    with pytest.raises(ValueError) as have:
        proxops.parse(bad)
    assert str(have.value) == str(want.value)


def test_none_prox_is_identity():
    w = torch.arange(4.0, dtype=torch.float64)
    assert proxops.apply_prox(None, w, 0.3) is w
    torch.testing.assert_close(proxops.grad_map(None, w, w, 0.5), 0.5 * w)
    assert float(proxops.penalty(None, w)) == 0.0


@pytest.mark.parametrize("problem", ["logistic", "ridge", "huber",
                                     "pseudo_huber"])
def test_make_problem_draws_from_a_generator(problem):
    cfg = ConvexConfig(problem=problem, n=10, d=3, lam=1e-4,
                       outlier_frac=0.2)
    p1 = convex.make_problem(torch.Generator().manual_seed(5), cfg)
    p2 = convex.make_problem(torch.Generator().manual_seed(5), cfg)
    assert p1.A.shape == (10, 3) and p1.b.shape == (10,)
    assert p1.A.dtype == torch.float64 and p1.kind == problem
    assert p1.lam == float(np.float32(1e-4))
    torch.testing.assert_close(p1.A, p2.A, rtol=0, atol=0)
    torch.testing.assert_close(p1.b, p2.b, rtol=0, atol=0)
    if problem == "logistic":
        assert set(p1.b.tolist()) <= {-1.0, 1.0}
