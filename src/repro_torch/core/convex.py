"""The paper's experimental substrate (§6): l2-regularized logistic and
ridge regression plus the robust losses (Huber, pseudo-Huber), in the GLM
scalar-residual form — the port of ``repro/core/convex.py``.

Every f_i has the form  f_i(x) = l(a_i^T x; b_i) + lam * ||x||^2, so

    grad f_i(x) = s_i(x) * a_i + 2*lam*x,     s_i(x) = l'(a_i^T x; b_i).

Variance reduction applies to the data term only; the regularizer's
gradient 2*lam*x is exact. The stored "gradient" for index i is the
scalar s_i.

Loss convention: ``log(1 + exp(-b a^T x))`` with b in {-1,+1}.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.vr_update import ref as vr_ref

# the convex path runs in float64 (the reference's tests enable x64)
DTYPE = torch.float64


class Problem(NamedTuple):
    """A finite-sum convex problem."""

    A: torch.Tensor       # (n, d) features
    b: torch.Tensor       # (n,) labels (+-1 for logistic, real otherwise)
    lam: float            # l2 coefficient, rounded to float32 as the
                          # reference stores it (``jnp.float32(lam)``)
    kind: str             # "logistic" | "ridge" | "huber[@delta]" |
                          # "pseudo_huber[@delta]"

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def d(self) -> int:
        return self.A.shape[1]


def as_lam(lam) -> float:
    """The l2 coefficient as the reference holds it: a float32 value."""
    return float(np.float32(lam))


# ---------------------------------------------------------------------------
# Data generators (paper §6.1), drawn from a torch.Generator
# ---------------------------------------------------------------------------

def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device=gen.device, dtype=DTYPE)


def _rand(gen, *shape):
    return torch.rand(*shape, generator=gen, device=gen.device, dtype=DTYPE)


def make_logistic_data(gen: torch.Generator, n: int, d: int,
                       lam: float = 1e-4, outliers: float = 0.0) -> Problem:
    """Two unit-variance normals with means separated by one unit;
    ``outliers`` flips that fraction of labels."""
    half = n // 2
    mu = torch.zeros(d, device=gen.device, dtype=DTYPE)
    mu[0] = 0.5
    A = torch.cat([_randn(gen, half, d) + mu, _randn(gen, n - half, d) - mu])
    b = torch.cat([torch.ones(half, device=gen.device, dtype=DTYPE),
                   -torch.ones(n - half, device=gen.device, dtype=DTYPE)])
    if outliers:
        b = torch.where(_rand(gen, n) < outliers, -b, b)
    return Problem(A, b, as_lam(lam), "logistic")


def make_ridge_data(gen: torch.Generator, n: int, d: int,
                    lam: float = 1e-4) -> Problem:
    """b = A x_true + eps, A and eps standard normal."""
    A = _randn(gen, n, d)
    x_true = _randn(gen, d)
    b = A @ x_true + _randn(gen, n)
    return Problem(A, b, as_lam(lam), "ridge")


def make_huber_data(gen: torch.Generator, n: int, d: int, lam: float = 1e-4,
                    delta: float = 1.0, outliers: float = 0.1,
                    kind: str = "huber") -> Problem:
    """Linear regression with ``outliers`` of the labels shifted by a
    10-sigma heavy tail; ``delta != 1`` is encoded as ``"huber@<delta>"``."""
    A = _randn(gen, n, d)
    x_true = _randn(gen, d)
    b = A @ x_true + _randn(gen, n)
    if outliers:
        mask = _rand(gen, n) < outliers
        b = torch.where(mask, b + 10.0 * _randn(gen, n), b)
    tag = kind if delta == 1.0 else f"{kind}@{delta:g}"
    return Problem(A, b, as_lam(lam), tag)


def loss_params(kind: str):
    """Split a kind string into (base, delta): ``"huber@0.5"`` ->
    ``("huber", 0.5)``; kinds without a ``@`` tag get delta = 1.0."""
    base, _, tail = kind.partition("@")
    return base, (float(tail) if tail else 1.0)


def make_problem(gen: torch.Generator, cfg) -> Problem:
    """From a :class:`repro_torch.config.ConvexConfig`, on ``gen.device``."""
    outliers = getattr(cfg, "outlier_frac", 0.0)
    if cfg.problem == "logistic":
        return make_logistic_data(gen, cfg.n, cfg.d, cfg.lam,
                                  outliers=outliers)
    if cfg.problem == "ridge":
        return make_ridge_data(gen, cfg.n, cfg.d, cfg.lam)
    if cfg.problem in ("huber", "pseudo_huber"):
        return make_huber_data(gen, cfg.n, cfg.d, cfg.lam,
                               delta=getattr(cfg, "huber_delta", 1.0),
                               outliers=outliers, kind=cfg.problem)
    raise ValueError(f"unknown problem kind {cfg.problem!r}")


# ---------------------------------------------------------------------------
# Losses / gradients
# ---------------------------------------------------------------------------

def _pointwise_loss(z, bb, kind: str):
    """l(z; b) per sample, from an already-formed margin z = a^T x."""
    base, delta = loss_params(kind)
    if base == "logistic":
        return torch.logaddexp(torch.zeros_like(z), -bb * z)
    if base == "ridge":
        return (z - bb) ** 2
    r = z - bb
    if base == "huber":
        return torch.where(r.abs() <= delta, 0.5 * r * r,
                           delta * (r.abs() - 0.5 * delta))
    if base == "pseudo_huber":
        return delta * delta * (torch.sqrt(1.0 + (r / delta) ** 2) - 1.0)
    raise ValueError(f"unknown problem kind {kind!r}")


def _pointwise_residual(z, bb, kind: str):
    """s = l'(z; b) per sample — the scalar the VR tables store; defined
    once, beside the epoch kernel's plain version (``vr_ref.residual``)."""
    return vr_ref.residual(z, bb, kind)


def full_loss(prob: Problem, x: torch.Tensor) -> torch.Tensor:
    data = torch.mean(_pointwise_loss(prob.A @ x, prob.b, prob.kind))
    return data + prob.lam * torch.sum(x * x)


def scalar_residual(prob: Problem, x: torch.Tensor, idx) -> torch.Tensor:
    """s_i(x) = l'(a_i^T x; b_i) for the given indices (vectorized)."""
    return _pointwise_residual(prob.A[idx] @ x, prob.b[idx], prob.kind)


def scalar_residual_all(prob: Problem, x: torch.Tensor) -> torch.Tensor:
    return _pointwise_residual(prob.A @ x, prob.b, prob.kind)


def sample_grad(prob: Problem, x: torch.Tensor, i) -> torch.Tensor:
    """grad f_i(x) (single index), regularizer included."""
    s = scalar_residual(prob, x, i)
    return s * prob.A[i] + 2.0 * prob.lam * x


def data_grad_from_scalars(prob: Problem, s: torch.Tensor) -> torch.Tensor:
    """(1/n) sum_j s_j a_j — the data term of the mean gradient."""
    return prob.A.T @ s / prob.n


def full_grad(prob: Problem, x: torch.Tensor) -> torch.Tensor:
    s = scalar_residual_all(prob, x)
    return data_grad_from_scalars(prob, s) + 2.0 * prob.lam * x


# ---------------------------------------------------------------------------
# Smoothness / strong-convexity constants
# ---------------------------------------------------------------------------

def constants(prob: Problem):
    """(mu, L) such that every f_i is mu-strongly convex, L-smooth.

    Per-loss curvature bounds sup l'': logistic 1/4, ridge 2, Huber and
    pseudo-Huber 1.
    """
    row_sq = torch.sum(prob.A * prob.A, dim=1)
    base, _ = loss_params(prob.kind)
    curv = {"logistic": 0.25, "ridge": 2.0,
            "huber": 1.0, "pseudo_huber": 1.0}[base]
    L = curv * torch.max(row_sq) + 2.0 * prob.lam
    mu = 2.0 * prob.lam
    return mu, L


def auto_eta(prob: Problem, c: float = 0.3) -> float:
    """Practical step size c/L."""
    _, L = constants(prob)
    return float(c / L)


def solve_exact(prob: Problem, iters: int = 100) -> torch.Tensor:
    """x*: closed form for ridge, ``iters`` Newton steps for logistic,
    ``max(iters, 400)`` IRLS steps for Huber and pseudo-Huber (d is
    small; each step one ``torch.linalg.solve`` of a d x d system).

    IRLS uses the majorization weights w = l'(r)/r (min(1, delta/|r|) for
    Huber): each step solves the weighted normal equations exactly and
    decreases the objective, where raw Newton on Huber can cycle between
    active sets. The fixed point satisfies A^T l'(r)/n + 2*lam*x = 0, the
    stationary point of :func:`full_loss`.
    """
    A, b = prob.A, prob.b
    n, d = A.shape
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    base, delta = loss_params(prob.kind)
    if base == "ridge":
        H = 2.0 * (A.T @ A) / n + 2.0 * prob.lam * eye
        g = 2.0 * (A.T @ b) / n
        return torch.linalg.solve(H, g)
    x = torch.zeros(d, dtype=A.dtype, device=A.device)
    if base in ("huber", "pseudo_huber"):
        for _ in range(max(iters, 400)):
            r = A @ x - b
            if base == "huber":
                w = torch.clamp(delta / torch.clamp(r.abs(), min=1e-300),
                                max=1.0)
            else:
                w = 1.0 / torch.sqrt(1.0 + (r / delta) ** 2)
            Aw = A * w[:, None]
            H = Aw.T @ A / n + 2.0 * prob.lam * eye
            x = torch.linalg.solve(H, Aw.T @ b / n)
        return x
    for _ in range(iters):
        p = torch.sigmoid(-b * (A @ x))
        g = A.T @ (-b * p) / n + 2.0 * prob.lam * x
        w = p * (1.0 - p)
        H = (A * w[:, None]).T @ A / n + 2.0 * prob.lam * eye
        x = x - torch.linalg.solve(H, g)
    return x


def rel_grad_norm(prob: Problem, x: torch.Tensor, g0=None, *, prox=None,
                  eta: float | None = None):
    """The paper's y-axis: ||grad f(x)|| / ||grad f(x0)||; for composite
    runs the numerator is the gradient-mapping residual
    ``||x - prox_{eta*g}(x - eta*grad f(x))||``."""
    if prox is None:
        g = torch.linalg.norm(full_grad(prob, x))
    else:
        from repro_torch.prox import operators as proxops
        g = torch.linalg.norm(
            proxops.grad_map(prox, x, full_grad(prob, x), eta))
    if g0 is None:
        return g
    return g / g0


def grad_norm0(prob: Problem, *, prox=None, eta: float | None = None):
    """||grad f(0)||, the normalizer of the paper's y-axis. Falls back to
    1 when x0 = 0 is an exact prox-gradient fixed point, where dividing
    by zero would make every rel NaN."""
    zero = torch.zeros(prob.d, dtype=prob.A.dtype, device=prob.A.device)
    g0 = rel_grad_norm(prob, zero, prox=prox, eta=eta)
    return torch.where(g0 == 0.0, torch.ones_like(g0), g0)


def gather_epoch(A: torch.Tensor, b: torch.Tensor, orders: torch.Tensor):
    """The rows and labels an epoch visits, in visit order, for a batch of
    workers: ``A`` (p, n, d), ``b`` (p, n), ``orders`` (p, T) ->
    (p, T, d) and (p, T). Gathered once per epoch, so step t reads a view
    ``rows[:, t]`` instead of launching a gather."""
    workers = torch.arange(A.shape[0], device=A.device)[:, None]
    return A[workers, orders], b[workers, orders]
