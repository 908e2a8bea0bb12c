"""Theorem 1 constants and step-size bounds — the port of
``repro/core/theory.py``, on Python floats: tests hold the measured
convergence against the paper's guarantee with them.

Theorem 1: with uniform-with-replacement sampling and

    alpha = max( 1 - eta*mu,  2*L^2*eta / (mu*(1 - 2*L*eta)) ),

if 0 < alpha < 1 the Lyapunov function

    V_m = ||x_m^0 - x*||^2 + c * ( fbar(x_m) - f(x*) ),   c = 2*n*eta*(1-2*L*eta)

contracts: V_{m+1} <= alpha * V_m.  The remark gives the sufficient step
size  eta < mu / (2*L*(L+mu)).
"""
from __future__ import annotations

import math


def alpha(eta: float, mu: float, L: float) -> float:
    """The contraction factor of Theorem 1 (``math.inf`` when
    1 - 2*L*eta <= 0)."""
    a1 = 1.0 - eta * mu
    denom = mu * (1.0 - 2.0 * L * eta)
    a2 = math.inf if denom <= 0 else 2.0 * L**2 * eta / denom
    return float(max(a1, a2))


def max_step(mu: float, L: float) -> float:
    """Sufficient step-size bound from the remark after Theorem 1."""
    return float(min(1.0 / mu, 1.0 / (2.0 * L), mu / (2.0 * L * (L + mu))))


def lyapunov_c(eta: float, n: int, L: float) -> float:
    return float(2.0 * n * eta * (1.0 - 2.0 * L * eta))


def lyapunov(x0_dist_sq: float, fbar_gap: float, eta: float, n: int,
             L: float) -> float:
    """V_m = ||x_m^0 - x*||^2 + c (fbar - f*)."""
    return float(x0_dist_sq + lyapunov_c(eta, n, L) * fbar_gap)


def epochs_to_eps(eps: float, alpha_: float) -> int:
    """Epochs needed for a factor-eps contraction at rate alpha."""
    return int(math.ceil(math.log(eps) / math.log(alpha_)))
