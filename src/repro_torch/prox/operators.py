"""Proximal operators for composite objectives — the port of
``repro/prox/operators.py``.

Each operator evaluates, in closed form,

    prox_{eta*g}(w) = argmin_z  0.5*||z - w||^2 + eta*g(z)

as a map ``(w, eta) -> w`` on tensors. A configured operator travels as a
:class:`ProxSpec`, a flat ``(name, params)`` tuple of hashables.

Spec strings (``RunSpec.prox``) are ``name[:p1[:p2]]``:

    "l1:0.01"                g(w) = 0.01*||w||_1
    "elasticnet:0.01:0.001"  g(w) = 0.01*||w||_1 + 0.001*||w||_2^2
    "box:-1:1"               g = indicator of [-1, 1]^d
    "group_l2:0.01:4"        g(w) = 0.01 * sum_groups ||w_g||_2, |g| = 4

Omitted params take registry defaults. ``l1``/``elasticnet``/``box`` are
elementwise (fusable into the vr_update kernel epilogue); ``group_l2``
couples coordinates within each group and refuses ``fused=True``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class ProxSpec(NamedTuple):
    """A parsed, hashable prox configuration."""

    name: str              # registry key
    params: tuple          # floats (ints for group size), fully resolved


class _Op(NamedTuple):
    defaults: tuple                      # default params (also fixes arity)
    elementwise: bool                    # fusable into the kernel epilogue
    apply: Callable                      # (w, eta, params) -> w
    penalty: Callable                    # (w, params) -> g(w)
    signature: str                       # human spelling for error messages


def _soft(w, t):
    """Soft-threshold S_t(w) = sign(w) * max(|w| - t, 0)."""
    return torch.sign(w) * torch.clamp(torch.abs(w) - t, min=0.0)


# -- l1: g(w) = lam1 * ||w||_1 ----------------------------------------------

def _l1_apply(w, eta, params):
    (lam1,) = params
    return _soft(w, eta * lam1)


def _l1_penalty(w, params):
    (lam1,) = params
    return lam1 * torch.sum(torch.abs(w))


# -- elasticnet: g(w) = lam1 * ||w||_1 + lam2 * ||w||_2^2 -------------------

def _en_apply(w, eta, params):
    lam1, lam2 = params
    return _soft(w, eta * lam1) / (1.0 + 2.0 * eta * lam2)


def _en_penalty(w, params):
    lam1, lam2 = params
    return lam1 * torch.sum(torch.abs(w)) + lam2 * torch.sum(w * w)


# -- box: g = indicator of [lo, hi]^d ---------------------------------------

def _box_apply(w, eta, params):
    lo, hi = params
    del eta  # projection: prox of an indicator ignores the step size
    return torch.clamp(w, lo, hi)


def _box_penalty(w, params):
    lo, hi = params
    feasible = torch.all((w >= lo) & (w <= hi))
    return torch.where(feasible, 0.0, torch.inf).to(w.dtype)


# -- group_l2: g(w) = lam1 * sum_g ||w_g||_2, contiguous groups of `size` --
# Block soft-threshold: w_g * max(1 - eta*lam1/||w_g||, 0); the closed form
# is the true prox, also where the group norm underflows.

def _gl2_apply(w, eta, params):
    lam1, size = params
    size = int(size)
    if w.shape[-1] % size:
        raise ValueError(
            f"prox 'group_l2': d={w.shape[-1]} is not divisible by the "
            f"group size {size}")
    groups = w.reshape(w.shape[:-1] + (-1, size))
    norms = torch.linalg.norm(groups, dim=-1, keepdim=True)
    scale = torch.clamp(1.0 - eta * lam1 / torch.clamp(norms, min=1e-300),
                        min=0.0)
    return (groups * scale).reshape(w.shape)


def _gl2_penalty(w, params):
    lam1, size = params
    groups = w.reshape(w.shape[:-1] + (-1, int(size)))
    return lam1 * torch.sum(torch.linalg.norm(groups, dim=-1))


_REGISTRY = {
    "l1": _Op((1e-3,), True, _l1_apply, _l1_penalty, "l1:lam1"),
    "elasticnet": _Op((1e-3, 1e-4), True, _en_apply, _en_penalty,
                      "elasticnet:lam1:lam2"),
    "box": _Op((-1.0, 1.0), True, _box_apply, _box_penalty, "box:lo:hi"),
    "group_l2": _Op((1e-3, 4.0), False, _gl2_apply, _gl2_penalty,
                    "group_l2:lam1:group_size"),
}


def names() -> tuple:
    """Registered operator names (for listings and error messages)."""
    return tuple(sorted(_REGISTRY))


def _signatures() -> str:
    return ", ".join(_REGISTRY[k].signature for k in sorted(_REGISTRY))


def parse(spec: str | ProxSpec) -> ProxSpec:
    """``"name[:p1[:p2]]"`` -> :class:`ProxSpec` (idempotent on ProxSpec).

    Raises ``ValueError`` naming the unknown operator or malformed param.
    """
    if isinstance(spec, ProxSpec):
        return spec
    parts = str(spec).split(":")
    name, raw = parts[0], parts[1:]
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown prox operator {name!r}; registered: {_signatures()}")
    op = _REGISTRY[name]
    if len(raw) > len(op.defaults):
        raise ValueError(
            f"prox {name!r} takes at most {len(op.defaults)} params "
            f"({op.signature}); got {spec!r}")
    params = []
    for i, dflt in enumerate(op.defaults):
        if i < len(raw):
            try:
                params.append(float(raw[i]))
            except ValueError:
                raise ValueError(
                    f"prox {name!r}: param {i + 1} must be a number "
                    f"({op.signature}); got {raw[i]!r}") from None
        else:
            params.append(float(dflt))
    if name == "box" and params[0] > params[1]:
        raise ValueError(
            f"prox 'box': lo={params[0]} > hi={params[1]} is an empty box")
    if name == "group_l2":
        if params[1] < 1 or params[1] != int(params[1]):
            raise ValueError(
                f"prox 'group_l2': group size must be a positive integer; "
                f"got {params[1]}")
    if name in ("l1", "elasticnet", "group_l2") and params[0] < 0:
        raise ValueError(
            f"prox {name!r}: lam1 must be >= 0; got {params[0]}")
    if name == "elasticnet" and params[1] < 0:
        raise ValueError(
            f"prox 'elasticnet': lam2 must be >= 0; got {params[1]}")
    return ProxSpec(name, tuple(params))


def canonical(spec: str | ProxSpec | None) -> str | None:
    """The normalized string spelling of a spec (params fully resolved)."""
    if spec is None:
        return None
    ps = parse(spec)
    return ":".join([ps.name] + [f"{p:g}" for p in ps.params])


def is_elementwise(spec: str | ProxSpec | None) -> bool:
    """True when the operator decouples across coordinates (kernel-fusable)."""
    if spec is None:
        return True
    return _REGISTRY[parse(spec).name].elementwise


def apply(spec: str | ProxSpec, w, eta):
    """prox_{eta*g}(w) for the configured g."""
    ps = parse(spec)
    return _REGISTRY[ps.name].apply(w, eta, ps.params)


def apply_prox(spec: str | ProxSpec | None, w, eta):
    """None-safe :func:`apply` — identity when no prox is configured."""
    if spec is None:
        return w
    return apply(spec, w, eta)


def penalty(spec: str | ProxSpec | None, w):
    """g(w) — the nonsmooth term's value (0 when no prox is configured)."""
    if spec is None:
        return torch.zeros((), dtype=w.dtype, device=w.device)
    ps = parse(spec)
    return _REGISTRY[ps.name].penalty(w, ps.params)


def grad_map(spec: str | ProxSpec | None, x, grad, eta):
    """Composite gradient-mapping residual  x - prox_{eta*g}(x - eta*grad);
    ``eta*grad`` when ``spec`` is None."""
    if spec is None:
        return eta * grad
    return x - apply(spec, x - eta * grad, eta)


# ---------------------------------------------------------------------------
# Numeric oracle (tests only): golden-section search, no closed form
# ---------------------------------------------------------------------------

_GOLD = 0.6180339887498949  # 1/phi


def _golden_min(f, lo, hi, iters: int):
    """Vectorized golden-section minimization of a per-coordinate convex f
    over the bracket [lo, hi]; the interval shrinks by 1/phi a step."""
    a, b = lo, hi
    for _ in range(iters):
        span = b - a
        x1 = b - _GOLD * span
        x2 = a + _GOLD * span
        take_left = f(x1) <= f(x2)
        a = torch.where(take_left, a, x1)
        b = torch.where(take_left, x2, b)
    return 0.5 * (a + b)


def numeric_prox(spec: str | ProxSpec, w, eta, iters: int = 120):
    """Solve the prox subproblem numerically, without the closed form:
    elementwise operators as independent scalar problems
    ``min_z 0.5*(z - w_i)^2 + eta*g_i(z)`` by golden-section search over
    a bracket that contains the minimizer; ``group_l2`` as a 1-D search
    over each group's radius. Accurate to ~sqrt(eps)*scale, about 1e-8."""
    ps = parse(spec)
    w = torch.as_tensor(w)
    if ps.name == "box":
        lo, hi = ps.params
        a = torch.clamp(torch.clamp(w, max=lo), lo, hi) * torch.ones_like(w)
        b = torch.clamp(torch.clamp(w, min=hi), lo, hi) * torch.ones_like(w)
        return _golden_min(lambda z: 0.5 * (z - w) ** 2, a, b, iters)
    if ps.name in ("l1", "elasticnet"):
        lam1, lam2 = ps.params if ps.name == "elasticnet" else (
            ps.params[0], 0.0)

        def f(z):
            return (0.5 * (z - w) ** 2 + eta * lam1 * torch.abs(z)
                    + eta * lam2 * z * z)

        bound = torch.abs(w) + 1.0      # |prox| <= |w| for these operators
        return _golden_min(f, -bound, bound, iters)
    # group_l2: the optimum lies on the ray through w_g; search the radius
    lam1, size = ps.params
    groups = w.reshape(w.shape[:-1] + (-1, int(size)))
    norms = torch.linalg.norm(groups, dim=-1)

    def f(t):
        return 0.5 * (t - norms) ** 2 + eta * lam1 * t

    t_star = _golden_min(f, torch.zeros_like(norms), norms + 1.0, iters)
    unit = groups / torch.clamp(norms, min=1e-300)[..., None]
    return (unit * t_star[..., None]).reshape(w.shape)
