"""Comparison baselines of the paper's experiments — the port of
``repro/core/baselines.py``:

  * single worker, the Fig. 1 comparison: plain SGD, SVRG [17], SAGA [12];
  * distributed (§6.2): SGD with periodic averaging, EASGD [36],
    parameter-server SVRG [29].

All run on the same substrate as the proposed methods, so comparisons per
gradient evaluation are exact. SVRG and SAGA share their inner loops with
D-SVRG and D-SAGA (``distributed._svrg_anchors``,
``distributed._local_saga_steps``): one ``vr_epoch`` launch per inner
loop when fused. The decaying step sizes are computed on the host, one
per epoch or round.

Randomness is data: every driver takes its draws as ``orders`` (the
reference draws them with ``jax.random``; ``repro_torch.convert`` replays
its key splits), and draws them from a ``torch.Generator`` seeded with
``seed`` on the problem's device when none are given.
"""
from __future__ import annotations

import torch

from repro_torch.core import convex
from repro_torch.core.convex import Problem
from repro_torch.core.distributed import (ShardedProblem, _as_index,
                                          _generator, _local_saga_steps,
                                          _randint, _randperms,
                                          _svrg_anchors)
from repro_torch.prox import operators as proxops


def _sgd_steps(A, b, lam, kind, x, eta, idx):
    """Plain SGD steps on every worker's shard: ``A`` (p, n, d), ``x``
    (p, d), ``idx`` (p, T). Returns the final iterates."""
    rows, labels = convex.gather_epoch(A, b, idx)
    for t in range(idx.shape[1]):
        a = rows[:, t]
        s = convex._pointwise_residual(torch.linalg.vecdot(a, x),
                                       labels[:, t], kind)[:, None]
        x = x - eta * (s * a + 2.0 * lam * x)
    return x


# ---------------------------------------------------------------------------
# Sequential SGD / SVRG / SAGA (single worker, for Fig. 1)
# ---------------------------------------------------------------------------

def draw_sgd_orders(gen: torch.Generator, n: int, epochs: int):
    """Per-epoch permutations (epochs, n) from ``gen``."""
    return _randperms(gen, epochs, n)


def run_sgd(prob: Problem, *, eta: float, epochs: int, orders=None,
            seed: int = 0, decay: float = 0.0):
    """Plain SGD, permutation sampling; eta_l = eta / (1 + decay*l).
    Returns (x, per-epoch rels).

    ``orders``: the per-epoch permutations (epochs, n)
    (``repro_torch.convert.sgd_orders``); ``None`` draws them from a
    ``torch.Generator`` seeded with ``seed``."""
    from repro_torch.core import solver
    solver.RunSpec(algo="sgd", eta=float(eta), rounds=epochs, decay=decay)
    device = prob.A.device
    if orders is None:
        orders = draw_sgd_orders(_generator(device, seed), prob.n, epochs)
    perms = _as_index(orders, (epochs, prob.n), "per-epoch permutations",
                      device, prob.n)
    x = torch.zeros(prob.d, dtype=prob.A.dtype, device=device)
    g0 = convex.grad_norm0(prob)
    rels = []
    for ep in range(epochs):
        x = _sgd_steps(prob.A[None], prob.b[None], prob.lam, prob.kind,
                       x[None], eta / (1.0 + decay * ep), perms[ep][None])[0]
        rels.append(convex.rel_grad_norm(prob, x, g0))
    return x, torch.stack(rels)


def draw_svrg_orders(gen: torch.Generator, n: int, epochs: int, inner: int,
                     snapshot: str = "last"):
    """(sample indices (epochs, inner), anchor indices (epochs,) in
    [0, inner) for ``snapshot="rand"``, else None) from ``gen``."""
    idx = _randint(gen, n, (epochs, inner))
    return idx, (_randint(gen, inner, (epochs,)) if snapshot == "rand"
                 else None)


def run_svrg(prob: Problem, *, eta: float, epochs: int, inner: int = 0,
             orders=None, seed: int = 0, fused=False, prox=None,
             snapshot: str = "last"):
    """SVRG [17]: snapshot + full gradient every epoch, then ``inner``
    (default n) steps of update (3); the next snapshot is the last inner
    iterate, their mean, or a uniformly drawn one (``snapshot``: last,
    avg, rand; avg and rand run unfused). Gradient evaluations per epoch:
    n + 2*inner. ``inner`` maps onto the spec's ``tau`` axis. Returns
    (x, per-epoch rels).

    ``orders``: ``(idx, snap)``, the sample indices (epochs, inner) and,
    for ``snapshot="rand"``, each epoch's anchor index (epochs,) (else
    None) (``repro_torch.convert.svrg_orders``); ``None`` draws them from
    a ``torch.Generator`` seeded with ``seed``."""
    from repro_torch.core import fused as fusedmod
    from repro_torch.core import solver
    spec = solver.RunSpec(algo="svrg", eta=float(eta), rounds=epochs,
                          tau=inner or None, fused=fused,
                          prox=proxops.canonical(prox), snapshot=snapshot)
    device = prob.A.device
    px = proxops.parse(spec.prox) if spec.prox is not None else None
    fused_t = (fusedmod.make_params(spec.fused, eta, prob.lam, device,
                                    prox=px)
               if snapshot == "last" else None)
    inner = inner or prob.n
    if orders is None:
        orders = draw_svrg_orders(_generator(device, seed), prob.n, epochs,
                                  inner, snapshot)
    idx = _as_index(orders[0], (epochs, inner), "sample indices", device,
                    prob.n)
    snap = (_as_index(orders[1], (epochs,), "anchor indices", device, inner)
            .tolist() if snapshot == "rand" else [None] * epochs)
    x = torch.zeros(prob.d, dtype=prob.A.dtype, device=device)
    g0 = convex.grad_norm0(prob, prox=px, eta=eta)
    rels = []
    for ep in range(epochs):
        x = _svrg_anchors(prob.A[None], prob.b[None], prob.lam, prob.kind,
                          x, convex.full_grad(prob, x), eta, idx[ep][None],
                          fused=fused_t, prox=px, snapshot=snapshot,
                          r=snap[ep])[0]
        rels.append(convex.rel_grad_norm(prob, x, g0, prox=px, eta=eta))
    return x, torch.stack(rels)


def draw_saga_orders(gen: torch.Generator, n: int, epochs: int):
    """Per-epoch sample indices (epochs, n) from ``gen``."""
    return _randint(gen, n, (epochs, n))


def run_saga(prob: Problem, *, eta: float, epochs: int, orders=None,
             seed: int = 0, fused=False, prox=None):
    """SAGA [12]: update (4), the table mean refreshed every step; one
    gradient evaluation per step; the table initialised at x0 = 0.
    Returns (x, per-epoch rels).

    ``orders``: the sample indices (epochs, n)
    (``repro_torch.convert.saga_orders``); ``None`` draws them from a
    ``torch.Generator`` seeded with ``seed``."""
    from repro_torch.core import fused as fusedmod
    from repro_torch.core import solver
    spec = solver.RunSpec(algo="saga", eta=float(eta), rounds=epochs,
                          fused=fused, prox=proxops.canonical(prox))
    device = prob.A.device
    px = proxops.parse(spec.prox) if spec.prox is not None else None
    fused_t = fusedmod.make_params(spec.fused, eta, prob.lam, device,
                                   prox=px)
    if orders is None:
        orders = draw_saga_orders(_generator(device, seed), prob.n, epochs)
    idx = _as_index(orders, (epochs, prob.n), "sample indices", device,
                    prob.n)
    x = torch.zeros(prob.d, dtype=prob.A.dtype, device=device)
    g0 = convex.grad_norm0(prob, prox=px, eta=eta)
    table = convex.scalar_residual_all(prob, x)
    gbar = convex.data_grad_from_scalars(prob, table)
    x, table, gbar = x[None], table[None], gbar[None]
    rels = []
    for ep in range(epochs):
        x, table, gbar = _local_saga_steps(
            prob.A[None], prob.b[None], prob.lam, prob.kind, x, table, gbar,
            eta, prob.n, idx[ep][None], fused=fused_t, prox=px)
        rels.append(convex.rel_grad_norm(prob, x[0], g0, prox=px, eta=eta))
    return x[0], torch.stack(rels)


# ---------------------------------------------------------------------------
# Distributed baselines
# ---------------------------------------------------------------------------

def draw_dist_sgd_orders(gen: torch.Generator, p: int, ns: int, rounds: int,
                         tau: int):
    """Sample indices (rounds, p, tau) from ``gen``."""
    return _randint(gen, ns, (rounds, p, tau))


def run_dist_sgd(sp: ShardedProblem, *, eta: float, rounds: int,
                 tau: int = 0, decay: float = 0.0, orders=None,
                 seed: int = 0, backend: str = "vmap", group=None):
    """Distributed SGD: ``tau`` local steps (default one local epoch, ns)
    on every worker, then the average, with eta_r = eta /
    (1 + decay*r*tau)**0.5. Returns (x, per-round rels).

    ``orders``: the sample indices (rounds, p, tau)
    (``repro_torch.convert.dist_sgd_orders``); ``None`` draws them from a
    ``torch.Generator`` seeded with ``seed``. ``backend="spmd"``: one
    worker per rank of ``group`` (``core/spmd.py``)."""
    from repro_torch.core import solver
    spec = solver.RunSpec(algo="dist_sgd", p=sp.p, eta=float(eta),
                          rounds=rounds, backend=backend, tau=tau or None,
                          decay=decay)
    if spec.backend == "spmd":
        from repro_torch.core import spmd
        return spmd.run_dist_sgd(sp, eta=eta, rounds=rounds, tau=tau,
                                 decay=decay, orders=orders, seed=seed,
                                 group=group)
    device = sp.A.device
    tau = tau or sp.ns
    if orders is None:
        orders = draw_dist_sgd_orders(_generator(device, seed), sp.p, sp.ns,
                                      rounds, tau)
    idx = _as_index(orders, (rounds, sp.p, tau), "sample indices", device,
                    sp.ns)
    merged = sp.merged()
    x = torch.zeros(sp.d, dtype=sp.A.dtype, device=device)
    g0 = convex.grad_norm0(merged)
    rels = []
    for r in range(rounds):
        eta_r = eta / (1.0 + decay * r * tau) ** 0.5
        x = _sgd_steps(sp.A, sp.b, sp.lam, sp.kind, x.expand(sp.p, -1),
                       eta_r, idx[r]).mean(0)
        rels.append(convex.rel_grad_norm(merged, x, g0))
    return x, torch.stack(rels)


def draw_easgd_orders(gen: torch.Generator, p: int, ns: int, rounds: int,
                      tau: int):
    """Sample indices (rounds, p, max(ns // tau, 1), tau) from ``gen``."""
    return _randint(gen, ns, (rounds, p, max(ns // tau, 1), tau))


def run_easgd(sp: ShardedProblem, *, eta: float, rounds: int, tau: int = 16,
              rho: float = 1.0, decay: float = 0.0, orders=None,
              seed: int = 0, backend: str = "vmap", group=None):
    """EASGD [36]: per round, every worker runs max(ns // tau, 1) blocks
    of ``tau`` local SGD steps, each followed by the elastic move against
    its view of the center,
      x_s <- x_s - alpha*(x_s - xc),  xc_view <- xc_view + alpha*(x_s - xc),
    with alpha = min(0.9/p, eta*rho*tau); the center then takes
    xc += alpha * (sum of every worker's moves) / p. The step decays as
    eta / (1 + decay*r*ns)**0.5. Returns (xc, per-round rels).

    ``orders``: the sample indices (rounds, p, max(ns // tau, 1), tau)
    (``repro_torch.convert.easgd_orders``); ``None`` draws them from a
    ``torch.Generator`` seeded with ``seed``. ``backend="spmd"``: one
    worker per rank of ``group`` (``core/spmd.py``)."""
    from repro_torch.core import solver
    spec = solver.RunSpec(algo="easgd", p=sp.p, eta=float(eta),
                          rounds=rounds, backend=backend, tau=tau or None,
                          decay=decay)
    if spec.backend == "spmd":
        from repro_torch.core import spmd
        return spmd.run_easgd(sp, eta=eta, rounds=rounds, tau=tau, rho=rho,
                              decay=decay, orders=orders, seed=seed,
                              group=group)
    device = sp.A.device
    p = sp.p
    alpha = min(0.9 / p, eta * rho * tau)   # stability-capped elastic rate
    steps_per_round = max(sp.ns // tau, 1)
    if orders is None:
        orders = draw_easgd_orders(_generator(device, seed), p, sp.ns,
                                   rounds, tau)
    idx = _as_index(orders, (rounds, p, steps_per_round, tau),
                    "sample indices", device, sp.ns)
    merged = sp.merged()
    xc = torch.zeros(sp.d, dtype=sp.A.dtype, device=device)
    xs = torch.zeros((p, sp.d), dtype=sp.A.dtype, device=device)
    g0 = convex.grad_norm0(merged)
    rels = []
    for r in range(rounds):
        eta_r = eta / (1.0 + decay * r * sp.ns) ** 0.5
        xc_view = xc.expand(p, -1)
        moves = torch.zeros_like(xs)
        for j in range(steps_per_round):
            xs = _sgd_steps(sp.A, sp.b, sp.lam, sp.kind, xs, eta_r,
                            idx[r, :, j])
            diff = xs - xc_view
            xs = xs - alpha * diff
            xc_view = xc_view + alpha * diff
            moves = moves + diff
        xc = xc + alpha * moves.sum(0) / p
        rels.append(convex.rel_grad_norm(merged, xc, g0))
    return xc, torch.stack(rels)


def draw_ps_svrg_orders(gen: torch.Generator, p: int, ns: int, rounds: int,
                        epoch_mult: int = 2):
    """Sample indices (rounds, epoch_mult * ns, p), one per worker per
    server step, from ``gen``."""
    return _randint(gen, ns, (rounds, epoch_mult * ns, p))


def run_ps_svrg(sp: ShardedProblem, *, eta: float, rounds: int,
                epoch_mult: int = 2, orders=None, seed: int = 0,
                backend: str = "vmap", group=None):
    """Parameter-server SVRG [29]: per round a snapshot and its full
    gradient, then epoch_mult * ns server steps, each the average of one
    corrected gradient from every worker (synchronized arrivals,
    staleness 0, the method's best case). Returns (x, per-round rels).

    ``orders``: the sample indices (rounds, epoch_mult * ns, p)
    (``repro_torch.convert.ps_svrg_orders``); ``None`` draws them from a
    ``torch.Generator`` seeded with ``seed``. ``backend="spmd"``: one
    worker per rank of ``group`` (``core/spmd.py``)."""
    from repro_torch.core import solver
    spec = solver.RunSpec(algo="ps_svrg", p=sp.p, eta=float(eta),
                          rounds=rounds, backend=backend)
    if spec.backend == "spmd":
        from repro_torch.core import spmd
        return spmd.run_ps_svrg(sp, eta=eta, rounds=rounds,
                                epoch_mult=epoch_mult, orders=orders,
                                seed=seed, group=group)
    device = sp.A.device
    inner = epoch_mult * sp.ns
    if orders is None:
        orders = draw_ps_svrg_orders(_generator(device, seed), sp.p, sp.ns,
                                     rounds, epoch_mult)
    idx = _as_index(orders, (rounds, inner, sp.p), "sample indices", device,
                    sp.ns)
    merged = sp.merged()
    x = torch.zeros(sp.d, dtype=sp.A.dtype, device=device)
    g0 = convex.grad_norm0(merged)
    rels = []
    for r in range(rounds):
        xbar = x
        gbar = convex.full_grad(merged, xbar)
        order = idx[r].T                              # (p, inner)
        rows, labels = convex.gather_epoch(sp.A, sp.b, order)
        sbar = convex._pointwise_residual(torch.linalg.vecdot(rows, xbar),
                                          labels, sp.kind)
        for t in range(inner):
            a = rows[:, t]
            s = convex._pointwise_residual(a @ x, labels[:, t], sp.kind)
            g = ((s - sbar[:, t])[:, None] * a + gbar
                 + 2.0 * sp.lam * (x - xbar))
            x = x - eta * g.mean(0)
        rels.append(convex.rel_grad_norm(merged, x, g0))
    return x, torch.stack(rels)
