"""Per-round host drivers of Algorithms 1-5 — the port of
``repro/core/host_loop.py``, the reference's seed execution model: a
Python loop over rounds (or events) around the port's per-epoch
functions, and one blocking ``float(rel)`` device-to-host transfer every
round.

They are a pinning oracle: the drivers in ``centralvr`` and
``distributed`` must give the same trajectories (tests hold both, and
the reference's ``host_loop``, to 1e-10 in float64). Do not add
algorithms here; new work goes in the drivers.

Randomness is data, as in the drivers: each function takes its draws as
``orders`` in the layout of the driver it pins (the reference's key
splits here are the drivers' own, so ``repro_torch.convert``'s
``centralvr_orders``, ``sync_orders``, ``async_orders``,
``dsvrg_orders`` and ``dsaga_orders`` replay them), or draws them from a
``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import centralvr, convex, distributed, runtime
from repro_torch.core.convex import Problem
from repro_torch.core.distributed import (ShardedProblem, _as_index,
                                          _as_orders, _generator)


def _g0(prob: Problem):
    return torch.linalg.norm(convex.full_grad(
        prob, torch.zeros(prob.d, dtype=prob.A.dtype,
                          device=prob.A.device)))


def _rel(prob: Problem, x, g0) -> float:
    """||grad f(x)|| / ||grad f(0)||, brought to the host."""
    return float(torch.linalg.norm(convex.full_grad(prob, x)) / g0)


def _rels(rels, like) -> torch.Tensor:
    return torch.tensor(rels, dtype=like.dtype)


def run(prob: Problem, *, eta: float, epochs: int, orders=None,
        seed: int = 0, sampling: str = "permutation", x0=None):
    """Host-loop Algorithm 1 (per-epoch sync). ``orders``: as
    ``centralvr.run`` takes them. Returns (state, rels, grad_evals)."""
    device = prob.A.device
    if orders is None:
        orders = centralvr.draw_orders(_generator(device, seed), prob.n,
                                       epochs, sampling)
    init, per = _as_orders(orders, ((prob.n,), (epochs, prob.n)), device,
                           prob.n)
    state = centralvr.init_state(prob, eta, init, x0=x0)
    g0 = _g0(prob)
    step = (centralvr.epoch if sampling == "permutation"
            else centralvr.epoch_uniform)
    rels = []
    grad_evals = [prob.n]                 # init epoch
    for m in range(epochs):
        state = step(prob, state, eta, per[m])
        rels.append(_rel(prob, state.x, g0))
        grad_evals.append(grad_evals[-1] + prob.n)
    return state, _rels(rels, prob.A), np.asarray(grad_evals[1:])


def run_sync(sp: ShardedProblem, *, eta: float, rounds: int, orders=None,
             seed: int = 0):
    """Host-loop Algorithm 2. ``orders``: as ``distributed.run_sync``
    takes them. Returns (state, rels)."""
    device = sp.A.device
    if orders is None:
        orders = distributed.draw_sync_orders(_generator(device, seed), sp.p,
                                              sp.ns, rounds)
    init, per = _as_orders(orders, ((sp.p, sp.ns), (rounds, sp.p, sp.ns)),
                           device, sp.ns)
    merged = sp.merged()
    st = distributed.sync_init(sp, eta, init)
    g0 = _g0(merged)
    rels = []
    for r in range(rounds):
        st = distributed.sync_round(sp, st, eta, per[r])
        rels.append(_rel(merged, st.x, g0))
    return st, _rels(rels, sp.A)


def run_async(sp: ShardedProblem, *, eta: float, rounds: int, orders=None,
              seed: int = 0, speeds=None):
    """Host-loop Algorithm 3: events one at a time in the order of
    ``runtime.event_schedule``, a rel after every p events. ``orders``:
    as ``distributed.run_async`` takes them. Returns (state, rels)."""
    device = sp.A.device
    if orders is None:
        orders = distributed.draw_async_orders(_generator(device, seed),
                                               sp.p, sp.ns, rounds)
    init, events = _as_orders(
        orders, ((sp.p, sp.ns), (rounds * sp.p, sp.ns)), device, sp.ns,
        names=("init", "per-event"))
    merged = sp.merged()
    st = distributed.async_init(sp, eta, init)
    g0 = _g0(merged)
    rels = []
    for t, s in enumerate(runtime.event_schedule(sp.p, rounds, speeds)):
        st = distributed.async_event(sp, st, int(s), eta, events[t])
        if (t + 1) % sp.p == 0:
            rels.append(_rel(merged, st.x_c, g0))
    return st, _rels(rels, sp.A)


def run_dsvrg(sp: ShardedProblem, *, eta: float, rounds: int, orders=None,
              seed: int = 0, tau: int = 0):
    """Host-loop Algorithm 4 (snapshot last): ``tau`` (default 2*ns)
    local SVRG steps on every worker from the shared snapshot, then the
    average. ``orders``: ``(idx, None)`` with the sample indices
    (rounds, p, tau), as ``distributed.run_dsvrg`` takes them for
    ``snapshot="last"``. Returns (x, rels)."""
    device = sp.A.device
    tau = tau or 2 * sp.ns
    if orders is None:
        orders = distributed.draw_dsvrg_orders(_generator(device, seed),
                                               sp.p, sp.ns, rounds, tau)
    idx = _as_index(orders[0], (rounds, sp.p, tau), "sample indices",
                    device, sp.ns)
    merged = sp.merged()
    x = torch.zeros(sp.d, dtype=sp.A.dtype, device=device)
    g0 = _g0(merged)
    rels = []
    for r in range(rounds):
        x = distributed._svrg_anchors(sp.A, sp.b, sp.lam, sp.kind, x,
                                      convex.full_grad(merged, x), eta,
                                      idx[r]).mean(0)
        rels.append(_rel(merged, x, g0))
    return x, _rels(rels, sp.A)


def run_dsaga(sp: ShardedProblem, *, eta: float, rounds: int, orders=None,
              seed: int = 0, tau: int = 100, literal_scaling: bool = False):
    """Host-loop Algorithm 5 (instant fetch, round-robin): event t is
    worker t mod p's ``tau`` SAGA steps. ``orders``: as
    ``distributed.run_dsaga`` takes them. Returns (state, rels)."""
    device = sp.A.device
    if orders is None:
        orders = distributed.draw_dsaga_orders(_generator(device, seed),
                                               sp.p, sp.ns, rounds, tau)
    idx = _as_index(orders, (rounds * sp.p, tau), "per-event sample indices",
                    device, sp.ns)
    merged = sp.merged()
    st = distributed.dsaga_init(sp)
    g0 = _g0(merged)
    rels = []
    for t in range(rounds * sp.p):
        st = distributed.dsaga_event(sp, st, t % sp.p, eta, idx[t],
                                     literal_scaling)
        if (t + 1) % sp.p == 0:
            rels.append(_rel(merged, st.x_c, g0))
    return st, _rels(rels, sp.A)
