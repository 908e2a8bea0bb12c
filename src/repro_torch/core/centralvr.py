"""CentralVR, single-worker case (Algorithm 1 of the paper) — the port of
``repro/core/centralvr.py``.

The update (Eqs. 5-6):

    x <- x - eta * ( grad f_i(x) - grad f_i(xtilde_i) + gbar )

with gbar = (1/n) sum_j grad f_j(xtilde_j) frozen over the epoch and
refreshed at epoch end from the running accumulator gtilde (line 11).
Storage is one scalar residual per sample; the regularizer gradient
2*lam*x is exact.

Both sampling modes of the paper: permutation sampling (§2.2, the
practical default) and uniform-with-replacement (§3, Theorem 1); and
``sampling="sparse"``, the lazy sparse driver (``prox/lazy.py``).

The single worker is the p = 1 case of the batched local epochs in
``distributed.py``. Randomness is data: ``run`` takes the init
permutation and each epoch's visit order as ``orders``; the Python loop
over epochs takes the place of the reference's ``lax.scan``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import convex
from repro_torch.core.convex import Problem
from repro_torch.core.distributed import (_as_orders, _generator,
                                          _local_centralvr_epoch,
                                          _local_sgd_epoch)
from repro_torch.prox import operators as proxops


class VRState(NamedTuple):
    x: torch.Tensor        # (d,) iterate
    table: torch.Tensor    # (n,) stored scalar residuals s_j = l'(a_j^T xtilde_j)
    gbar: torch.Tensor     # (d,) data term of the epoch-frozen mean gradient


def init_state(prob: Problem, eta: float, perm: torch.Tensor,
               prox=None, fused=None, x0=None) -> VRState:
    """Algorithm 1, line 2: one epoch of plain SGD from ``x0`` (zeros by
    default) visiting ``perm``; ``fused``: as one ``vr_epoch`` launch
    (``distributed._local_sgd_epoch``)."""
    if x0 is None:
        x0 = torch.zeros(prob.d, dtype=prob.A.dtype, device=prob.A.device)
    x, table, acc = _local_sgd_epoch(prob.A[None], prob.b[None], prob.lam,
                                     prob.kind, x0[None], eta, perm[None],
                                     prox=prox, fused=fused)
    return VRState(x=x[0], table=table[0], gbar=acc[0])


def _epoch(prob, state, eta, order, fused, prox, track):
    out = _local_centralvr_epoch(
        prob.A[None], prob.b[None], prob.lam, prob.kind, state.x[None],
        state.table[None], state.gbar[None], eta, order[None], fused=fused,
        prox=prox, track=bool(track))
    x, table, acc = (t[0] for t in out[:3])
    return x, table, acc, out[3][0] if track else None


def _tracked(state, traj, track_iterates):
    """The state alone when the caller did not pass ``track_iterates``,
    else ``(state, traj)`` as the reference returns it (traj None when
    the flag is False)."""
    return state if track_iterates is None else (state, traj)


def epoch(prob: Problem, state: VRState, eta: float, order: torch.Tensor,
          *, track_iterates=None, fused=None, prox=None):
    """Run n CentralVR updates visiting the permutation ``order``.

    Every index is visited exactly once, so the running accumulator IS
    the table mean (line 11: gbar <- gtilde). ``fused``: kernel
    parameters from ``fused.make_params`` (one ``vr_epoch`` launch for
    the epoch, the prox riding in them), or ``None`` for the unfused
    body.

    Returns the new state; with ``track_iterates`` given, ``(state,
    traj)`` as the reference returns them: ``traj`` the (n, d) iterates
    before each step when it is True (the fused route stores them in its
    one launch), None when it is False.
    """
    x, table, acc, traj = _epoch(prob, state, eta, order, fused, prox,
                                 track_iterates)
    return _tracked(VRState(x=x, table=table, gbar=acc), traj,
                    track_iterates)


def epoch_uniform(prob: Problem, state: VRState, eta: float,
                  idx: torch.Tensor, *, track_iterates=None, fused=None,
                  prox=None):
    """Theorem-1 regime: visit the i.i.d. uniform draws ``idx``, then
    refresh gbar from the table. Returns as :func:`epoch`."""
    x, table, _, traj = _epoch(prob, state, eta, idx, fused, prox,
                               track_iterates)
    return _tracked(VRState(x=x, table=table,
                            gbar=convex.data_grad_from_scalars(prob, table)),
                    traj, track_iterates)


def draw_orders(gen: torch.Generator, n: int, epochs: int,
                sampling: str = "permutation"):
    """(init (n,), per-epoch (epochs, n)) visit orders from ``gen``:
    permutations, or uniform draws for ``sampling="uniform"``."""
    init = torch.randperm(n, generator=gen, device=gen.device)
    if sampling != "uniform":
        per = [torch.randperm(n, generator=gen, device=gen.device)
               for _ in range(epochs)]
    else:
        per = [torch.randint(0, n, (n,), generator=gen, device=gen.device)
               for _ in range(epochs)]
    return init, torch.stack(per)


def run(prob: Problem, *, eta: float, epochs: int, orders=None,
        seed: int = 0, sampling: str = "permutation", x0=None,
        backend: str = "vmap", group=None, fused=False, prox=None):
    """Full Algorithm 1. Returns (final state, per-epoch relative grad
    norms as an (epochs,) tensor, gradient-evaluation counts): one
    evaluation per iteration plus the n of the initialization.

    ``orders``: ``(init, per_epoch)`` visit orders shaped (n,) and
    (epochs, n) — permutations, or uniform draws for
    ``sampling="uniform"`` (for instance the reference's draws,
    ``repro_torch.convert.centralvr_orders``); ``None`` draws them from a
    ``torch.Generator`` seeded with ``seed`` on the problem's device.
    ``x0``: the start of the init epoch (zeros by default).
    ``sampling="sparse"`` runs the lazy sparse driver
    (``prox.lazy.run_sparse``) on the same permutations.
    ``backend="spmd"``: Algorithm 1 is single-worker, so it runs on the
    device of ``group``'s one rank (``spmd.run_centralvr``).
    Validation is a ``solver.RunSpec`` build, as in the reference.
    """
    from repro_torch.core import fused as fusedmod
    from repro_torch.core import solver
    spec = solver.RunSpec(algo="centralvr", eta=float(eta), rounds=epochs,
                          backend=backend, sampling=sampling, fused=fused,
                          prox=proxops.canonical(prox))
    if spec.backend == "spmd":
        from repro_torch.core import spmd
        return spmd.run_centralvr(prob, eta=eta, epochs=epochs,
                                  orders=orders, seed=seed,
                                  sampling=sampling, x0=x0, group=group,
                                  fused=fused, prox=spec.prox)
    device = prob.A.device
    if orders is None:
        orders = draw_orders(_generator(device, seed), prob.n, epochs,
                             sampling)
    init, per = _as_orders(orders, ((prob.n,), (epochs, prob.n)), device,
                           prob.n)
    px = proxops.parse(spec.prox) if spec.prox is not None else None
    if spec.sampling == "sparse":
        from repro_torch.prox import lazy
        return lazy.run_sparse(prob, eta=eta, epochs=epochs,
                               orders=(init, per), x0=x0, prox=px)
    # the fused parameters carry their own copy of the (elementwise) prox
    # for the kernel epilogue; ``px`` still shapes the metric and the
    # unfused body
    fused_t = fusedmod.make_params(spec.fused, eta, prob.lam, device,
                                   prox=px)
    state = init_state(prob, eta, init, prox=px, fused=fused_t, x0=x0)
    g0 = convex.grad_norm0(prob, prox=px, eta=eta)
    step = epoch if sampling == "permutation" else epoch_uniform
    rels = []
    for order in per:
        state = step(prob, state, eta, order, fused=fused_t, prox=px)
        rels.append(convex.rel_grad_norm(prob, state.x, g0, prox=px,
                                         eta=eta))
    grad_evals = prob.n * np.arange(2, epochs + 2)
    return state, torch.stack(rels), grad_evals
