"""CentralVR-Sync (Algorithm 2 of the paper) on the convex substrate —
the port of the synchronous part of ``repro/core/distributed.py``.

Workers are a batch dimension: the p local shards are stacked along a
leading axis and step t of a local epoch visits row ``perm[w, t]`` of
every worker's shard at once, where the reference runs the local epochs
under ``jax.vmap``. The central server of the paper is the average across
that axis.

Randomness is data: the drivers take each round's permutations as
``orders`` (the reference draws them with ``jax.random``), and draw them
from a ``torch.Generator`` only when none are given.

Not ported yet (ROADMAP.md queue 1, item 5): CentralVR-Async
(Algorithm 3), D-SVRG (Algorithm 4), D-SAGA (Algorithm 5).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import convex
from repro_torch.core.convex import Problem
from repro_torch.prox import operators as proxops


class ShardedProblem(NamedTuple):
    """p stacked local shards; the global objective is the mean over all
    p * ns samples (§4 of the paper)."""

    A: torch.Tensor    # (p, ns, d)
    b: torch.Tensor    # (p, ns)
    lam: float
    kind: str

    @property
    def p(self):
        return self.A.shape[0]

    @property
    def ns(self):
        return self.A.shape[1]

    @property
    def d(self):
        return self.A.shape[2]

    def merged(self) -> Problem:
        return Problem(self.A.reshape(-1, self.d), self.b.reshape(-1),
                       self.lam, self.kind)


def check_backend(backend: str, *, spmd_ok: bool = True, algo: str = ""):
    """Validate a driver ``backend=`` argument; the error spellings are the
    reference's (``repro.core.distributed.check_backend``)."""
    if backend not in ("vmap", "spmd"):
        raise ValueError(
            f"unknown backend {backend!r}: expected 'vmap' or 'spmd'")
    if backend == "spmd" and not spmd_ok:
        raise NotImplementedError(
            f"{algo} is event-serial (every event reads the central state "
            "written by the previous event), so it has no worker-parallel "
            "SPMD execution; use backend='vmap', or fetch='stale' for the "
            "wave-parallel staleness construction (DESIGN.md §2)")
    return backend


def shard_problem(prob: Problem, p: int) -> ShardedProblem:
    n = (prob.n // p) * p
    return ShardedProblem(prob.A[:n].reshape(p, -1, prob.d),
                          prob.b[:n].reshape(p, -1), prob.lam, prob.kind)


def make_distributed(gen: torch.Generator, cfg) -> ShardedProblem:
    """Paper §6.2: each worker gets its OWN toy dataset of size cfg.n
    (total data scales linearly with workers — the weak-scaling setup),
    drawn one worker after another from ``gen``."""
    probs = [convex.make_problem(gen, cfg) for _ in range(cfg.workers)]
    return ShardedProblem(torch.stack([q.A for q in probs]),
                          torch.stack([q.b for q in probs]),
                          convex.as_lam(cfg.lam), probs[0].kind)


# ---------------------------------------------------------------------------
# Local epoch primitives, batched over the leading worker axis
# ---------------------------------------------------------------------------

def _local_centralvr_epoch(A, b, lam, kind, x, table, gbar, eta, orders,
                           fused=None, prox=None):
    """One CentralVR epoch on every worker's shard (Alg 2 lines 6-12):
    ``A`` (p, ns, d), ``b`` and ``table`` (p, ns), ``x`` (p, d), ``gbar``
    (p, d) or (d,), ``orders`` (p, T).

    ``fused``: kernel parameters from ``fused.make_params`` — one
    ``vr_update`` launch per step for all workers — or ``None`` for the
    unfused body. ``prox`` is applied per local step,
    ``x <- prox_{eta*g}(x - eta*v)``; when ``fused`` is set the prox rides
    in its parameters. Returns (x, table, acc), acc = each worker's local
    gtilde (data term)."""
    if fused is not None:
        from repro_torch.core import fused as fusedmod
        return fusedmod.centralvr_epoch(A, b, kind, x, table, gbar, orders,
                                        fused)
    ns = A.shape[1]
    rows, labels = convex.gather_epoch(A, b, orders)
    table = table.clone()
    acc = torch.zeros_like(x)
    for t in range(orders.shape[1]):
        a = rows[:, t]
        idx = orders[:, t:t + 1]
        s_new = convex._pointwise_residual(torch.linalg.vecdot(a, x),
                                           labels[:, t], kind)[:, None]
        v = (s_new - table.gather(1, idx)) * a + gbar + 2.0 * lam * x
        table.scatter_(1, idx, s_new)
        acc = acc + s_new * a / ns
        x = proxops.apply_prox(prox, x - eta * v, eta)
    return x, table, acc


def _local_sgd_epoch(A, b, lam, kind, x, eta, orders, prox=None):
    """One plain-SGD epoch on every worker's shard that fills its table
    and accumulator (the initialization of Algorithms 1 and 2)."""
    ns = A.shape[1]
    rows, labels = convex.gather_epoch(A, b, orders)
    table = torch.zeros(b.shape, dtype=A.dtype, device=A.device)
    acc = torch.zeros_like(x)
    for t in range(orders.shape[1]):
        a = rows[:, t]
        s = convex._pointwise_residual(torch.linalg.vecdot(a, x),
                                       labels[:, t], kind)[:, None]
        g = s * a + 2.0 * lam * x
        table.scatter_(1, orders[:, t:t + 1], s)
        acc = acc + s * a / ns
        x = proxops.apply_prox(prox, x - eta * g, eta)
    return x, table, acc


class SyncState(NamedTuple):
    x: torch.Tensor        # (d,) shared iterate
    tables: torch.Tensor   # (p, ns) per-worker scalar tables
    gbar: torch.Tensor     # (d,) shared epoch-frozen mean gradient (data term)


# ---------------------------------------------------------------------------
# CentralVR-Sync (Algorithm 2)
# ---------------------------------------------------------------------------

def sync_init(sp: ShardedProblem, eta: float, perms: torch.Tensor,
              prox=None) -> SyncState:
    """Init with one plain-SGD epoch per worker visiting ``perms`` (p, ns),
    then average (line 2). With a prox, locals take prox'd SGD steps and
    the central average gets one more prox."""
    x0 = torch.zeros((sp.p, sp.d), dtype=sp.A.dtype, device=sp.A.device)
    xs, tables, accs = _local_sgd_epoch(sp.A, sp.b, sp.lam, sp.kind, x0, eta,
                                        perms, prox=prox)
    return SyncState(x=proxops.apply_prox(prox, xs.mean(0), eta),
                     tables=tables, gbar=accs.mean(0))


def sync_round(sp: ShardedProblem, st: SyncState, eta: float,
               perms: torch.Tensor, fused=None, prox=None) -> SyncState:
    """One communication round: a full local epoch everywhere, visiting
    ``perms`` (p, ns), then the central average of (x, gbar) — Algorithm 2
    lines 4-18. Composite objectives apply the prox per local step and
    once more after the central average (the mean of prox outputs is not
    itself one)."""
    xs, tables, accs = _local_centralvr_epoch(
        sp.A, sp.b, sp.lam, sp.kind, st.x.expand(sp.p, sp.d), st.tables,
        st.gbar, eta, perms, fused=fused, prox=prox)
    return SyncState(x=proxops.apply_prox(prox, xs.mean(0), eta),
                     tables=tables, gbar=accs.mean(0))


def draw_sync_orders(gen: torch.Generator, p: int, ns: int, rounds: int):
    """(init (p, ns), per-round (rounds, p, ns)) permutations from ``gen``."""
    def perms():
        return torch.stack([torch.randperm(ns, generator=gen,
                                           device=gen.device)
                            for _ in range(p)])
    init = perms()
    return init, torch.stack([perms() for _ in range(rounds)])


def _as_orders(orders, shapes, device):
    """Explicit orders as int64 tensors on ``device``, shape-checked."""
    init, per = (torch.as_tensor(o, device=device).long() for o in orders)
    for name, t, shape in (("init", init, shapes[0]),
                           ("per-round", per, shapes[1])):
        if tuple(t.shape) != shape:
            raise ValueError(f"orders: {name} orders have shape "
                             f"{tuple(t.shape)}, expected {shape}")
    return init, per


def run_sync(sp: ShardedProblem, *, eta: float, rounds: int, orders=None,
             seed: int = 0, fused=False, prox=None):
    """Algorithm 2 end to end. Returns (final SyncState, per-round
    relative grad norms as a (rounds,) tensor).

    ``orders``: ``(init, per_round)`` permutations, shaped (p, ns) and
    (rounds, p, ns) — for instance the reference's draws
    (``repro_torch.convert.sync_orders``); ``None`` draws them from a
    ``torch.Generator`` seeded with ``seed`` on the problem's device.
    Validation is a ``solver.RunSpec`` build, as in the reference."""
    from repro_torch.core import fused as fusedmod
    from repro_torch.core import solver
    spec = solver.RunSpec(algo="centralvr_sync", p=sp.p, eta=float(eta),
                          rounds=rounds, fused=fused,
                          prox=proxops.canonical(prox))
    device = sp.A.device
    if orders is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        orders = draw_sync_orders(gen, sp.p, sp.ns, rounds)
    init, per = _as_orders(orders, ((sp.p, sp.ns), (rounds, sp.p, sp.ns)),
                           device)
    px = proxops.parse(spec.prox) if spec.prox is not None else None
    fused_t = fusedmod.make_params(spec.fused, eta, sp.lam, device, prox=px)
    st = sync_init(sp, eta, init, prox=px)
    merged = sp.merged()
    g0 = convex.grad_norm0(merged, prox=px, eta=eta)
    rels = []
    for r in range(rounds):
        st = sync_round(sp, st, eta, per[r], fused=fused_t, prox=px)
        rels.append(convex.rel_grad_norm(merged, st.x, g0, prox=px, eta=eta))
    return st, torch.stack(rels)
