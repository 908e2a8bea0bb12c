"""The distributed algorithms of the paper on the convex substrate — the
port of ``repro/core/distributed.py``:

  * CentralVR-Sync   (Algorithm 2)
  * CentralVR-Async  (Algorithm 3): delta algebra + staleness simulator
  * Distributed SVRG (Algorithm 4)
  * Distributed SAGA (Algorithm 5), instant or stale fetch

Workers are a batch dimension: the p local shards are stacked along a
leading axis and step t of a local epoch visits row ``perm[w, t]`` of
every worker's shard at once, where the reference runs the local epochs
under ``jax.vmap``. The central server of the paper is the average across
that axis.

The asynchronous algorithms (3 and 5) are event-serial: the host walks a
deterministic arrival order (``runtime.event_schedule``; round-robin, or
weighted by per-worker ``speeds``), and each event reads the central
state the previous event wrote, so an event runs one worker's steps at
(1, d) and events are never batched across workers.

Randomness is data: the drivers take their draws (permutations or
sample indices) as ``orders`` (the reference draws them with
``jax.random``), and draw them from a ``torch.Generator`` only when none
are given.

``backend="spmd"`` runs the same algorithms with one worker per process
over ``torch.distributed`` (``core/spmd.py``); the asynchronous ones then
run their schedule as concurrency waves, and instant-fetch D-SAGA, a
serial chain of events, refuses it (``check_backend``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import convex, runtime
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
                           fused=None, prox=None, track=False):
    """One CentralVR epoch on every worker's shard (Alg 2 lines 6-12):
    ``A`` (p, ns, d), ``b`` and ``table`` (p, ns), ``x`` (p, d), ``gbar``
    (p, d) or (d,), ``orders`` (p, T).

    ``fused``: kernel parameters from ``fused.make_params`` — one
    ``vr_epoch`` launch for the epoch of all workers — or ``None`` for the
    unfused body. ``prox`` is applied per local step,
    ``x <- prox_{eta*g}(x - eta*v)``; when ``fused`` is set the prox rides
    in its parameters. Returns (x, table, acc), acc = each worker's local
    gtilde (data term); ``track``: and the (p, T, d) iterates before each
    step."""
    if fused is not None:
        from repro_torch.core import fused as fusedmod
        return fusedmod.centralvr_epoch(A, b, kind, x, table, gbar, orders,
                                        fused, track=track)
    ns = A.shape[1]
    rows, labels = convex.gather_epoch(A, b, orders)
    table = table.clone()
    acc = torch.zeros_like(x)
    traj = (x.new_empty((x.shape[0], orders.shape[1], x.shape[1]))
            if track else None)
    for t in range(orders.shape[1]):
        if track:
            traj[:, t] = x
        a = rows[:, t]
        idx = orders[:, t:t + 1]
        s_new = convex._pointwise_residual(torch.linalg.vecdot(a, x),
                                           labels[:, t], kind)[:, None]
        v = (s_new - table.gather(1, idx)) * a + gbar + 2.0 * lam * x
        table.scatter_(1, idx, s_new)
        acc = acc + s_new * a / ns
        x = proxops.apply_prox(prox, x - eta * v, eta)
    return (x, table, acc, traj) if track else (x, table, acc)


def _local_sgd_epoch(A, b, lam, kind, x, eta, orders, prox=None,
                     fused=None):
    """One plain-SGD epoch on every worker's shard that fills its table
    and accumulator (the initialization of Algorithms 1 and 2).

    ``fused``: kernel parameters from ``fused.make_params`` (their prox is
    ``prox``): the epoch runs as the CentralVR lane of one ``vr_epoch``
    launch from a zero table and a zero gbar. That is the SGD epoch only
    when ``orders`` are permutations of each shard: then every table read
    is the zero it started with, and the step's ``s*a - 0*a + 0`` is the
    SGD step's data gradient exactly (the l2 term rides in the kernel's
    decay). A repeated index would read back the residual the epoch wrote,
    so the fused epoch refuses orders that are not permutations (one sync
    a run; the drivers draw permutations)."""
    if fused is not None:
        from repro_torch.core import fused as fusedmod
        n = A.shape[1]
        if orders.shape[-1] != n or not bool(
                (orders.sort(-1).values
                 == torch.arange(n, device=orders.device)).all()):
            raise ValueError("the fused init epoch needs init orders that "
                             "are permutations of each shard; use "
                             "fused=False for other orders")
        return fusedmod.centralvr_epoch(
            A, b, kind, x, torch.zeros(b.shape, dtype=A.dtype,
                                       device=A.device),
            torch.zeros_like(x), orders, fused)
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
              prox=None, fused=None) -> SyncState:
    """Init with one plain-SGD epoch per worker visiting ``perms`` (p, ns),
    then average (line 2). With a prox, locals take prox'd SGD steps and
    the central average gets one more prox. ``fused``: the epoch as one
    ``vr_epoch`` launch (``_local_sgd_epoch``)."""
    x0 = torch.zeros((sp.p, sp.d), dtype=sp.A.dtype, device=sp.A.device)
    xs, tables, accs = _local_sgd_epoch(sp.A, sp.b, sp.lam, sp.kind, x0, eta,
                                        perms, prox=prox, fused=fused)
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


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _randperms(gen: torch.Generator, k: int, n: int) -> torch.Tensor:
    """(k, n): k permutations of range(n)."""
    return torch.stack([torch.randperm(n, generator=gen, device=gen.device)
                        for _ in range(k)])


def _randint(gen: torch.Generator, high: int, shape) -> torch.Tensor:
    return torch.randint(0, high, tuple(shape), generator=gen,
                         device=gen.device)


def draw_sync_orders(gen: torch.Generator, p: int, ns: int, rounds: int):
    """(init (p, ns), per-round (rounds, p, ns)) permutations from ``gen``."""
    init = _randperms(gen, p, ns)
    return init, torch.stack([_randperms(gen, p, ns) for _ in range(rounds)])


def _as_index(t, shape, name: str, device, high: int) -> torch.Tensor:
    """One draw array as an int64 tensor on ``device``, shape-checked and
    range-checked: every index in [0, high). This is the one range check
    of a run's draws (one sync), so the fused epochs launch ``vr_epoch``
    on them without a check of their own (``epoch.vr_epoch_in_range``)."""
    if t is None:
        raise ValueError(f"orders: {name} are missing, expected shape "
                         f"{tuple(shape)}")
    t = torch.as_tensor(t, device=device).long()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"orders: {name} have shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.numel():
        lo, hi = (int(v) for v in torch.aminmax(t))
        if lo < 0 or hi >= high:
            raise ValueError(f"orders: {name} hold indices in [{lo}, {hi}],"
                             f" out of range [0, {high})")
    return t


def _as_orders(orders, shapes, device, high: int,
               names=("init", "per-round")):
    """Explicit (init, per-round) orders as int64 tensors on ``device``,
    shape- and range-checked (indices into a shard of ``high`` rows)."""
    return tuple(_as_index(o, shape, f"{name} orders", device, high)
                 for o, shape, name in zip(orders, shapes, names))


def run_sync(sp: ShardedProblem, *, eta: float, rounds: int, orders=None,
             seed: int = 0, backend: str = "vmap", group=None, fused=False,
             prox=None):
    """Algorithm 2 end to end. Returns (final SyncState, per-round
    relative grad norms as a (rounds,) tensor).

    ``orders``: ``(init, per_round)`` permutations, shaped (p, ns) and
    (rounds, p, ns) — for instance the reference's draws
    (``repro_torch.convert.sync_orders``); ``None`` draws them from a
    ``torch.Generator`` seeded with ``seed`` on the problem's device.
    ``backend="spmd"`` runs one worker per rank of ``group`` (default:
    the default process group's, ``launch.mesh.make_worker_mesh``;
    ``core/spmd.py``). Validation is a ``solver.RunSpec`` build, as in
    the reference."""
    from repro_torch.core import fused as fusedmod
    from repro_torch.core import solver
    spec = solver.RunSpec(algo="centralvr_sync", p=sp.p, eta=float(eta),
                          rounds=rounds, backend=backend, fused=fused,
                          prox=proxops.canonical(prox))
    if spec.backend == "spmd":
        from repro_torch.core import spmd
        return spmd.run_sync(sp, eta=eta, rounds=rounds, orders=orders,
                             seed=seed, group=group, fused=fused,
                             prox=spec.prox)
    device = sp.A.device
    if orders is None:
        orders = draw_sync_orders(_generator(device, seed), sp.p, sp.ns,
                                  rounds)
    init, per = _as_orders(orders, ((sp.p, sp.ns), (rounds, sp.p, sp.ns)),
                           device, sp.ns)
    px = proxops.parse(spec.prox) if spec.prox is not None else None
    fused_t = fusedmod.make_params(spec.fused, eta, sp.lam, device, prox=px)
    st = sync_init(sp, eta, init, prox=px, fused=fused_t)
    merged = sp.merged()
    g0 = convex.grad_norm0(merged, prox=px, eta=eta)
    rels = []
    for r in range(rounds):
        st = sync_round(sp, st, eta, per[r], fused=fused_t, prox=px)
        rels.append(convex.rel_grad_norm(merged, st.x, g0, prox=px, eta=eta))
    return st, torch.stack(rels)


def _put(t: torch.Tensor, s: int, row: torch.Tensor) -> torch.Tensor:
    """``t`` with row ``s`` replaced by ``row`` (a new tensor; the event
    functions leave the state they are given as it was)."""
    t = t.clone()
    t[s] = row
    return t


# ---------------------------------------------------------------------------
# CentralVR-Async (Algorithm 3)
# ---------------------------------------------------------------------------

class AsyncState(NamedTuple):
    x_c: torch.Tensor        # (d,) central iterate
    gbar_c: torch.Tensor     # (d,) central mean gradient (data term)
    tables: torch.Tensor     # (p, ns)
    x_old: torch.Tensor      # (p, d) each worker's previous sent x
    gbar_old: torch.Tensor   # (p, d) each worker's previous sent gbar
    x_fetch: torch.Tensor    # (p, d) central x as of each worker's last fetch
    gbar_fetch: torch.Tensor  # (p, d)


def async_init(sp: ShardedProblem, eta: float, perms: torch.Tensor,
               prox=None, fused=None) -> AsyncState:
    """``sync_init`` visiting ``perms`` (p, ns), with every worker's
    previous contribution and fetch set to the init iterate: Algorithm 3
    line 2 sets x_old = gbar_old = 0 with x_c = x0, which from the
    SGD-init iterate would make the first p events add it a second time
    (same algebra, transient removed, as in the reference)."""
    st = sync_init(sp, eta, perms, prox=prox, fused=fused)

    def tile(v):
        return v.expand(sp.p, -1).clone()

    return AsyncState(x_c=st.x, gbar_c=st.gbar, tables=st.tables,
                      x_old=tile(st.x), gbar_old=tile(st.gbar),
                      x_fetch=tile(st.x), gbar_fetch=tile(st.gbar))


def async_event(sp: ShardedProblem, st: AsyncState, s: int, eta: float,
                perm: torch.Tensor, fused=None, prox=None) -> AsyncState:
    """Worker ``s`` completes one local epoch visiting ``perm`` (ns,) from
    its stale fetch and sends (dx, dgbar); the central node applies
    x += dx/p (Alg 3 l.18-21); the worker then fetches the fresh central
    state.

    Composite objectives: x_c stays LINEAR in the pushed deltas, so the
    prox is never applied to x_c itself; each worker prox's its FETCHED
    copy at epoch start, and the metric is taken at ``prox(x_c)``."""
    alpha = 1.0 / sp.p
    x_new, table, gtilde = (t[0] for t in _local_centralvr_epoch(
        sp.A[s:s + 1], sp.b[s:s + 1], sp.lam, sp.kind,
        proxops.apply_prox(prox, st.x_fetch[s:s + 1], eta),
        st.tables[s:s + 1], st.gbar_fetch[s:s + 1], eta, perm[None],
        fused=fused, prox=prox))
    x_c = st.x_c + alpha * (x_new - st.x_old[s])
    gbar_c = st.gbar_c + alpha * (gtilde - st.gbar_old[s])
    return AsyncState(x_c=x_c, gbar_c=gbar_c,
                      tables=_put(st.tables, s, table),
                      x_old=_put(st.x_old, s, x_new),
                      gbar_old=_put(st.gbar_old, s, gtilde),
                      x_fetch=_put(st.x_fetch, s, x_c),   # receive updated x
                      gbar_fetch=_put(st.gbar_fetch, s, gbar_c))


def draw_async_orders(gen: torch.Generator, p: int, ns: int, rounds: int):
    """(init (p, ns), per-event (rounds * p, ns)) permutations from
    ``gen``; event t of the schedule visits row t."""
    return _randperms(gen, p, ns), _randperms(gen, rounds * p, ns)


def _run_events(sp: ShardedProblem, st, event, schedule, draws, eta: float,
                px, rounds: int):
    """Walk an event schedule one round of p events at a time; event t
    runs ``event(st, worker, draws[t])``. Returns (state, per-round rels
    at ``prox(x_c)``, as a (rounds,) tensor)."""
    merged = sp.merged()
    g0 = convex.grad_norm0(merged, prox=px, eta=eta)
    sched, draws = runtime.per_round(schedule, draws, sp.p)
    rels = []
    for r in range(rounds):
        for s, draw in zip(sched[r].tolist(), draws[r]):
            st = event(st, s, draw)
        rels.append(convex.rel_grad_norm(
            merged, proxops.apply_prox(px, st.x_c, eta), g0, prox=px,
            eta=eta))
    return st, torch.stack(rels)


def run_async(sp: ShardedProblem, *, eta: float, rounds: int, orders=None,
              seed: int = 0, speeds=None, backend: str = "vmap", group=None,
              fused=False, prox=None):
    """Algorithm 3: ``rounds`` epochs per worker, one event at a time in
    the order of ``runtime.event_schedule(p, rounds, speeds)``
    (round-robin by default: staleness p-1; faster workers fire
    proportionally more events). Returns (final AsyncState, per-round
    rels at ``prox(x_c)``).

    ``orders``: ``(init, per_event)`` permutations shaped (p, ns) and
    (rounds * p, ns), per-event rows in schedule order (the reference's
    draws: ``repro_torch.convert.async_orders``); ``None`` draws them from
    a ``torch.Generator`` seeded with ``seed``. ``backend="spmd"`` runs
    the same schedule as concurrency waves, one worker per rank of
    ``group`` (``core/spmd.py``)."""
    from repro_torch.core import fused as fusedmod
    from repro_torch.core import solver
    spec = solver.RunSpec(
        algo="centralvr_async", p=sp.p, eta=float(eta), rounds=rounds,
        backend=backend, fused=fused,
        speeds=None if speeds is None else tuple(float(s) for s in speeds),
        prox=proxops.canonical(prox))
    if spec.backend == "spmd":
        from repro_torch.core import spmd
        return spmd.run_async(sp, eta=eta, rounds=rounds, orders=orders,
                              seed=seed, speeds=spec.speeds, group=group,
                              fused=fused, prox=spec.prox)
    device = sp.A.device
    if orders is None:
        orders = draw_async_orders(_generator(device, seed), sp.p, sp.ns,
                                   rounds)
    init, events = _as_orders(
        orders, ((sp.p, sp.ns), (rounds * sp.p, sp.ns)), device, sp.ns,
        names=("init", "per-event"))
    px = proxops.parse(spec.prox) if spec.prox is not None else None
    fused_t = fusedmod.make_params(spec.fused, eta, sp.lam, device, prox=px)
    st = async_init(sp, eta, init, prox=px, fused=fused_t)
    schedule = runtime.event_schedule(sp.p, rounds, spec.speeds)
    return _run_events(
        sp, st, lambda st, s, perm: async_event(sp, st, s, eta, perm,
                                                fused=fused_t, prox=px),
        schedule, events, eta, px, rounds)


# ---------------------------------------------------------------------------
# Distributed SVRG (Algorithm 4)
# ---------------------------------------------------------------------------

def _svrg_anchors(A, b, lam, kind, xbar, gbar, eta, idx, fused=None,
                  prox=None, snapshot="last", r=None):
    """SVRG inner steps on every worker's shard from the shared snapshot
    ``xbar`` (d,): ``A`` (p, n, d), ``idx`` (p, T), ``gbar`` the full
    regularized gradient at ``xbar``. Returns the anchor each worker
    contributes, (p, d): its last inner iterate (``snapshot="last"``),
    the mean of its T inner iterates (``"avg"``), or its iterate after
    step ``r + 1`` (``"rand"``). ``fused`` (``snapshot="last"`` only):
    one ``vr_epoch`` launch for the steps of all workers."""
    p = A.shape[0]
    x = xbar.expand(p, -1)
    # the snapshot residuals, one matvec per call
    sbar = convex._pointwise_residual(A @ xbar, b, kind)
    if fused is not None:
        from repro_torch.core import fused as fusedmod
        return fusedmod.svrg_steps(A, b, kind, x, sbar, gbar, idx, fused)
    rows, labels = convex.gather_epoch(A, b, idx)
    sbar_t = sbar.gather(1, idx)          # (p, T), in visit order
    total = torch.zeros_like(x)
    anchor = None
    for t in range(idx.shape[1]):
        a = rows[:, t]
        s_new = convex._pointwise_residual(torch.linalg.vecdot(a, x),
                                           labels[:, t], kind)
        g = ((s_new - sbar_t[:, t])[:, None] * a + gbar
             + 2.0 * lam * (x - xbar))
        x = proxops.apply_prox(prox, x - eta * g, eta)
        if snapshot == "avg":
            total = total + x
        elif snapshot == "rand" and t == r:
            anchor = x
    if snapshot == "avg":
        return total / idx.shape[1]
    return x if snapshot == "last" else anchor


def draw_dsvrg_orders(gen: torch.Generator, p: int, ns: int, rounds: int,
                      tau: int, snapshot: str = "last"):
    """(sample indices (rounds, p, tau), anchor indices (rounds,) in
    [0, tau) for ``snapshot="rand"``, else None) from ``gen``."""
    idx = _randint(gen, ns, (rounds, p, tau))
    return idx, (_randint(gen, tau, (rounds,)) if snapshot == "rand"
                 else None)


def run_dsvrg(sp: ShardedProblem, *, eta: float, rounds: int, tau: int = 0,
              orders=None, seed: int = 0, backend: str = "vmap", group=None,
              fused=False, prox=None, snapshot: str = "last"):
    """Algorithm 4: ``tau`` local steps (default 2*ns) on every worker
    from the shared snapshot, gbar = the full gradient at the snapshot
    (the synchronization step), then the average of the workers' anchors
    (``snapshot``: last, avg or rand; avg and rand run unfused, which
    ``fused="auto"`` does silently and RunSpec requires of
    ``fused=True``), prox'd once more. Returns (x, per-round rels).

    ``orders``: ``(idx, snap)``, the sample indices (rounds, p, tau) and,
    for ``snapshot="rand"``, each round's anchor index (rounds,) in
    [0, tau) (else None) — the reference's draws:
    ``repro_torch.convert.dsvrg_orders``; ``None`` draws them from a
    ``torch.Generator`` seeded with ``seed``. ``backend="spmd"``: one
    worker per rank of ``group`` (``core/spmd.py``)."""
    from repro_torch.core import fused as fusedmod
    from repro_torch.core import solver
    spec = solver.RunSpec(algo="dsvrg", p=sp.p, eta=float(eta),
                          rounds=rounds, backend=backend, tau=tau or None,
                          fused=fused, prox=proxops.canonical(prox),
                          snapshot=snapshot)
    if spec.backend == "spmd":
        from repro_torch.core import spmd
        return spmd.run_dsvrg(sp, eta=eta, rounds=rounds, tau=tau,
                              orders=orders, seed=seed, group=group,
                              fused=fused, prox=spec.prox, snapshot=snapshot)
    device = sp.A.device
    px = proxops.parse(spec.prox) if spec.prox is not None else None
    fused_t = (fusedmod.make_params(spec.fused, eta, sp.lam, device,
                                    prox=px)
               if snapshot == "last" else None)
    tau = tau or 2 * sp.ns
    if orders is None:
        orders = draw_dsvrg_orders(_generator(device, seed), sp.p, sp.ns,
                                   rounds, tau, snapshot)
    idx = _as_index(orders[0], (rounds, sp.p, tau), "sample indices",
                    device, sp.ns)
    snap = (_as_index(orders[1], (rounds,), "anchor indices", device, tau)
            .tolist() if snapshot == "rand" else [None] * rounds)
    merged = sp.merged()
    x = torch.zeros(sp.d, dtype=sp.A.dtype, device=device)
    g0 = convex.grad_norm0(merged, prox=px, eta=eta)
    rels = []
    for r in range(rounds):
        anchors = _svrg_anchors(sp.A, sp.b, sp.lam, sp.kind, x,
                                convex.full_grad(merged, x), eta, idx[r],
                                fused=fused_t, prox=px, snapshot=snapshot,
                                r=snap[r])
        x = proxops.apply_prox(px, anchors.mean(0), eta)
        rels.append(convex.rel_grad_norm(merged, x, g0, prox=px, eta=eta))
    return x, torch.stack(rels)


# ---------------------------------------------------------------------------
# Distributed SAGA (Algorithm 5)
# ---------------------------------------------------------------------------

class DSagaState(NamedTuple):
    x_c: torch.Tensor
    gbar_c: torch.Tensor
    tables: torch.Tensor     # (p, ns) scalar residuals
    x_old: torch.Tensor      # (p, d)
    gbar_old: torch.Tensor   # (p, d) literal mode: previous local final gbar


def _local_saga_steps(A, b, lam, kind, x, table, gbar, eta, n_global, idx,
                      fused=None, prox=None):
    """SAGA steps on every worker's shard (Alg 5 lines 5-11): ``A``
    (p, n, d), ``b`` and ``table`` (p, n), ``x`` and ``gbar`` (p, d),
    ``idx`` (p, T). The VR step from the scalar table, then the
    running-mean gbar update with the GLOBAL 1/n scaling (line 9, §5.2).
    ``fused``: one ``vr_epoch`` launch for the steps (saga lane). Returns
    (x, table, gbar)."""
    if fused is not None:
        from repro_torch.core import fused as fusedmod
        return fusedmod.saga_steps(A, b, kind, x, table, gbar, n_global,
                                   idx, fused)
    rows, labels = convex.gather_epoch(A, b, idx)
    table = table.clone()
    for t in range(idx.shape[1]):
        a = rows[:, t]
        i = idx[:, t:t + 1]
        s_new = convex._pointwise_residual(torch.linalg.vecdot(a, x),
                                           labels[:, t], kind)[:, None]
        da = (s_new - table.gather(1, i)) * a
        v = da + gbar + 2.0 * lam * x
        gbar = gbar + da / n_global
        table.scatter_(1, i, s_new)
        x = proxops.apply_prox(prox, x - eta * v, eta)
    return x, table, gbar


def _dsaga_local(sp: ShardedProblem, tables, s: int, x_from, gbar_from,
                 eta: float, idx, fused, prox):
    """Worker ``s``'s tau SAGA steps from the fetched (x, gbar), the
    fetched x prox'd first (x_c stays linear in the pushed deltas, as in
    ``async_event``). Returns (x, table, gbar) of the worker."""
    x, table, gbar = _local_saga_steps(
        sp.A[s:s + 1], sp.b[s:s + 1], sp.lam, sp.kind,
        proxops.apply_prox(prox, x_from[None], eta), tables[s:s + 1],
        gbar_from[None], eta, sp.p * sp.ns, idx[None], fused=fused,
        prox=prox)
    return x[0], table[0], gbar[0]


def dsaga_event(sp: ShardedProblem, st: DSagaState, s: int, eta: float,
                idx: torch.Tensor, literal_scaling: bool = False,
                fused=None, prox=None) -> DSagaState:
    """Worker ``s``: tau = len(idx) local SAGA steps from the current
    central state, then the delta push (Alg 5 lines 12-20). Events run
    one at a time: the paper's implementation is 'locked', one worker
    updates the server at a time (§6.2)."""
    alpha = 1.0 / sp.p
    alpha_g = alpha if literal_scaling else 1.0
    x, table, gbar = _dsaga_local(sp, st.tables, s, st.x_c, st.gbar_c, eta,
                                  idx, fused, prox)
    # literal: the printed line 13; else the worker's own contribution
    dg = gbar - (st.gbar_old[s] if literal_scaling else st.gbar_c)
    return DSagaState(x_c=st.x_c + alpha * (x - st.x_old[s]),
                      gbar_c=st.gbar_c + alpha_g * dg,
                      tables=_put(st.tables, s, table),
                      x_old=_put(st.x_old, s, x),
                      gbar_old=_put(st.gbar_old, s, gbar))


def dsaga_init(sp: ShardedProblem) -> DSagaState:
    """Tables at x0 = 0 (Alg 5 lines 2-3), central gbar = the global
    table mean."""
    x0 = torch.zeros(sp.d, dtype=sp.A.dtype, device=sp.A.device)
    s_all = convex._pointwise_residual(sp.A @ x0, sp.b, sp.kind)
    gbar0 = torch.einsum("psd,ps->d", sp.A, s_all) / (sp.p * sp.ns)
    return DSagaState(x_c=x0, gbar_c=gbar0, tables=s_all,
                      x_old=x0.expand(sp.p, -1).clone(),
                      gbar_old=gbar0.expand(sp.p, -1).clone())


def dsaga_init_stale(sp: ShardedProblem) -> AsyncState:
    """Stale-fetch D-SAGA start state: ``dsaga_init`` plus every worker's
    fetch set to the central values."""
    st = dsaga_init(sp)
    return AsyncState(x_c=st.x_c, gbar_c=st.gbar_c, tables=st.tables,
                      x_old=st.x_old, gbar_old=st.gbar_old,
                      x_fetch=st.x_c.expand(sp.p, -1).clone(),
                      gbar_fetch=st.gbar_c.expand(sp.p, -1).clone())


def dsaga_event_stale(sp: ShardedProblem, st: AsyncState, s: int,
                      eta: float, idx: torch.Tensor,
                      literal_scaling: bool = False, fused=None,
                      prox=None) -> AsyncState:
    """Algorithm 5 with Algorithm 3's fetch discipline: worker ``s`` runs
    its tau local SAGA steps from the central state it fetched at its
    PREVIOUS event; dx against its previous sent x, dgbar against its
    fetched gbar (its own contribution, §5.2), server coefficients as in
    ``dsaga_event``; then it fetches."""
    alpha = 1.0 / sp.p
    alpha_g = alpha if literal_scaling else 1.0
    x, table, gbar = _dsaga_local(sp, st.tables, s, st.x_fetch[s],
                                  st.gbar_fetch[s], eta, idx, fused, prox)
    dg = gbar - (st.gbar_old[s] if literal_scaling else st.gbar_fetch[s])
    x_c = st.x_c + alpha * (x - st.x_old[s])
    gbar_c = st.gbar_c + alpha_g * dg
    return AsyncState(x_c=x_c, gbar_c=gbar_c,
                      tables=_put(st.tables, s, table),
                      x_old=_put(st.x_old, s, x),
                      gbar_old=_put(st.gbar_old, s, gbar),
                      x_fetch=_put(st.x_fetch, s, x_c),
                      gbar_fetch=_put(st.gbar_fetch, s, gbar_c))


def draw_dsaga_orders(gen: torch.Generator, p: int, ns: int, rounds: int,
                      tau: int):
    """Per-event sample indices (rounds * p, tau) from ``gen``."""
    return _randint(gen, ns, (rounds * p, tau))


def run_dsaga(sp: ShardedProblem, *, eta: float, rounds: int,
              tau: int = 100, literal_scaling: bool = False,
              fetch: str | None = None, speeds=None, orders=None,
              seed: int = 0, backend: str = "vmap", group=None, fused=False,
              prox=None):
    """Algorithm 5: per event, a worker runs ``tau`` SAGA steps with its
    local table, the running mean gbar updated with the GLOBAL 1/n
    scaling (§5.2), and pushes (dx, dgbar) with server coefficient 1/p.
    Returns (final state, per-round rels at ``prox(x_c)``).

    dgbar is the worker's OWN table-update contribution (gbar_final -
    gbar_fetched) applied with coefficient 1, so the server's gbar stays
    the global table mean (the §5.2 prose); ``literal_scaling=True`` is
    the printed Algorithm 5 (dgbar against the worker's previous final
    gbar, coefficient 1/p), kept for comparison (EXPERIMENTS.md).

    ``fetch="instant"`` (the default here): each event reads the central
    state the previous event left (a ``DSagaState``). ``fetch="stale"``:
    Algorithm 3's discipline, each worker starts from the central state it
    fetched at its own previous event (an ``AsyncState``). ``speeds``
    weights the event schedule as in :func:`run_async`.

    ``orders``: per-event sample indices (rounds * p, tau), rows in
    schedule order (the reference's draws:
    ``repro_torch.convert.dsaga_orders``); ``None`` draws them from a
    ``torch.Generator`` seeded with ``seed``.

    ``backend="spmd"`` defaults to (and requires) ``fetch="stale"``, run
    as concurrency waves with one worker per rank of ``group``
    (``core/spmd.py``); instant fetch has no worker-parallel program and
    raises."""
    from repro_torch.core import fused as fusedmod
    from repro_torch.core import solver
    spec = solver.RunSpec(
        algo="dsaga", p=sp.p, eta=float(eta), rounds=rounds,
        backend=backend, fetch=fetch,
        speeds=None if speeds is None else tuple(float(s) for s in speeds),
        tau=tau, fused=fused, prox=proxops.canonical(prox))
    if spec.backend == "spmd":
        from repro_torch.core import spmd
        return spmd.run_dsaga(sp, eta=eta, rounds=rounds, tau=tau,
                              literal_scaling=literal_scaling,
                              speeds=spec.speeds, orders=orders, seed=seed,
                              group=group, fused=fused, prox=spec.prox)
    device = sp.A.device
    if orders is None:
        orders = draw_dsaga_orders(_generator(device, seed), sp.p, sp.ns,
                                   rounds, tau)
    idx = _as_index(orders, (rounds * sp.p, tau), "per-event sample indices",
                    device, sp.ns)
    px = proxops.parse(spec.prox) if spec.prox is not None else None
    fused_t = fusedmod.make_params(spec.fused, eta, sp.lam, device, prox=px)
    stale = spec.fetch == "stale"
    event = dsaga_event_stale if stale else dsaga_event
    st = dsaga_init_stale(sp) if stale else dsaga_init(sp)
    schedule = runtime.event_schedule(sp.p, rounds, spec.speeds)
    return _run_events(
        sp, st, lambda st, s, i: event(sp, st, s, eta, i, literal_scaling,
                                       fused=fused_t, prox=px),
        schedule, idx, eta, px, rounds)
