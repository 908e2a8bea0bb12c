"""The spmd backend of the convex drivers — the port of
``repro/core/spmd.py``: one CentralVR worker per process (rank) over
``torch.distributed``, where the reference runs one worker per device of
a mesh under ``shard_map``.

Each rank holds only its own worker's state, on its own device: its
shard of the problem (ns x d) and its labels, its VR table and its
accumulator, and for the asynchronous drivers its stale fetch and its
previous contribution, all with a leading worker axis of 1, so the
port's batched local functions (``distributed._local_centralvr_epoch``,
``_local_sgd_epoch``, ``_svrg_anchors``, ``_local_saga_steps``,
``baselines._sgd_steps``) run on it unchanged: with ``fused``, each
local epoch is one ``vr_epoch`` launch at (1, d) on the rank's device.
The central state is replicated, and bit-identical on every rank: every
reference ``pmean`` is an ``all_reduce`` (sum) and a divide by p, every
``all_gather`` a ``dist.all_gather``; the collectives hand every rank the
same bytes, and every rank then runs the same ops on them.

Randomness is data, as in the reference: each runner takes the same
``orders`` as the port's vmap driver (its ``draw_*_orders``, or the
reference's draws through ``repro_torch.convert``), checked once, and
slices its own worker's rows. With no orders, every rank draws the whole
set with the vmap driver's generator on its device and keeps its rows.

The asynchronous drivers (CentralVR-Async, stale-fetch D-SAGA) run their
event schedule as rounds of concurrent events
(``runtime.wave_partition``): every worker of a wave runs its local
epoch from the central state it fetched at its previous event, the
wave's (p, d) deltas are all-gathered and pushed in the schedule's order
(``_wave_push``). A rank that is inactive in a wave runs no epoch and
launches nothing (host control flow takes the place of the reference's
masks), and joins the wave's all-gather with zero deltas.

Transport: the group's (``launch/mesh.py``). PyTorch's gloo would stage
CUDA tensors through host memory; the collectives here do it in the
open, copying a CUDA tensor to pinned host memory and back around a
gloo collective. The rank waits for the copy on an event that blocks
instead of spinning: ranks that share a card also share the host's
cores with gloo's threads, and a spinning wait starves them (PS-SVRG's
all-reduce a step took 23 ms so on an H100 with 8 ranks). NCCL takes the
rank's CUDA tensors directly.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import convex, runtime
from repro_torch.core.convex import Problem
from repro_torch.launch.mesh import WorkerGroup, check_world
from repro_torch.obs import stage as obs_stage
from repro_torch.prox import operators as proxops


# ---------------------------------------------------------------------------
# Group, placement, collectives
# ---------------------------------------------------------------------------

def _check_group(group, p: int) -> WorkerGroup:
    """``group``, or the default group's (``mesh.make_worker_mesh``);
    refuses a world that is not p with the reference's wording."""
    if group is None:
        from repro_torch.launch import mesh
        group = mesh.make_worker_mesh(p)
    check_world(group.world, p)
    return group


def _spmd_span(label: str):
    """Run a runner ``fn(sp, ..., group=...)`` through
    ``obs.staged_call``: with a recorder active, one ``<label>/execute``
    span on this rank and the ``comms_measured`` event of its
    collectives."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(sp, *, group=None, **kw):
            g = _check_group(group, sp.p)
            return obs_stage.staged_call(fn, sp, group=g, _label=label,
                                         _device=g.device, _group=g, **kw)
        return run
    return wrap


def _shard(sp, g: WorkerGroup):
    """This rank's shard of the stacked problem, copied onto its device:
    (A (1, ns, d), b (1, ns)) — the reference's ``_put``."""
    r = g.rank
    return (sp.A[r:r + 1].to(g.device, copy=True),
            sp.b[r:r + 1].to(g.device, copy=True))


def _staged(g: WorkerGroup, t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` goes through a host copy: gloo on a
    CUDA tensor."""
    return g.transport == "gloo" and t.is_cuda


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t``, waited for on a
    blocking event (no spinning)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event(blocking=True)
    done.record()
    done.synchronize()
    return host


def psum_(t: torch.Tensor, g: WorkerGroup) -> torch.Tensor:
    """``t`` summed over the ranks, in place (an ``all_reduce``)."""
    import torch.distributed as dist

    if _staged(g, t):
        host = _to_host(t)
        dist.all_reduce(host, group=g.group)
        t.copy_(host, non_blocking=True)
    else:
        dist.all_reduce(t, group=g.group)
    g.carried_bytes += t.numel() * t.element_size()
    g.collectives += 1
    return t


def pmean(t: torch.Tensor, g: WorkerGroup) -> torch.Tensor:
    """The mean of ``t`` over the ranks: the reference's
    ``jax.lax.pmean``, an all-reduce sum divided by p on the rank's
    device."""
    return psum_(t.clone(), g).div_(g.world)


def all_gather(t: torch.Tensor, g: WorkerGroup) -> torch.Tensor:
    """(p, *t.shape): every rank's ``t`` in rank order."""
    import torch.distributed as dist

    staged = _staged(g, t)
    src = _to_host(t) if staged else t.contiguous()
    out = torch.empty((g.world,) + tuple(src.shape), dtype=src.dtype,
                      device=src.device, pin_memory=staged)
    dist.all_gather(list(out.unbind(0)), src, group=g.group)
    if staged:
        out = out.to(t.device, non_blocking=True)
    g.carried_bytes += out.numel() * out.element_size()
    g.collectives += 1
    return out


def pmax_(t: torch.Tensor, g: WorkerGroup) -> torch.Tensor:
    """``t`` maxed over the ranks, in place."""
    import torch.distributed as dist

    if g.world == 1:
        return t
    if _staged(g, t):
        host = _to_host(t)
        dist.all_reduce(host, op=dist.ReduceOp.MAX, group=g.group)
        t.copy_(host, non_blocking=True)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g.group)
    g.carried_bytes += t.numel() * t.element_size()
    g.collectives += 1
    return t


def all_gather_dim(t: torch.Tensor, g: WorkerGroup, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (the
    shards of a leaf split along ``dim``); ``t`` itself in a group of
    one."""
    if g.world == 1:
        return t
    out = all_gather(t, g)                    # (p, *t.shape)
    return torch.cat(out.unbind(0), dim=dim)


def reduce_scatter_dim(t: torch.Tensor, g: WorkerGroup,
                       dim: int) -> torch.Tensor:
    """``t`` summed over the ranks and split along ``dim`` into p equal
    shards, this rank's shard returned (the adjoint of
    :func:`all_gather_dim`)."""
    import torch.distributed as dist

    if g.world == 1:
        return t
    staged = _staged(g, t)
    src = _to_host(t) if staged else t
    parts = [c.contiguous() for c in src.chunk(g.world, dim=dim)]
    out = torch.empty_like(parts[0], pin_memory=staged)
    dist.reduce_scatter(out, parts, group=g.group)
    if staged:
        out = out.to(t.device, non_blocking=True)
    g.carried_bytes += out.numel() * out.element_size()
    g.collectives += 1
    return out


# ---------------------------------------------------------------------------
# In-shard metric helpers
# ---------------------------------------------------------------------------

def _rel_grad_norm(local: Problem, x, g0, g: WorkerGroup, prox=None,
                   eta=None):
    """The paper's y-axis on the GLOBAL objective, from one shard: every
    worker holds ns samples, so the mean of the shards' data gradients
    is the merged problem's; with a prox, the gradient-mapping norm
    (``convex.rel_grad_norm``'s metric)."""
    s = convex.scalar_residual_all(local, x)
    data = pmean(convex.data_grad_from_scalars(local, s), g)
    full = data + 2.0 * local.lam * x
    if prox is None:
        return torch.linalg.norm(full) / g0
    return torch.linalg.norm(proxops.grad_map(prox, x, full, eta)) / g0


def _full_grad(local: Problem, x, g: WorkerGroup):
    """The global full gradient: the mean of the shards' full gradients
    (the replicated 2*lam*x term averages to itself)."""
    return pmean(convex.full_grad(local, x), g)


def _grad_norm0(local: Problem, g: WorkerGroup, prox=None, eta=None):
    """``convex.grad_norm0`` of the merged problem, from the shards."""
    zero = torch.zeros(local.d, dtype=local.A.dtype, device=local.A.device)
    g0 = _rel_grad_norm(local, zero, 1.0, g, prox=prox, eta=eta)
    return torch.where(g0 == 0.0, torch.ones_like(g0), g0)


def _setup(sp, group, prox):
    """The parts every runner starts from: (group, A, b, local problem,
    parsed prox)."""
    g = _check_group(group, sp.p)
    A, b = _shard(sp, g)
    px = proxops.parse(prox) if prox is not None else None
    return g, A, b, Problem(A[0], b[0], sp.lam, sp.kind), px


def _fused(flag, eta, lam, g: WorkerGroup, px):
    from repro_torch.core import fused as fusedmod
    return fusedmod.make_params(flag, eta, lam, g.device, prox=px)


# ---------------------------------------------------------------------------
# CentralVR-Sync (Algorithm 2)
# ---------------------------------------------------------------------------

@_spmd_span("spmd/centralvr_sync")
def run_sync(sp, *, eta: float, rounds: int, orders=None, seed: int = 0,
             group=None, fused=False, prox=None):
    """Algorithm 2 with one worker per rank: the init epoch and every
    round's local epoch on this rank's shard, then the central average
    of (x, gbar) as collectives. Prox placement as
    ``distributed.sync_round``: per local step, and once more after the
    average. Returns (SyncState with this rank's (1, ns) table, (rounds,)
    rels); x, gbar and rels are replicated."""
    from repro_torch.core import distributed as ds

    g, A, b, local, px = _setup(sp, group, prox)
    if orders is None:
        orders = ds.draw_sync_orders(ds._generator(g.device, seed), sp.p,
                                     sp.ns, rounds)
    init, per = ds._as_orders(orders, ((sp.p, sp.ns), (rounds, sp.p, sp.ns)),
                              g.device, sp.ns)
    me = slice(g.rank, g.rank + 1)
    fused_t = _fused(fused, eta, sp.lam, g, px)
    g0 = _grad_norm0(local, g, px, eta)

    x0 = torch.zeros((1, sp.d), dtype=A.dtype, device=g.device)
    x_w, table, acc = ds._local_sgd_epoch(A, b, sp.lam, sp.kind, x0, eta,
                                          init[me], prox=px, fused=fused_t)
    x = proxops.apply_prox(px, pmean(x_w[0], g), eta)
    gbar = pmean(acc[0], g)
    rels = []
    for r in range(rounds):
        x_w, table, acc = ds._local_centralvr_epoch(
            A, b, sp.lam, sp.kind, x[None], table, gbar, eta, per[r, me],
            fused=fused_t, prox=px)
        x = proxops.apply_prox(px, pmean(x_w[0], g), eta)
        gbar = pmean(acc[0], g)
        rels.append(_rel_grad_norm(local, x, g0, g, prox=px, eta=eta))
    return ds.SyncState(x=x, tables=table, gbar=gbar), torch.stack(rels)


# ---------------------------------------------------------------------------
# Distributed SVRG (Algorithm 4)
# ---------------------------------------------------------------------------

@_spmd_span("spmd/dsvrg")
def run_dsvrg(sp, *, eta: float, rounds: int, tau: int = 0, orders=None,
              seed: int = 0, group=None, fused=False, prox=None,
              snapshot: str = "last"):
    """Algorithm 4 with one worker per rank: the snapshot's full gradient
    as a collective (the sync step), ``tau`` local steps on this rank's
    shard (one ``vr_epoch`` launch when fused, snapshot "last"), then the
    average of the anchors, prox'd once more. Returns (x, rels),
    replicated."""
    from repro_torch.core import distributed as ds

    g, A, b, local, px = _setup(sp, group, prox)
    fused_t = (_fused(fused, eta, sp.lam, g, px) if snapshot == "last"
               else None)
    tau = tau or 2 * sp.ns
    if orders is None:
        orders = ds.draw_dsvrg_orders(ds._generator(g.device, seed), sp.p,
                                      sp.ns, rounds, tau, snapshot)
    idx = ds._as_index(orders[0], (rounds, sp.p, tau), "sample indices",
                       g.device, sp.ns)
    snap = (ds._as_index(orders[1], (rounds,), "anchor indices", g.device,
                         tau).tolist() if snapshot == "rand"
            else [None] * rounds)
    me = slice(g.rank, g.rank + 1)
    g0 = _grad_norm0(local, g, px, eta)
    x = torch.zeros(sp.d, dtype=A.dtype, device=g.device)
    rels = []
    for r in range(rounds):
        anchor = ds._svrg_anchors(A, b, sp.lam, sp.kind, x,
                                  _full_grad(local, x, g), eta, idx[r, me],
                                  fused=fused_t, prox=px, snapshot=snapshot,
                                  r=snap[r])
        x = proxops.apply_prox(px, pmean(anchor[0], g), eta)
        rels.append(_rel_grad_norm(local, x, g0, g, prox=px, eta=eta))
    return x, torch.stack(rels)


# ---------------------------------------------------------------------------
# Minibatch baselines
# ---------------------------------------------------------------------------

@_spmd_span("spmd/dist_sgd")
def run_dist_sgd(sp, *, eta: float, rounds: int, tau: int = 0,
                 decay: float = 0.0, orders=None, seed: int = 0,
                 group=None):
    """Distributed SGD with one worker per rank: ``tau`` local steps, then
    the average. Returns (x, rels), replicated."""
    from repro_torch.core import baselines as bl
    from repro_torch.core import distributed as ds

    g, A, b, local, _ = _setup(sp, group, None)
    tau = tau or sp.ns
    if orders is None:
        orders = bl.draw_dist_sgd_orders(ds._generator(g.device, seed),
                                         sp.p, sp.ns, rounds, tau)
    idx = ds._as_index(orders, (rounds, sp.p, tau), "sample indices",
                       g.device, sp.ns)
    me = slice(g.rank, g.rank + 1)
    g0 = _grad_norm0(local, g)
    x = torch.zeros(sp.d, dtype=A.dtype, device=g.device)
    rels = []
    for r in range(rounds):
        eta_r = eta / (1.0 + decay * r * tau) ** 0.5
        xl = bl._sgd_steps(A, b, sp.lam, sp.kind, x[None], eta_r, idx[r, me])
        x = pmean(xl[0], g)
        rels.append(_rel_grad_norm(local, x, g0, g))
    return x, torch.stack(rels)


@_spmd_span("spmd/easgd")
def run_easgd(sp, *, eta: float, rounds: int, tau: int = 16,
              rho: float = 1.0, decay: float = 0.0, orders=None,
              seed: int = 0, group=None):
    """EASGD with one worker per rank: its blocks of ``tau`` SGD steps,
    each with the elastic move against its view of the center, then the
    center's update from the mean of the workers' moves. Returns (xc,
    rels), replicated."""
    from repro_torch.core import baselines as bl
    from repro_torch.core import distributed as ds

    g, A, b, local, _ = _setup(sp, group, None)
    alpha = min(0.9 / sp.p, eta * rho * tau)
    steps_per_round = max(sp.ns // tau, 1)
    if orders is None:
        orders = bl.draw_easgd_orders(ds._generator(g.device, seed), sp.p,
                                      sp.ns, rounds, tau)
    idx = ds._as_index(orders, (rounds, sp.p, steps_per_round, tau),
                       "sample indices", g.device, sp.ns)
    me = slice(g.rank, g.rank + 1)
    g0 = _grad_norm0(local, g)
    xc = torch.zeros(sp.d, dtype=A.dtype, device=g.device)
    xl = torch.zeros((1, sp.d), dtype=A.dtype, device=g.device)
    rels = []
    for r in range(rounds):
        eta_r = eta / (1.0 + decay * r * sp.ns) ** 0.5
        xc_view = xc[None]
        moves = torch.zeros_like(xl)
        for j in range(steps_per_round):
            xl = bl._sgd_steps(A, b, sp.lam, sp.kind, xl, eta_r,
                               idx[r, me, j])
            diff = xl - xc_view
            xl = xl - alpha * diff
            xc_view = xc_view + alpha * diff
            moves = moves + diff
        xc = xc + alpha * pmean(moves[0], g)
        rels.append(_rel_grad_norm(local, xc, g0, g))
    return xc, torch.stack(rels)


@_spmd_span("spmd/ps_svrg")
def run_ps_svrg(sp, *, eta: float, rounds: int, epoch_mult: int = 2,
                orders=None, seed: int = 0, group=None):
    """Parameter-server SVRG with one worker per rank: per round the
    snapshot's full gradient as a collective, then ``epoch_mult * ns``
    server steps, each the mean of the workers' corrected gradients (one
    all-reduce a step). Returns (x, rels), replicated."""
    from repro_torch.core import baselines as bl
    from repro_torch.core import distributed as ds

    g, A, b, local, _ = _setup(sp, group, None)
    inner = epoch_mult * sp.ns
    if orders is None:
        orders = bl.draw_ps_svrg_orders(ds._generator(g.device, seed), sp.p,
                                        sp.ns, rounds, epoch_mult)
    idx = ds._as_index(orders, (rounds, inner, sp.p), "sample indices",
                       g.device, sp.ns)
    g0 = _grad_norm0(local, g)
    x = torch.zeros(sp.d, dtype=A.dtype, device=g.device)
    rels = []
    for r in range(rounds):
        xbar = x
        gbar = _full_grad(local, xbar, g)
        order = idx[r, :, g.rank:g.rank + 1].T           # (1, inner)
        rows, labels = convex.gather_epoch(A, b, order)
        sbar = convex._pointwise_residual(torch.linalg.vecdot(rows, xbar),
                                          labels, sp.kind)
        for t in range(inner):
            a = rows[:, t]
            s = convex._pointwise_residual(a @ x, labels[:, t], sp.kind)
            g_w = ((s - sbar[:, t])[:, None] * a + gbar
                   + 2.0 * sp.lam * (x - xbar))
            x = x - eta * pmean(g_w[0], g)
        rels.append(_rel_grad_norm(local, x, g0, g))
    return x, torch.stack(rels)


# ---------------------------------------------------------------------------
# Async drivers (Algorithms 3 and 5) as concurrency waves
# ---------------------------------------------------------------------------

def _scatter_events(draws, schedule, slot, shape):
    """Arrange per-event draws ``(total, ...)``, rows in flat schedule
    order, into the ``(rounds, W, p, ...)`` wave layout of
    ``runtime.wave_partition``; inactive slots keep zeros (index 0 is
    valid everywhere, and no rank reads them)."""
    rounds, width, p = shape
    out = draws.new_zeros((rounds * width, p) + tuple(draws.shape[1:]))
    dev = draws.device
    out[torch.as_tensor(slot, device=dev),
        torch.as_tensor(schedule, dtype=torch.int64, device=dev)] = draws
    return out.reshape((rounds, width, p) + tuple(draws.shape[1:]))


def _wave_push(x_c, gbar_c, dxs, dgs, rk, my_rank, alpha, alpha_g):
    """Apply a wave's delta pushes to the central state and reconstruct
    this worker's fresh fetch. ``dxs``/``dgs`` are the all-gathered
    (p, d) deltas (zero where inactive); the event-serial driver adds them
    one event at a time, so worker w's fetch, the central state right
    after ITS event, is the prefix over ranks ``rk <= my_rank`` of the
    wave (inactive workers carry the sentinel p and a zero delta). The
    sums run over the worker axis in index order. Returns (x_c', gbar_c',
    x_f, g_f)."""
    pre = (rk <= my_rank)[:, None]
    x_f = x_c + alpha * torch.where(pre, dxs, 0.0).sum(0)
    g_f = gbar_c + alpha_g * torch.where(pre, dgs, 0.0).sum(0)
    x_c = x_c + alpha * dxs.sum(0)
    gbar_c = gbar_c + alpha_g * dgs.sum(0)
    return x_c, gbar_c, x_f, g_f


def _run_waves(g: WorkerGroup, sp, rounds: int, speeds, draws, state,
               event, local, g0, eta, px, alpha_g):
    """Walk the wave plan of ``runtime.event_schedule(p, rounds,
    speeds)``: per wave, this rank runs ``event(state, draw)`` when it is
    active (``-> (x_new, table, gb, dg)``), the wave's deltas are
    all-gathered ((p, 2d): dx beside dg) and pushed. ``state`` is this
    rank's [x_c, gbar_c, table, x_old, gbar_old, x_fetch, gbar_fetch].
    Returns (state, per-round rels at ``prox(x_c)``)."""
    schedule = runtime.event_schedule(sp.p, rounds, speeds)
    active, rank, slot = runtime.wave_partition(schedule, sp.p)
    mine = _scatter_events(draws, schedule, slot, active.shape)[:, :, g.rank]
    rank_t = torch.as_tensor(rank, dtype=torch.int64, device=g.device)
    alpha, d = 1.0 / sp.p, sp.d
    x_c, gbar_c, table, x_old, gbar_old, x_fetch, gbar_fetch = state
    rels = []
    for r in range(active.shape[0]):
        for w in range(active.shape[1]):
            on = bool(active[r, w, g.rank])
            if on:
                x_new, table_new, gb, dg = event(
                    x_fetch, gbar_fetch, x_old, gbar_old, table, mine[r, w])
                delta = torch.cat([x_new - x_old, dg])
            else:
                delta = x_c.new_zeros(2 * d)
            both = all_gather(delta, g)
            x_c, gbar_c, x_f, g_f = _wave_push(
                x_c, gbar_c, both[:, :d], both[:, d:], rank_t[r, w],
                rank_t[r, w, g.rank], alpha, alpha_g)
            if on:
                table, x_old, gbar_old = table_new, x_new, gb
                x_fetch, gbar_fetch = x_f, g_f
        rels.append(_rel_grad_norm(local, proxops.apply_prox(px, x_c, eta),
                                   g0, g, prox=px, eta=eta))
    state = (x_c, gbar_c, table, x_old, gbar_old, x_fetch, gbar_fetch)
    return state, torch.stack(rels)


def _async_state(state):
    """This rank's AsyncState, the per-worker fields with a leading axis
    of 1 as the reference's spmd runners return them."""
    from repro_torch.core.distributed import AsyncState
    x_c, gbar_c, table, x_old, gbar_old, x_fetch, gbar_fetch = state
    return AsyncState(x_c=x_c, gbar_c=gbar_c, tables=table,
                      x_old=x_old[None], gbar_old=gbar_old[None],
                      x_fetch=x_fetch[None], gbar_fetch=gbar_fetch[None])


@_spmd_span("spmd/centralvr_async")
def run_async(sp, *, eta: float, rounds: int, orders=None, seed: int = 0,
              speeds=None, group=None, fused=False, prox=None):
    """Algorithm 3 as concurrency waves: the schedule, the draws and the
    delta algebra of ``distributed.run_async``, each worker's epochs on
    its own rank. Prox placement as ``distributed.async_event``: each
    worker prox's its fetched copy at epoch start, x_c stays linear in
    the deltas, the metric is taken at ``prox(x_c)``. Returns (AsyncState
    of this rank, per-round rels)."""
    from repro_torch.core import distributed as ds

    g, A, b, local, px = _setup(sp, group, prox)
    if orders is None:
        orders = ds.draw_async_orders(ds._generator(g.device, seed), sp.p,
                                      sp.ns, rounds)
    init, events = ds._as_orders(
        orders, ((sp.p, sp.ns), (rounds * sp.p, sp.ns)), g.device, sp.ns,
        names=("init", "per-event"))
    fused_t = _fused(fused, eta, sp.lam, g, px)
    g0 = _grad_norm0(local, g, px, eta)

    # init == async_init: one SGD epoch per worker, the average, and every
    # worker's previous contribution and fetch set to it
    x0 = torch.zeros((1, sp.d), dtype=A.dtype, device=g.device)
    x_w, table, acc = ds._local_sgd_epoch(
        A, b, sp.lam, sp.kind, x0, eta, init[g.rank:g.rank + 1], prox=px,
        fused=fused_t)
    x_c = proxops.apply_prox(px, pmean(x_w[0], g), eta)
    gbar_c = pmean(acc[0], g)

    def event(x_fetch, gbar_fetch, x_old, gbar_old, table, perm):
        x_new, table, gtilde = (t[0] for t in ds._local_centralvr_epoch(
            A, b, sp.lam, sp.kind,
            proxops.apply_prox(px, x_fetch[None], eta), table,
            gbar_fetch[None], eta, perm[None], fused=fused_t, prox=px))
        return x_new, table[None], gtilde, gtilde - gbar_old

    state = (x_c, gbar_c, table, x_c, gbar_c, x_c, gbar_c)
    state, rels = _run_waves(g, sp, rounds, speeds, events, state, event,
                             local, g0, eta, px, 1.0 / sp.p)
    return _async_state(state), rels


@_spmd_span("spmd/dsaga")
def run_dsaga(sp, *, eta: float, rounds: int, tau: int = 100,
              literal_scaling: bool = False, speeds=None, orders=None,
              seed: int = 0, group=None, fused=False, prox=None):
    """Stale-fetch Algorithm 5 as concurrency waves: the spmd execution of
    ``distributed.dsaga_event_stale`` (prox'd fetch, linear central
    accumulator, metric at ``prox(x_c)``). Returns (AsyncState of this
    rank, per-round rels)."""
    from repro_torch.core import distributed as ds

    g, A, b, local, px = _setup(sp, group, prox)
    if orders is None:
        orders = ds.draw_dsaga_orders(ds._generator(g.device, seed), sp.p,
                                      sp.ns, rounds, tau)
    idx = ds._as_index(orders, (rounds * sp.p, tau),
                       "per-event sample indices", g.device, sp.ns)
    fused_t = _fused(fused, eta, sp.lam, g, px)
    g0 = _grad_norm0(local, g, px, eta)
    n_global = sp.p * sp.ns

    # init == dsaga_init: tables at x0, central gbar the global table mean
    x0 = torch.zeros(sp.d, dtype=A.dtype, device=g.device)
    table = convex.scalar_residual_all(local, x0)[None]
    gbar_c = pmean(convex.data_grad_from_scalars(local, table[0]), g)

    def event(x_fetch, gbar_fetch, x_old, gbar_old, table, idx_w):
        x, table, gb = (t[0] for t in ds._local_saga_steps(
            A, b, sp.lam, sp.kind, proxops.apply_prox(px, x_fetch[None], eta),
            table, gbar_fetch[None], eta, n_global, idx_w[None],
            fused=fused_t, prox=px))
        return x, table[None], gb, gb - (gbar_old if literal_scaling
                                         else gbar_fetch)

    state = (x0, gbar_c, table, x0, gbar_c, x0, gbar_c)
    state, rels = _run_waves(g, sp, rounds, speeds, idx, state, event,
                             local, g0, eta, px,
                             1.0 / sp.p if literal_scaling else 1.0)
    return _async_state(state), rels


# ---------------------------------------------------------------------------
# Algorithm 1 (single worker)
# ---------------------------------------------------------------------------

def run_centralvr(prob: Problem, *, eta: float, epochs: int, orders=None,
                  seed: int = 0, sampling: str = "permutation", x0=None,
                  group=None, fused=False, prox=None):
    """Algorithm 1 has no worker axis to shard: ``backend="spmd"`` runs it
    on this rank's device in a group of world 1, so a launcher addresses
    one API whatever the backend."""
    from repro_torch.core import centralvr

    g = _check_group(group, 1)
    prob = prob._replace(A=prob.A.to(g.device), b=prob.b.to(g.device))
    if x0 is not None:
        x0 = torch.as_tensor(x0).to(g.device)
    return centralvr.run(prob, eta=eta, epochs=epochs, orders=orders,
                         seed=seed, sampling=sampling, x0=x0, fused=fused,
                         prox=prox)
