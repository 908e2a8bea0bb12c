"""Elastic execution of the asynchronous runtime — the port of
``repro/core/elastic.py``.

The event schedule already models workers that run at different speeds;
this module models workers that disappear and come back. Membership
changes take effect only at round boundaries (every round boundary is a
wave boundary), so a dropped worker's last event is fully applied and
its unstarted events are never scheduled.

The determinism contract under repartition (``core/procmesh.py`` runs
the same contract across processes):

  * **survivor schedule**: the remaining rounds are re-planned with
    ``runtime.event_schedule(p_new, rounds_left, survivor speeds)`` over
    the surviving workers in ascending original-id order (the k-th
    smallest survivor becomes compact slot k). Nothing depends on when
    a failure was detected, only on the boundary it took effect at.
  * **state handover**: the central pair ``(x_c, gbar_c)`` is kept, the
    VR tables are re-sharded through their merged ``(n,)`` layout, and
    every per-worker fetch/old vector is reset to the central values
    (the ``async_init`` construction, :func:`resync_state`), so the
    first event after the change counts nothing twice.
  * **continuation draws**: randomness is data. Round 0 uses the draws
    of ``distributed.run_async`` (a ``torch.Generator`` seeded with the
    run's seed: the init permutations, then one per event), so a run
    whose membership never changes equals ``run_async`` bit for bit. The
    shape segment that begins at round r > 0 at width p draws its
    per-event permutations from a generator seeded by
    :func:`segment_seed` ``(seed, r, p)`` (the reference folds ``r`` and
    ``p`` into its run key), so the elastic run and a fresh run started
    at the new shape from the handed-over state consume the same draws.
    Explicit draws — ``(init, {start round: per-event permutations})``,
    for instance the reference's through ``convert.elastic_orders`` —
    replace them.

``fused``: each event is one ``vr_epoch`` launch at (1, d), as in
``distributed.run_async`` (the reference's elastic run ignores its
spec's ``fused``).

Telemetry: membership transitions emit ``worker_lost`` /
``worker_joined`` / ``repartition`` events against the active
``repro_torch.obs`` recorder (their fields pinned in ``obs/schema.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import convex, distributed, runtime
from repro_torch.core.distributed import AsyncState, ShardedProblem
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import stage as obs_stage
from repro_torch.obs import stream as obs_stream


# ---------------------------------------------------------------------------
# Membership as data
# ---------------------------------------------------------------------------

class PlannedMembership:
    """Deterministic membership: ``{round: live original worker ids}``.

    The counterpart of the heartbeat layer in ``core/procmesh.py``: tests
    and the launcher's ``--verify`` replay an observed fault plan through
    it. Round 0 must start with the full fleet; every planned shape is
    validated (non-empty, ids in range, no duplicates) before any torch
    work.
    """

    def __init__(self, p: int,
                 plan: Optional[Dict[int, Sequence[int]]] = None):
        self.p = int(p)
        full = tuple(range(self.p))
        entries = {0: full}
        for r, live in (plan or {}).items():
            live_t = tuple(sorted(int(s) for s in live))
            if not live_t:
                raise ValueError(
                    f"PlannedMembership: round {r} leaves no live workers")
            if len(set(live_t)) != len(live_t):
                raise ValueError(
                    f"PlannedMembership: duplicate worker ids at round {r}: "
                    f"{live}")
            if live_t[0] < 0 or live_t[-1] >= self.p:
                raise ValueError(
                    f"PlannedMembership: worker ids at round {r} out of "
                    f"range for p={self.p}: {live}")
            entries[int(r)] = live_t
        if entries[0] != full:
            raise ValueError(
                "PlannedMembership: round 0 must start with the full fleet "
                f"(0..{self.p - 1}); drop/rejoin at later boundaries")
        self._plan = dict(sorted(entries.items()))

    def live(self, round_: int) -> Tuple[int, ...]:
        """Live original worker ids in effect at ``round_``."""
        out = self._plan[0]
        for r, live in self._plan.items():
            if r <= round_:
                out = live
            else:
                break
        return out

    def change_rounds(self) -> Tuple[int, ...]:
        return tuple(self._plan)


# ---------------------------------------------------------------------------
# Reshard / resync — the state-handover algebra
# ---------------------------------------------------------------------------

def reshard_problem(sp: ShardedProblem, p_new: int) -> ShardedProblem:
    """Contiguously re-shard the GLOBAL dataset over ``p_new`` workers.

    The merged sample order is invariant, so the global objective (and the
    rel-grad-norm metric) is unchanged; ``n`` must divide evenly — a
    silent truncation would change the objective mid-run."""
    merged = sp.merged()
    if merged.n % p_new:
        raise ValueError(
            f"elastic reshard: n={merged.n} samples do not divide over "
            f"p={p_new} workers; pick worker counts that divide n")
    return distributed.shard_problem(merged, p_new)


def merge_tables(tables) -> torch.Tensor:
    """Per-worker ``(p, ns)`` VR tables -> the merged ``(n,)`` layout in
    global sample order (contiguous shards concatenate in worker order)."""
    return torch.as_tensor(tables).reshape(-1)


def resync_state(x_c, gbar_c, table, p_new: int) -> AsyncState:
    """The wave-boundary handover state at a new shape: central pair
    kept, merged table re-sharded, per-worker fetch/old vectors reset to
    the central values (the ``async_init`` construction). Tensors (or
    arrays) in, tensors on their device out."""
    table = torch.as_tensor(table).reshape(-1)
    if table.shape[0] % p_new:
        raise ValueError(
            f"elastic reshard: n={table.shape[0]} table entries do not "
            f"divide over p={p_new} workers")
    x_c = torch.as_tensor(x_c)
    gbar_c = torch.as_tensor(gbar_c)

    def tile(v):
        return v.expand(p_new, -1).clone()

    return AsyncState(x_c=x_c, gbar_c=gbar_c, tables=table.reshape(p_new, -1),
                      x_old=tile(x_c), gbar_old=tile(gbar_c),
                      x_fetch=tile(x_c), gbar_fetch=tile(gbar_c))


def survivor_speeds(speeds, live: Sequence[int]):
    """Compact per-slot speeds for the surviving fleet (speeds stay
    indexed by ORIGINAL worker id so a rejoining worker gets its own speed
    back)."""
    if speeds is None:
        return None
    return tuple(float(speeds[s]) for s in live)


# ---------------------------------------------------------------------------
# Deterministic continuation plan
# ---------------------------------------------------------------------------

def segment_seed(seed: int, start_round: int, p: int) -> int:
    """The seed of the draws of the shape segment that begins at round
    ``start_round`` > 0 at width ``p``: a pure function of the three, so
    every process and every fresh run derives the same stream."""
    seq = np.random.SeedSequence((int(seed), int(start_round), int(p)))
    return int(seq.generate_state(1, dtype=np.uint64)[0])


def segment_draws(seed: int, start_round: int, rounds: int, p: int,
                  ns: int, device) -> torch.Tensor:
    """The per-event permutations ``((rounds - start_round) * p, ns)`` of
    the shape segment that begins at ``start_round``, on ``device``'s
    generator: for round 0 ``run_async``'s (after its init
    permutations), else from :func:`segment_seed`."""
    if start_round == 0:
        return distributed.draw_async_orders(
            distributed._generator(device, seed), p, ns, rounds)[1]
    gen = distributed._generator(device, segment_seed(seed, start_round, p))
    return distributed._randperms(gen, (rounds - start_round) * p, ns)


class ElasticDraws:
    """The draws of an elastic run: the init permutations ``(p0, ns)`` and
    each shape segment's per-event permutations, range-checked once a
    segment. ``orders``: ``(init, {start round: per-event permutations})``
    (``convert.elastic_orders`` replays the reference's); None derives
    them from ``seed`` on ``device``."""

    def __init__(self, p0: int, ns: int, rounds: int, device, *, seed=0,
                 orders=None):
        self.n, self.rounds = p0 * ns, rounds
        self.device, self.seed = device, seed
        if orders is None:
            init, first = distributed.draw_async_orders(
                distributed._generator(device, seed), p0, ns, rounds)
            self._given, self._segments = False, {0: first}
        else:
            init, segments = orders
            self._given, self._segments = True, dict(segments)
        self.init = distributed._as_index(init, (p0, ns), "init orders",
                                          device, ns)

    def segment(self, start: int, p: int) -> torch.Tensor:
        ns = self.n // p
        draws = self._segments.get(start)
        if draws is None:
            if self._given:
                raise ValueError(f"orders: no per-event orders for the "
                                 f"segment that starts at round {start}")
            draws = segment_draws(self.seed, start, self.rounds, p, ns,
                                  self.device)
        return distributed._as_index(
            draws, ((self.rounds - start) * p, ns),
            f"segment {start} per-event orders", self.device, ns)


def segment_plan(start_round: int, rounds: int, p: int, speeds=None, *,
                 draws):
    """``(sched_rows, draw_rows)`` for the shape segment beginning at
    ``start_round``: the event schedule over the remaining rounds at
    width p, and ``draws`` (its per-event permutations, in schedule
    order) per round."""
    schedule = runtime.event_schedule(p, rounds - start_round, speeds)
    return runtime.per_round(schedule, draws, p)


def _rounds(sp: ShardedProblem, st: AsyncState, eta: float, g0, merged,
            sched_rows, draw_rows, fused_t, stream, r0: int):
    """Run whole rounds of events one at a time (``async_event``); the rel
    at ``x_c`` after each. Returns (state, list of 0-d rels)."""
    rels = []
    for i, (row, draws) in enumerate(zip(sched_rows, draw_rows)):
        for s, perm in zip(row.tolist(), draws):
            st = distributed.async_event(sp, st, s, eta, perm, fused=fused_t)
        rels.append(convex.rel_grad_norm(merged, st.x_c, g0))
        if stream is not None:
            stream.push(r0 + i, rels[-1])
    return st, rels


def continue_async(sp: ShardedProblem, st: AsyncState, *, eta: float, g0,
                   start_round: int, rounds: int, draws=None, seed: int = 0,
                   speeds=None, fused=False):
    """The UNINTERRUPTED run at the (possibly new) shape from a
    handed-over state — what every elastic and dropout pin compares
    against. ``speeds`` are the compact per-slot speeds of this shape;
    ``draws`` the segment's per-event permutations (default
    :func:`segment_draws` of ``seed``). Returns ``(state, rels)`` for
    rounds ``start_round..rounds``."""
    from repro_torch.core import fused as fusedmod
    device = sp.A.device
    if draws is None:
        draws = segment_draws(seed, start_round, rounds, sp.p, sp.ns, device)
    draws = distributed._as_index(draws, ((rounds - start_round) * sp.p,
                                          sp.ns), "per-event orders",
                                  device, sp.ns)
    sched_rows, draw_rows = segment_plan(start_round, rounds, sp.p, speeds,
                                         draws=draws)
    fused_t = fusedmod.make_params(fused, eta, sp.lam, device)
    st, rels = _rounds(sp, st, eta, g0, sp.merged(), sched_rows, draw_rows,
                       fused_t, None, start_round)
    return st, torch.stack(rels)


# ---------------------------------------------------------------------------
# The elastic event-serial engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ElasticResult:
    """Uniform elastic return: the metric trajectory (one entry per
    round, across every shape, a tensor), the final state and live set,
    and the membership transitions that actually took effect."""

    rels: torch.Tensor
    state: AsyncState
    live: Tuple[int, ...]
    transitions: List[dict]

    @property
    def final_rel(self) -> float:
        return float(self.rels[-1])


def _emit_transition(rec, r: int, live_old, live_new, detect_s: float):
    lost = sorted(set(live_old) - set(live_new))
    joined = sorted(set(live_new) - set(live_old))
    if rec is not None:
        for s in lost:
            rec.event("worker_lost", worker=int(s), round=int(r),
                      detect_s=float(detect_s))
        for s in joined:
            rec.event("worker_joined", worker=int(s), round=int(r))
        rec.event("repartition", round=int(r), p_old=len(live_old),
                  p_new=len(live_new), survivors=[int(s) for s in live_new])
    return {"round": int(r), "p_old": len(live_old), "p_new": len(live_new),
            "lost": [int(s) for s in lost],
            "joined": [int(s) for s in joined],
            "live": [int(s) for s in live_new]}


def run_async_elastic(sp: ShardedProblem, *, eta: float, rounds: int,
                      seed: int = 0, orders=None,
                      membership: Optional[PlannedMembership] = None,
                      speeds=None, fused=False,
                      checkpoint_dir: Optional[str] = None,
                      checkpoint_every: int = 0) -> ElasticResult:
    """CentralVR-Async (Algorithm 3) under a deterministic membership
    plan: the event-serial engine of elastic execution.

    With the default (constant) membership this equals
    ``distributed.run_async`` bit for bit; at each planned change the
    engine re-partitions per the module contract. ``orders``: see
    :class:`ElasticDraws`. ``fused``: as in ``run_async``.
    ``checkpoint_dir`` saves a mesh-shape-portable checkpoint
    (``checkpoint/elastic.py``) at every repartition boundary and, when
    ``checkpoint_every`` is set, at that round cadence too."""
    from repro_torch.core import fused as fusedmod
    p0 = sp.p
    membership = membership or PlannedMembership(p0)
    if membership.p != p0:
        raise ValueError(
            f"membership plan is for p={membership.p}, problem has p={p0}")
    if speeds is not None and len(speeds) != p0:
        raise ValueError(
            f"speeds must have one entry per original worker (p={p0}), "
            f"got {len(speeds)}")
    # every planned shape is validated before any torch work
    n = p0 * sp.ns
    for r in membership.change_rounds():
        if n % len(membership.live(r)):
            raise ValueError(
                f"elastic reshard: membership at round {r} has "
                f"p={len(membership.live(r))}, which does not divide "
                f"n={n}")

    device = sp.A.device
    draws = ElasticDraws(p0, sp.ns, rounds, device, seed=seed, orders=orders)
    fused_t = fusedmod.make_params(fused, eta, sp.lam, device)

    def run():
        merged = sp.merged()
        g0 = convex.grad_norm0(merged)
        st = distributed.async_init(sp, eta, draws.init, fused=fused_t)
        live = tuple(range(p0))
        sp_cur = sp

        stops = {rounds}
        stops.update(c for c in membership.change_rounds()
                     if 0 < c < rounds)
        if checkpoint_dir and checkpoint_every:
            stops.update(range(checkpoint_every, rounds, checkpoint_every))
        rec = obs_recorder.active()
        stream = obs_stream.open_stream("rel", rounds, device)
        transitions: List[dict] = []
        rels: list = []
        sched_rows = draw_rows = None
        seg_start = r = 0
        for stop in sorted(stops):
            new_live = membership.live(r)
            if new_live != live:
                transitions.append(
                    _emit_transition(rec, r, live, new_live, 0.0))
                table = merge_tables(st.tables)
                sp_cur = reshard_problem(sp, len(new_live))
                st = resync_state(st.x_c, st.gbar_c, table, len(new_live))
                live = new_live
                seg_start = r
                sched_rows = None
            if sched_rows is None:
                sched_rows, draw_rows = segment_plan(
                    seg_start, rounds, len(live),
                    survivor_speeds(speeds, live),
                    draws=draws.segment(seg_start, len(live)))
            lo, hi = r - seg_start, stop - seg_start
            st, chunk = _rounds(sp_cur, st, eta, g0, merged,
                                sched_rows[lo:hi], draw_rows[lo:hi], fused_t,
                                stream, r)
            rels += chunk
            r = stop
            if checkpoint_dir and r < rounds:
                from repro_torch.checkpoint import elastic as ckpt
                ckpt.save_elastic(f"{checkpoint_dir}/elastic_{r:05d}", st,
                                  round_=r, live=live, p0=p0)
        if stream is not None:
            stream.close()
        return ElasticResult(rels=torch.stack(rels), state=st, live=live,
                             transitions=transitions)

    return obs_stage.staged_call(run, _label="solve/centralvr_async",
                                 _device=device)
