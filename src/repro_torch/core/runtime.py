"""The event-schedule algebra of the asynchronous drivers — the port's
copy of the pure-numpy part of ``repro/core/runtime.py``.

The asynchronous arrival order is data: a flat ``(rounds * p,)`` int32
worker-index array computed on the host (speed-weighted for the
heterogeneous-cluster simulation). The event-serial drivers
(``distributed.run_async``, ``distributed.run_dsaga``) walk it one round
of p events at a time (:func:`per_round`); :func:`wave_partition` and
:func:`wave_flatten` group it into the concurrency waves of the
worker-parallel backend, and :func:`repartition_schedule` re-plans it
after an elastic membership change. Every output is byte-identical to
the reference's.
"""
from __future__ import annotations

import numpy as np


def event_schedule(p: int, rounds: int, speeds=None) -> np.ndarray:
    """The asynchronous arrival order as data: a ``(rounds * p,)`` int32
    worker-index array.  ``speeds=None`` gives round-robin (effective
    staleness p-1); otherwise faster workers fire proportionally more
    events — the deterministic simulation of a heterogeneous cluster.
    Precomputed on the host once.

    Vectorized as a sorted merge of per-worker arrival streams: worker s's
    k-th event lands at cumsum_k(1/speeds[s]), and the greedy
    pick-the-earliest loop is exactly the (time, worker)-lexicographic
    merge of those streams.  ``np.cumsum`` accumulates sequentially, the
    same float additions as the seed loop's ``t_next[s] += 1/speeds[s]``,
    so ties — and therefore the output — are byte-identical to
    ``_event_schedule_loop`` while dropping the O(rounds·p) host loop per
    driver call.
    """
    if speeds is None:
        return np.tile(np.arange(p, dtype=np.int32), rounds)
    speeds = np.asarray(speeds, dtype=float)
    if speeds.shape != (p,):
        raise ValueError(f"speeds must have shape ({p},), got {speeds.shape}")
    total = rounds * p
    # Cap each worker's candidate stream: the time of the last popped
    # event is at most tau = (total + p)/sum(speeds) (every worker j has
    # at least floor(tau*speed_j) arrivals before tau, and those already
    # sum to >= total), so no worker can win more than
    # ceil(tau*speed_max) slots.  +4 slack absorbs float accumulation
    # drift.  This keeps the merge O(total) memory for near-uniform
    # speeds instead of O(total*p); only a worker fast enough to win most
    # slots pushes the cap back toward `total`.
    cap = int(np.ceil((total + p) * speeds.max() / speeds.sum())) + 4
    m = min(total, cap)
    # (p, m) arrival times: row s is the times worker s could fire
    step = np.broadcast_to((1.0 / speeds)[:, None], (p, m))
    arrivals = np.cumsum(step, axis=1)
    workers = np.broadcast_to(
        np.arange(p, dtype=np.int32)[:, None], (p, m))
    # primary key: arrival time; tie-break: lowest worker index (argmin's
    # first-minimum rule in the seed loop)
    order = np.lexsort((workers.ravel(), arrivals.ravel()))
    return np.ascontiguousarray(workers.ravel()[order[:total]])


def repartition_schedule(survivors, rounds: int, speeds=None):
    """The deterministic survivor schedule after an elastic membership
    change (DESIGN.md §Multi-host & elasticity): the k-th smallest
    surviving ORIGINAL worker id becomes compact slot k, and the
    remaining ``rounds`` are re-planned as a fresh ``event_schedule`` at
    the new width from the survivors' own speeds (``speeds`` stays
    indexed by original id).  Returns ``(schedule, id_map)`` where
    ``schedule`` is over compact slots and ``id_map[slot]`` is the
    original worker id — nothing depends on when the failure was
    detected, only on the boundary it took effect at."""
    id_map = np.asarray(sorted(int(s) for s in survivors), dtype=np.int32)
    if id_map.size == 0:
        raise ValueError("repartition_schedule: no survivors")
    if np.unique(id_map).size != id_map.size:
        raise ValueError(f"repartition_schedule: duplicate survivor ids "
                         f"{survivors}")
    sub = None if speeds is None else [float(speeds[s]) for s in id_map]
    return event_schedule(id_map.size, rounds, sub), id_map


def _event_schedule_loop(p: int, rounds: int, speeds) -> np.ndarray:
    """Seed implementation of the speed-weighted schedule, kept verbatim as
    the byte-identical reference for the vectorized merge above."""
    speeds = np.asarray(speeds, dtype=float)
    if speeds.shape != (p,):
        raise ValueError(f"speeds must have shape ({p},), got {speeds.shape}")
    t_next = 1.0 / speeds
    schedule = np.empty(rounds * p, dtype=np.int32)
    for t in range(rounds * p):
        s = int(np.argmin(t_next))
        schedule[t] = s
        t_next[s] += 1.0 / speeds[s]
    return schedule


def wave_partition(schedule: np.ndarray, p: int):
    """Partition a flat event schedule into *concurrency waves* for the
    spmd-async backend (DESIGN.md §2): within each metric round (p
    consecutive events) the events are grouped greedily into maximal waves
    that contain each worker at most once.  A worker's local epoch depends
    only on the central state it fetched at its OWN previous event, never
    on the other events of its wave, so all events of a wave can execute
    concurrently, one worker per device; the delta pushes are then applied at
    the wave boundary in event order (the rank below).  Round-robin
    schedules produce exactly one wave per round; heterogeneous-speed
    schedules split a round wherever a worker fires twice.

    Returns ``(active, rank, slot)``:

      * ``active``: ``(rounds, W, p)`` bool — worker s fires in wave w of
        round r (W = max waves per round; padded waves are all-inactive);
      * ``rank``: ``(rounds, W, p)`` int32 — the event's position within
        its wave (the prefix order of the stale-fetch construction);
        ``p`` sentinel where inactive;
      * ``slot``: ``(rounds * p,)`` int64 — flat wave index ``r * W + w``
        of event t, so per-event host-precomputed RNG draws can be
        scattered to their (round, wave, worker) slot.

    Concatenating the waves in order — each wave's workers sorted by rank
    — reproduces ``schedule`` byte-identically (``wave_flatten``)."""
    schedule = np.asarray(schedule, dtype=np.int32)
    if schedule.size % p:
        raise ValueError(
            f"schedule size {schedule.size} is not a multiple of p={p}")
    rounds = schedule.size // p
    sched = schedule.reshape(rounds, p)
    per_round_waves = []
    for r in range(rounds):
        waves = [[]]
        seen: set = set()
        for s in sched[r].tolist():
            if s in seen:
                waves.append([])
                seen = set()
            seen.add(s)
            waves[-1].append(s)
        per_round_waves.append(waves)
    width = max(len(w) for w in per_round_waves)
    active = np.zeros((rounds, width, p), dtype=bool)
    rank = np.full((rounds, width, p), p, dtype=np.int32)
    slot = np.empty(schedule.size, dtype=np.int64)
    t = 0
    for r, waves in enumerate(per_round_waves):
        for w, wave in enumerate(waves):
            for k, s in enumerate(wave):
                active[r, w, s] = True
                rank[r, w, s] = k
                slot[t] = r * width + w
                t += 1
    return active, rank, slot


def wave_flatten(active: np.ndarray, rank: np.ndarray) -> np.ndarray:
    """Inverse of :func:`wave_partition`: the flat event schedule implied
    by the wave arrays — the byte-identical-order pin."""
    rounds, width, _ = active.shape
    out = []
    for r in range(rounds):
        for w in range(width):
            workers = np.nonzero(active[r, w])[0]
            out.extend(workers[np.argsort(rank[r, w, workers])].tolist())
    return np.asarray(out, dtype=np.int32)


def per_round(schedule: np.ndarray, keys, p: int):
    """Reshape a flat event schedule + per-event draws (a numpy array or a
    tensor) into per-round rows ``(rounds, p, ...)``, so a loop over
    rounds (emitting the metric) can nest the round's p events."""
    rounds = schedule.size // p
    sched = schedule.reshape(rounds, p)
    keys = keys.reshape((rounds, p) + keys.shape[1:])
    return sched, keys
