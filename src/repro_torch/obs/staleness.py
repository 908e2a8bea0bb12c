"""Fetch-staleness and wave-utilization accounting for the async drivers
— the port's copy of ``repro/obs/staleness.py``, over the port's
``core/runtime.py``.

The asynchronous runs (CentralVR-Async, stale-fetch D-SAGA) are
deterministic: the arrival order is the event schedule
(``runtime.event_schedule``), and each worker runs its local block from
the central state it fetched at its own previous event. The fetch
staleness of an event is the number of OTHER events applied to the
central state between the worker's fetch and this event:

    staleness(t) = t - prev_event_of_worker(t) - 1

Round-robin schedules give every post-warmup event staleness p-1;
heterogeneous ``speeds`` spread the histogram. The first event of each
worker measures staleness against the shared t=0 fetch, i.e. staleness
= t.

Wave utilization describes the spmd backend's concurrency
(``runtime.wave_partition``): how many waves each metric round splits
into and what fraction of the p ranks each wave occupies. Everything
here is host-side numpy over the schedule, O(rounds * p).
"""
from __future__ import annotations

import numpy as np


def staleness_stats(schedule, p: int) -> dict:
    """Per-event fetch-staleness histogram + wave stats (JSON-able)."""
    # imported here: the core package imports this one (no import cycle)
    from repro_torch.core import runtime

    schedule = np.asarray(schedule, dtype=np.int64)
    total = int(schedule.size)
    if total % p:
        raise ValueError(
            f"schedule size {total} is not a multiple of p={p}")
    rounds = total // p
    prev = np.full(p, -1, dtype=np.int64)
    stal = np.empty(total, dtype=np.int64)
    for t, s in enumerate(schedule.tolist()):
        stal[t] = t - prev[s] - 1
        prev[s] = t
    values, counts = np.unique(stal, return_counts=True)

    active, _, _ = runtime.wave_partition(schedule, p)
    # waves actually used per round (the trailing waves of a round can be
    # all-inactive padding up to the global width)
    used = active.any(axis=2)                   # (rounds, W)
    waves_per_round = used.sum(axis=1)
    occupancy = active.sum(axis=(1, 2)) / np.maximum(
        waves_per_round * p, 1)                 # events / (waves * p)
    return {
        "p": int(p),
        "events": total,
        "rounds": rounds,
        "histogram": {str(int(v)): int(c) for v, c in zip(values, counts)},
        "mean": float(stal.mean()),
        "max": int(stal.max()),
        "min": int(stal.min()),
        "waves_per_round_mean": float(waves_per_round.mean()),
        "waves_per_round_max": int(waves_per_round.max()),
        "wave_occupancy_mean": float(occupancy.mean()),
    }
