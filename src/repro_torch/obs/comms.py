"""Analytical communication accounting for every registry algorithm —
the port's copy of ``repro/obs/comms.py``.

Bytes-per-collective per communication round, derived from the problem
shapes — no execution required, so every ``RunResult.provenance()`` row
carries its comms model. The convention matches the reference's
``roofline/analysis.py``: **result-shape bytes landed per worker per
collective** (an all-reduce of a (d,) float32 buffer counts d*4 bytes,
whatever the wire algorithm).

Per-round models (d = parameter dimension, B = bytes per element):

  * ``centralvr_sync``  — the Algorithm-2 boundary averages x and gbar:
    2 all-reduces, d*B each.
  * ``dsvrg``           — the sync step's full-gradient all-reduce plus
    the iterate average: 2 all-reduces, d*B each.
  * ``centralvr_async`` / ``dsaga`` — per EVENT the worker pushes
    (dx, dgbar) and fetches (x_c, gbar_c): 2*d*B up + 2*d*B down,
    point-to-point with the central node; p events per round.
  * ``dist_sgd``        — iterate average: 1 all-reduce, d*B.
  * ``easgd``           — elastic exchange with the center: d*B up +
    d*B down per worker per round, point-to-point.
  * ``ps_svrg``         — snapshot full-gradient all-reduce + iterate
    average: 2 all-reduces, d*B each.
  * single-worker algorithms (``centralvr``, ``sgd``, ``svrg``,
    ``saga``) — no communication.
"""
from __future__ import annotations

from typing import Optional

BYTES_PER_EL = 4     # float32, the driver substrate dtype

# algo -> (all_reduce result buffers per round, point-to-point d-sized
#          buffers per worker per round [push + fetch], per_event flag)
_MODELS = {
    "centralvr": (0, 0, False),
    "centralvr_sync": (2, 0, False),
    "centralvr_async": (0, 4, True),
    "dsvrg": (2, 0, False),
    "dsaga": (0, 4, True),
    "sgd": (0, 0, False),
    "svrg": (0, 0, False),
    "saga": (0, 0, False),
    "dist_sgd": (1, 0, False),
    "easgd": (0, 2, False),
    "ps_svrg": (2, 0, False),
}


def coverage_gaps(algos) -> tuple:
    """(missing, extra) vs the comms models — ``missing`` are registry
    algorithms with no comms model (each needs a ``_MODELS`` row before it
    can appear in provenance), ``extra`` are stale models for retired
    algorithms."""
    algos = set(algos)
    return (tuple(sorted(algos - set(_MODELS))),
            tuple(sorted(set(_MODELS) - algos)))


def comms_model(algo: str, *, p: int, d: int, rounds: int,
                bytes_per_el: int = BYTES_PER_EL,
                events_per_round: Optional[int] = None) -> dict:
    """The analytical comms record embedded in provenance (JSON-able).

    ``events_per_round`` defaults to p for the event-scheduled algorithms
    (one event per worker per metric round — the schedule's construction)
    and is ignored for the bulk-synchronous ones.
    """
    if algo not in _MODELS:
        raise ValueError(f"no comms model for algorithm {algo!r}")
    n_allreduce, n_p2p, per_event = _MODELS[algo]
    buf = d * bytes_per_el
    events = (events_per_round if events_per_round is not None else p) \
        if per_event else 0
    allreduce_bytes = n_allreduce * buf
    # point-to-point buffers: per EVENT for the event-scheduled algorithms
    # (each event is one worker's push+fetch with the central node), per
    # worker per round for the bulk-synchronous exchanges (easgd)
    p2p_bytes = n_p2p * buf * (events if per_event else p)
    bytes_per_round = allreduce_bytes + p2p_bytes
    return {
        "algo": algo, "p": int(p), "d": int(d), "rounds": int(rounds),
        "bytes_per_el": int(bytes_per_el),
        "n_allreduce_per_round": int(n_allreduce),
        "allreduce_bytes_per_round": float(allreduce_bytes),
        "events_per_round": int(events),
        "p2p_bytes_per_round": float(p2p_bytes),
        "bytes_per_round": float(bytes_per_round),
        "total_bytes": float(bytes_per_round * rounds),
        "convention": "result-shape bytes per collective "
                      "(roofline/analysis.py)",
    }
