"""Device idle time a solve: the idle gaps of the device trace whose
middle falls inside a solve, a root span ``solve`` of
``repro_torch.obs.spans()`` put on the trace's time base by
``repro_torch.obs.timeline.align`` (from the ``sync/<site>`` spans of
the counted host reads), summed and taken a solve. A program without the
span log, a log that does not hold each traced solve, or one that no
runtime call of the trace aligns, gives nothing."""
import numpy as np


def read(trace, run):
    if not run or run.get("kind") != "convex_sync" or not run["units_traced"]:
        return None
    try:
        from repro_torch import obs
        from repro_torch.obs import timeline
        spans = obs.spans()
    except (ImportError, AttributeError):
        return None
    solves = timeline.roots(spans, "solve")
    if len(solves) != run["units_traced"]:
        return None
    alignment = timeline.align(spans, trace.host)
    if alignment is None:
        return None
    t0 = alignment.us([s["t0_ns"] for s in solves])
    t1 = alignment.us([s["t1_ns"] for s in solves])
    gaps = np.array(trace.gaps(), dtype=np.float64).reshape(-1, 2)
    mid = gaps.mean(1)
    k = np.searchsorted(t0, mid, side="right") - 1
    inside = (k >= 0) & (mid <= t1[np.maximum(k, 0)])
    idle_us = float((gaps[inside, 1] - gaps[inside, 0]).sum())
    return idle_us * 1e-3 / len(solves)
