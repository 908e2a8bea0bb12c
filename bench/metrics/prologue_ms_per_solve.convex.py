"""Host time a solve spends before its rounds: the spans ``solve/build``
(the problem's placement and ``auto_eta``) and ``solve/orders`` (the
range check of the visit orders) of ``repro_torch.obs.spans()``, each
ending in a host read, summed over the traced solves (the root spans
``solve``) and taken a solve. A program without the span log, or a log
that does not hold each traced solve, gives nothing."""

PHASES = ("solve/build", "solve/orders")


def read(trace, run):
    if not run or run.get("kind") != "convex_sync" or not run["units_traced"]:
        return None
    try:
        from repro_torch import obs
        from repro_torch.obs import timeline
        spans = obs.spans()
    except (ImportError, AttributeError):
        return None
    solves = len(timeline.roots(spans, "solve"))
    phases = [s for s in spans if s["name"] in PHASES]
    if solves != run["units_traced"] or len(phases) != len(PHASES) * solves:
        return None
    return sum(s["t1_ns"] - s["t0_ns"] for s in phases) * 1e-6 / solves
