"""Device time of a round's residual, |grad f(x)| / |grad f(0)|
(``convex.rel_grad_norm``): the CUDA-event time of the spans ``solve/rel``
of ``repro_torch.obs.spans()``, one a round, over the traced solves'
rounds. The span ``solve/rel0`` (|grad f(0)|, once a solve) is left
out. A program without the span log, or a log that does not hold each
traced round, gives nothing."""


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
    rel = [s["device_ms"] for s in spans if s["name"] == "solve/rel"]
    if (solves != run["units_traced"] or len(rel) != solves * run["rounds"]
            or None in rel):
        return None
    return sum(rel) / len(rel)
