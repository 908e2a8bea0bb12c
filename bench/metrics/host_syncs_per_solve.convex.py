"""Host reads of device values a solve: the program's counter of
``repro_torch.obs.host_read`` over the reads made while the profiler
recorded (``obs.counters(traced=True)``), over the traced solves, the
root spans ``solve`` of ``obs.spans()``. Each read drains the stream, and
the device idles until the host launches again. A program without the
counter, or a log that does not hold each traced solve, gives nothing."""


def read(trace, run):
    if not run or run.get("kind") != "convex_sync" or not run["units_traced"]:
        return None
    try:
        from repro_torch import obs
        from repro_torch.obs import timeline
        spans, reads = obs.spans(), obs.counters(traced=True)
    except (ImportError, AttributeError):
        return None
    solves = len(timeline.roots(spans, "solve"))
    if solves != run["units_traced"]:
        return None
    return sum(reads.values()) / solves
