"""Device operations (kernels, copies, fills) a communication round of a
solve: all of the traced solves' device operations over their rounds.
A count of the host's dispatch work."""


def read(trace, run):
    if not run or run.get("kind") != "convex_sync":
        return None
    return trace.device_ops / (run["units_traced"] * run["rounds"])
