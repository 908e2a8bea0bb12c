"""Share of the time in which no operation runs on the card: one minus
the device-busy time a step (the union of the device operations'
intervals in the traced stretch, over its steps) over the wall time a
step of the untraced rest of the window. The profiler's own buffer
requests stall the host inside the traced stretch, so its length is not
the wall time of the work it holds."""


def read(trace, run):
    if not run or run.get("kind") != "lm_train" or not run["units_traced"]:
        return None
    busy = trace.busy_s / run["units_traced"]
    wall = run["seconds_timed"] / run["units_timed"]
    return 100.0 * (1.0 - busy / wall)
