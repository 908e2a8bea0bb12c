"""The fused convex epoch's share of its roofline: the bytes one epoch of
p workers over their shards needs (``bench/cost/convex.py``) at the HBM
peak, over the mean device time of a launch of the kernels named
below."""
from bench.cost import convex, peaks

KERNELS = ("vr_epoch_kernel",)


def read(trace, run):
    if not run or run.get("kind") != "convex_sync":
        return None
    seconds, launches = trace.kernel(KERNELS)
    if not launches:
        return None
    need = convex.vr_epoch_bytes(run["workers"], run["rows"],
                                 run["features"]) / peaks.HBM_BYTES
    return 100.0 * need / (seconds / launches)
