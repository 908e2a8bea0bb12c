"""K3's share of its roofline: one causal attention forward's FLOPs and
bytes from the shapes (``bench/cost/lm.py``), the larger of the two
bounds at the card's peaks, over the mean device time of a launch of the
kernels named below (the forward and its recompute launch alike)."""
from bench.cost import lm, peaks

KERNELS = ("flash_fwd",)


def read(trace, run):
    if not run or run.get("kind") != "lm_train":
        return None
    seconds, launches = trace.kernel(KERNELS)
    if not launches:
        return None
    _, H, KV, hd, _, _, _ = lm.dims(run["config"])
    t = run["traffic"]
    flops, nbytes = lm.flash_fwd(t["seq"], H, KV, hd, t["microbatch"])
    need = max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)
    return 100.0 * need / (seconds / launches)
