"""K1's share of its roofline in the LM's VR step: the bytes one fused
step over (W, N) float32 state needs (``bench/cost/lm.py``), at the HBM
peak, over the mean device time of a launch of the kernels named below."""
from bench.cost import lm, peaks

KERNELS = ("vr_update_kernel",)


def read(trace, run):
    if not run or run.get("kind") != "lm_train":
        return None
    seconds, launches = trace.kernel(KERNELS)
    if not launches:
        return None
    need = lm.k1_bytes(run["params"], run["workers"]) / peaks.HBM_BYTES
    return 100.0 * need / (seconds / launches)
