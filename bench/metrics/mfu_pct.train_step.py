"""Share of the card's bf16 peak that a training step achieves: the
model's forward and backward FLOPs of the traced steps (from the
configuration's shapes, ``bench/cost/lm.py``, recompute not counted) of
the untraced rest of the traced run's window, over its length on the
host's clock, against 989 TFLOP/s."""
from bench.cost import lm, peaks


def read(trace, run):
    if not run or run.get("kind") != "lm_train" or not run["units_timed"]:
        return None
    flops = lm.step_flops(run["config"], run["traffic"]) * run["units_timed"]
    return 100.0 * flops / run["seconds_timed"] / peaks.BF16_FLOPS
