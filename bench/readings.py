"""Readings of a cell's correctness check over many seeds, in one
process: what the limits in ``bench/limits/<cell>.json`` are set from.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 \
        [--variant sound|control|<fault>]

``sound`` runs the program as the configuration states it; ``control``
the configuration in the next lower precision (the LM cells: weights and
VR state in bfloat16, the port's own path; the convex cells: the plain
reference in float32 in the program's place); a fault name plants that
fault of the kind's ``FAULTS`` in the program. Each seed makes the
cell's inputs at its own size, drives what a run's check compares, with
no measured window, and prints one JSON line of the numbers. The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time

from run import _environment     # bench/ is the script's path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="sound")
    args = ap.parse_args(argv)
    _environment()
    import contextlib

    import torch

    from bench.harness import cells
    cell = cells.cell(args.workload)
    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    module = cell.module
    variant = args.variant
    ctx = (module.FAULTS[variant]() if variant in module.FAULTS
           else contextlib.nullcontext())
    with ctx:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            vals = module.readings(
                cell, seed, device,
                variant="control" if variant == "control" else None)
            print(json.dumps({"workload": args.workload, "variant": variant,
                              "seed": seed, **vals,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
