"""Runs one cell of the port's benchmark once and prints its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1

from the root of a checkout that holds ``src/repro_torch``. The cell's
configuration, traffic mix and limits are found by the names that
``BENCHMARK.json`` gives (``bench/harness/cells.py``). Set-up, the
measured window and the correctness check are those of the
configuration's kind (``bench/kinds/<kind>.py``); this file adds the card check, the per-layer
readers (``--trace 1``), the check that no JAX module was loaded, and
the result line: the last line of standard output, one JSON object.

Exit status: 0 with a result line; 2 without a card (or too few) and
without a result line; 3 when a forbidden module was loaded.
"""
import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "bench" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment():
    """Caches inside the checkout, at fixed paths; the repo's packages on
    the path."""
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(cell, out, trace: bool, device_info: dict) -> dict:
    from bench.harness import cells
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"]).read(out.trace, out.run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info = dict(device_info, busy_s=out.trace.busy_s,
                           window_s=out.trace.window_s)
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    line = {"correct": bool(out.correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics,
            "device": dict(device_info,
                           memory_peak_bytes=int(out.memory_peak_bytes))}
    if trace:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from bench.harness import cells
    cell = cells.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = cell.module.run(cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device,
                          clock0=CLOCK0)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips}
    line = result_line(cell, out, bool(args.trace), info)
    for k, v in out.e2e.items():
        if k not in line["metrics"]:
            print(f"info {k} {v!r}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
