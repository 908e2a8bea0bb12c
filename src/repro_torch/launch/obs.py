"""Telemetry record tooling: render or validate ``repro_torch.obs`` JSONL
runs — the port of ``repro/launch/obs.py``.

    python -m repro_torch.launch.obs report run.jsonl
    python -m repro_torch.launch.obs report run.jsonl --json summary.json
    python -m repro_torch.launch.obs validate run.jsonl other.jsonl ...

``report`` prints the span timeline (with the build/warm/device phase
split), streamed-metric summaries, and the notable events (provenance,
launches, comms_measured) of one run record. ``validate`` checks every
row of every file against the v1 schema and exits nonzero on the first
violation. The records of either package validate under the other's.
"""
from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Inspect repro_torch.obs JSONL run records.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="render one record as a "
                                       "timeline/summary")
    rp.add_argument("path", help="JSONL run record")
    rp.add_argument("--json", default="",
                    help="also write the structured summary to this path")
    vp = sub.add_parser("validate", help="schema-check records, exit 1 "
                                         "on violation")
    vp.add_argument("paths", nargs="+", help="JSONL run records")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from repro_torch.obs import report, schema

    if args.cmd == "validate":
        for path in args.paths:
            try:
                n = schema.validate_file(path)
            except (OSError, schema.SchemaError, ValueError) as e:
                print(f"FAIL {path}: {e}")
                return 1
            print(f"ok   {path}: {n} rows")
        return 0

    rows = schema.load_rows(args.path)
    schema.validate_rows(rows)
    print(report.render(rows))
    if args.json:
        s = report.summarize(rows)
        with open(args.json, "w") as f:
            json.dump(s, f, indent=1)
        print(f"\nwrote summary to {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
