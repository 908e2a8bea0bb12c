"""Render a JSONL run record into a human-readable timeline/summary — the
port of ``repro/obs/report.py``, behind the ``repro_torch.launch.obs``
CLI (``report`` subcommand).

The phase split differs from the reference's by design. The port compiles
no program per call, so there is no ``lower`` phase; its one compile is
the hand-written kernels' ``nvcc`` build, so ``compile_s`` sums the
``kernels/build`` spans. ``warm_s`` sums the ``/execute`` spans, as in
the reference, and ``device_s`` their ``device_ms`` (CUDA events around
the call, recorded on the card only). A serving record (``launch/serve.py
--obs``) also gets a ``serving`` summary: the admits and retirements, the
mean live decode lanes, and the ``serve_report`` event's throughput and
latency.
"""
from __future__ import annotations

from typing import List

from repro_torch.obs import schema


def _fmt_s(v: float) -> str:
    return f"{v * 1e3:8.1f} ms" if v < 1.0 else f"{v:8.2f} s "


def summarize(rows: List[dict]) -> dict:
    """Structured summary of a run record: spans (timeline order), metric
    streams, events, and the derived build-vs-warm-vs-device split."""
    spans = sorted((r for r in rows if r["kind"] == "span"),
                   key=lambda r: r["t0"])
    metrics: dict = {}
    for r in rows:
        if r["kind"] == "metric":
            m = metrics.setdefault(r["name"], {"count": 0, "first_step": None,
                                               "last_step": None,
                                               "last_value": None})
            m["count"] += 1
            if m["first_step"] is None:
                m["first_step"] = r["step"]
            m["last_step"], m["last_value"] = r["step"], r["value"]
    events = [r for r in rows if r["kind"] == "event"]
    compile_s = sum(r["dur_s"] for r in spans if r["name"] == "kernels/build")
    execute = [r for r in spans if r["name"].endswith("/execute")]
    warm_s = sum(r["dur_s"] for r in execute)
    device_s = sum(r.get("device_ms", 0.0) for r in execute) / 1e3
    return {"run": rows[0]["run"] if rows else None,
            "n_rows": len(rows), "spans": spans, "metrics": metrics,
            "events": events, "compile_s": compile_s, "warm_s": warm_s,
            "device_s": device_s, "serving": _serving(rows, events)}


def _serving(rows: List[dict], events: List[dict]):
    """The serve record's summary, or None for a record without serving:
    admits and retirements counted, the mean of the live-lane metric, and
    the last ``serve_report`` event's fields."""
    reports = [e for e in events if e["name"] == "serve_report"]
    if not reports:
        return None
    lanes = [r["value"] for r in rows if r["kind"] == "metric"
             and r["name"] == "serve/decode_live_lanes"]
    base = ("v", "run", "t", "kind", "name")
    return {"admits": sum(e["name"] == "serve_admit" for e in events),
            "retires": sum(e["name"] == "serve_retire" for e in events),
            "mean_live_lanes": sum(lanes) / len(lanes) if lanes else None,
            "report": {k: v for k, v in reports[-1].items()
                       if k not in base}}


def render(rows: List[dict]) -> str:
    """The ``report`` CLI's output: timeline + summaries, one string."""
    s = summarize(rows)
    out = [f"run {s['run']}  ({s['n_rows']} rows)"]

    if s["spans"]:
        out.append("")
        out.append("spans (timeline):")
        for r in s["spans"]:
            flag = "  FAILED" if r.get("failed") else ""
            out.append(f"  t={r['t0']:9.3f}s  {_fmt_s(r['dur_s'])}  "
                       f"{r['name']}{flag}")
        if s["compile_s"] or s["warm_s"]:
            out.append(f"  phase split: build {s['compile_s']:.3f}s  "
                       f"warm(execute) {s['warm_s']:.3f}s  "
                       f"device {s['device_s']:.3f}s")

    if s["metrics"]:
        out.append("")
        out.append("streamed metrics:")
        for name, m in sorted(s["metrics"].items()):
            out.append(f"  {name}: {m['count']} rows, steps "
                       f"{m['first_step']}..{m['last_step']}, "
                       f"last value {m['last_value']:.6g}")

    serving = s["serving"]
    if serving:
        rep = serving["report"]
        out.append("")
        out.append(f"serving ({rep.get('path', 'engine')}):")
        out.append(f"  {rep.get('requests')} requests, {rep.get('steps')} "
                   f"steps; {serving['admits']} admitted, "
                   f"{serving['retires']} retired")
        out.append(f"  prefill {rep.get('prefill_tokens')} tokens at "
                   f"{rep.get('prefill_tok_s', 0.0):.1f} tok/s; decode "
                   f"{rep.get('decode_tokens')} tokens at "
                   f"{rep.get('decode_tok_s', 0.0):.1f} tok/s")
        lanes = serving["mean_live_lanes"]
        out.append(f"  latency p50 {rep.get('latency_p50_s', 0.0):.4f} s, "
                   f"p95 {rep.get('latency_p95_s', 0.0):.4f} s"
                   + (f"; live decode lanes {lanes:.2f} on average"
                      if lanes is not None else ""))

    interesting = [e for e in s["events"]
                   if e["name"] not in ("run_start",)]
    if interesting:
        out.append("")
        out.append("events:")
        for e in interesting:
            body = {k: v for k, v in e.items()
                    if k not in ("v", "run", "t", "kind", "name")}
            if e["name"] == "provenance":
                stal = (body.get("staleness") or {})
                comms = (body.get("comms") or {})
                brief = {"algo": (body.get("spec") or {}).get("algo"),
                         "final_rel": body.get("final_rel"),
                         "staleness_hist": stal.get("histogram"),
                         "bytes_per_round": comms.get("bytes_per_round")}
                out.append(f"  t={e['t']:9.3f}s  {e['name']}: {brief}")
            else:
                out.append(f"  t={e['t']:9.3f}s  {e['name']}: {body}")
    return "\n".join(out)


def render_file(path: str) -> str:
    rows = schema.load_rows(path)
    schema.validate_rows(rows)
    return render(rows)
