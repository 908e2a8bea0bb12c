"""repro_torch.obs — structured run telemetry, the port of ``repro.obs``.

One JSONL record per run (spans, streamed per-round metrics, counters,
comms/staleness accounting), OFF by default and without cost when off:
no sync, copy, event or launch is added to a run unless a recorder is
active. While a ``torch.profiler`` records, the spans also go to an
in-process log (``spans()``) that a device trace can be aligned with
(``obs/timeline.py``), with no sync. The rows follow the reference's
schema at the same version, so either package's validator accepts the
other's records.

Quickstart::

    from repro_torch import obs, solve, RunSpec
    from repro_torch.configs.paper_convex import PRESETS

    with obs.recording("run.jsonl"):
        res = solve(RunSpec(algo="centralvr_async", p=4, eta=0.05,
                            rounds=40, speeds=(4.0, 2.0, 1.0, 1.0)),
                    PRESETS["dist-toy-logistic"])
    # then: python -m repro_torch.launch.obs report run.jsonl

Pieces:

  * :mod:`repro_torch.obs.recorder` — the JSONL sink (``Recorder``),
    module recorder slot (``enable``/``disable``/``active``/``recording``),
    the no-op-safe ``span`` helper, on under a recorder or a
    ``torch.profiler``, its in-process log (``spans``), and the counted
    host reads of device values (``host_read``, ``counters``).
  * :mod:`repro_torch.obs.timeline` — the span log on a device trace's
    time base: the alignment from its host reads, and which span the host
    was in at a moment of the trace.
  * :mod:`repro_torch.obs.stage`    — ``staged_call``: one ``execute``
    span around a driver's run, with its CUDA-event device time and
    kernel launches.
  * :mod:`repro_torch.obs.stream`   — per-round metric streaming through
    pinned copies and CUDA events, never a sync in the round loop.
  * :mod:`repro_torch.obs.comms`    — analytical bytes-per-collective
    models.
  * :mod:`repro_torch.obs.staleness`— fetch-staleness histogram + wave
    stats from the deterministic async event schedule.
  * :mod:`repro_torch.obs.schema`   — row schema, validators, and the
    golden provenance key sets the tests pin.
  * :mod:`repro_torch.obs.report`   — timeline/summary rendering for the
    ``repro_torch.launch.obs`` CLI.
"""
from __future__ import annotations

from repro_torch.obs.comms import comms_model
from repro_torch.obs.recorder import (Recorder, active, counters, disable,
                                      enable, host_read, recording, span,
                                      spans)
from repro_torch.obs.schema import SCHEMA_VERSION, SchemaError, validate_file
from repro_torch.obs.stage import staged_call
from repro_torch.obs.staleness import staleness_stats
from repro_torch.obs.stream import stream_active

__all__ = [
    "Recorder", "active", "enable", "disable", "recording", "span",
    "spans", "host_read", "counters",
    "staged_call", "stream_active",
    "comms_model", "staleness_stats",
    "SCHEMA_VERSION", "SchemaError", "validate_file",
]
