"""The run recorder: structured telemetry rows to a JSONL sink — the port's
copy of ``repro/obs/recorder.py``.

One :class:`Recorder` per run: every row it writes carries the run id, a
monotonic timestamp relative to the recorder's start, and a ``kind``
(``span`` / ``metric`` / ``event``) whose required fields are pinned by
``obs/schema.py``. Rows are appended to one JSONL file under a lock, so
rows written from other threads interleave safely with the main thread's
spans.

Telemetry is OFF by default: the module-level active recorder is ``None``
until :func:`enable` (or the :func:`recording` context manager) installs
one, and every producer checks :func:`active` first, so the telemetry-off
program is the program without telemetry: no sync, copy or launch more.

While ``torch.profiler`` records, each span also opens a
``torch.profiler.record_function`` of its name, so a ``--profile`` trace
and the JSONL record name the same phases; with no profiler running that
is skipped. This module imports torch only if the program already has.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
import uuid
from typing import IO, Optional

SCHEMA_VERSION = 1

_LOCK = threading.Lock()          # guards the module-level active recorder
_ACTIVE: Optional["Recorder"] = None


def profiled(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else a null context."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class Recorder:
    """JSONL telemetry sink for one run.

    ``path`` is the target file (created/truncated on construction; parent
    directories are created). ``stream_every`` gates the streamed metric
    cadence: a ``metric`` row is dropped unless ``step % stream_every ==
    0`` (drivers emit every round and the recorder keeps the cadence
    subset, so enabling telemetry never changes what a run computes).
    """

    def __init__(self, path: str, *, run_id: Optional[str] = None,
                 stream_every: int = 1):
        if stream_every < 1:
            raise ValueError(f"stream_every: need >= 1, got {stream_every}")
        self.path = str(path)
        self.run_id = run_id or (
            time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:6])
        self.stream_every = int(stream_every)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._f: Optional[IO[str]] = open(self.path, "w")
        self.event("run_start", pid=os.getpid(),
                   wall=time.time())

    # -- row plumbing -------------------------------------------------------

    def _write(self, row: dict) -> None:
        with self._lock:
            if self._f is None:      # closed: late rows drop silently
                return
            self._f.write(json.dumps(row, default=str) + "\n")
            self._f.flush()

    def _row(self, kind: str, name: str, **fields) -> dict:
        return {"v": SCHEMA_VERSION, "run": self.run_id,
                "t": self.clock(), "kind": kind, "name": name, **fields}

    def clock(self) -> float:
        """Seconds since the recorder started (the rows' time base)."""
        return time.perf_counter() - self._t0

    def end_span(self, name: str, t0: float, **fields) -> None:
        """Write the ``span`` row of a phase that began at ``t0``
        (:meth:`clock`) and ends now; for producers whose fields are known
        only at the end (``obs/stage.py``)."""
        self._write(self._row("span", name, t0=t0,
                              dur_s=self.clock() - t0, **fields))

    # -- producers ----------------------------------------------------------

    def event(self, name: str, **fields) -> None:
        """A point-in-time structured row (counters, provenance, rows)."""
        self._write(self._row("event", name, **fields))

    def metric(self, name: str, step: int, value: float, **fields) -> None:
        """A streamed scalar; cadence-gated by ``stream_every``."""
        step = int(step)
        if step % self.stream_every:
            return
        self._write(self._row("metric", name, step=step, value=float(value),
                              **fields))

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Timed phase: emits one ``span`` row with ``t0``/``dur_s`` on
        exit (exceptions still close the span, flagged ``failed``)."""
        t0 = self.clock()
        try:
            with profiled(name):
                yield self
        except BaseException:
            self.end_span(name, t0, failed=True, **fields)
            raise
        self.end_span(name, t0, **fields)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# ---------------------------------------------------------------------------
# Module-level active recorder (the switch every producer checks)
# ---------------------------------------------------------------------------

def active() -> Optional[Recorder]:
    """The installed recorder, or None (telemetry off — the default)."""
    return _ACTIVE


def enable(path: str, *, run_id: Optional[str] = None,
           stream_every: int = 1) -> Recorder:
    """Install a recorder writing to ``path``; replaces (and closes) any
    previously active one."""
    global _ACTIVE
    rec = Recorder(path, run_id=run_id, stream_every=stream_every)
    with _LOCK:
        old, _ACTIVE = _ACTIVE, rec
    if old is not None:
        old.close()
    return rec


def disable() -> None:
    """Uninstall (and close) the active recorder, if any."""
    global _ACTIVE
    with _LOCK:
        old, _ACTIVE = _ACTIVE, None
    if old is not None:
        old.close()


@contextlib.contextmanager
def recording(path: str, *, run_id: Optional[str] = None,
              stream_every: int = 1):
    """Scoped telemetry: enable for the block, always disable after."""
    rec = enable(path, run_id=run_id, stream_every=stream_every)
    try:
        yield rec
    finally:
        disable()


@contextlib.contextmanager
def span(name: str, **fields):
    """Span against the ACTIVE recorder; an exact no-op when telemetry is
    off (so producers can wrap phases unconditionally)."""
    rec = active()
    if rec is None:
        yield None
    else:
        with rec.span(name, **fields):
            yield rec
