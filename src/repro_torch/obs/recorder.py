"""The run recorder and the span log — the port's copy of
``repro/obs/recorder.py``, its spans extended.

One :class:`Recorder` per run: every row it writes carries the run id, a
monotonic timestamp relative to the recorder's start, and a ``kind``
(``span`` / ``metric`` / ``event``) whose required fields are pinned by
``obs/schema.py``. Rows are appended to one JSONL file under a lock, so
rows written from other threads interleave safely with the main thread's
spans.

Telemetry is OFF by default: the module-level active recorder is ``None``
until :func:`enable` (or the :func:`recording` context manager) installs
one, and every producer checks first, so the telemetry-off program is
the program without telemetry: no sync, copy or launch more.

Spans. :func:`span` times one phase of the program. It is on while a
recorder is installed or a ``torch.profiler`` records (:func:`tracing`),
and otherwise does one flag check and nothing else: no event, no sync,
no log entry. When on, each span is an entry of the span log
(:func:`spans`), a dict of

  name, id, parent  the span, its id, and the id of the span it opened
                    inside (None for a span opened at the top)
  root              the id of the outermost span open at its start: all
                    the spans of one ``solve`` call share it
  t0_ns, t1_ns      host start and end on ``CLOCK_NS``, the clock of the
                    profiler's events (``obs/timeline.py`` puts them on
                    a trace's time base)
  device_ms         with ``device=`` a CUDA device: the time between two
                    CUDA events recorded on its current stream at entry
                    and exit, so it brackets the device work enqueued
                    inside the span; resolved when the log is read, so
                    the program gains no sync (None without ``device=``)
  failed            the span ended by an exception
  and the span's own fields.

The log keeps the last ``LOG_ENTRIES`` spans of the process. It starts
afresh when a profiler session starts, and reading it clears nothing.
Under a recorder each span is also a ``span`` row of schema v1 with the
entry's keys as extra fields, written as the span ends; a row whose
device time is still running waits, and the rows after it with it,
until its end event has passed or its root span ends. While a profiler
records, each span also opens a ``torch.profiler.record_function`` of
its name, so a trace with CPU activity names the same phases.

Host reads. :func:`host_read` makes a call that reads a device value on
the host (and so drains the stream): it counts the read by site
(:func:`counters`; one integer add, traced or not) and, while tracing is
on, times it as a ``sync/<site>`` span.

To follow the profiler, importing this module wraps the setter of the
flag that ``torch.autograd.profiler`` keeps for fast Python checks; each
profiler session calls it as it starts and as it stops.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time
import uuid
from typing import IO, Optional

SCHEMA_VERSION = 1
LOG_ENTRIES = 1 << 16
# the clock of the profiler's event stamps: Kineto converts its own to
# CLOCK_REALTIME nanoseconds, host and device events alike
CLOCK_NS = time.time_ns

_LOCK = threading.Lock()          # guards the module-level active recorder
_ACTIVE: Optional["Recorder"] = None
_PROFILING = False                # a torch.profiler session records
_TRACING = False                  # _PROFILING or a recorder installed
_NULL = contextlib.nullcontext()
_IDS = itertools.count(1)
_OPEN = threading.local()         # each thread's stack of open spans
_READS: collections.Counter = collections.Counter()   # since the start


class _Log:
    """The spans of one profiler session and its host reads by site."""

    def __init__(self):
        self.entries: collections.deque = collections.deque(
            maxlen=LOG_ENTRIES)
        self.reads: collections.Counter = collections.Counter()


_LOG = _Log()


def profiled(name: str):
    """A profiler range of ``name`` while a profiler records, else a null
    context: ``torch.profiler.record_function``'s, or the same range from
    its C++ half where torch has one (an eighth of the host time)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return torch.profiler.record_function(name) if fast is None \
        else fast(name)


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
        self._queue: collections.deque = collections.deque()
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._f: Optional[IO[str]] = open(self.path, "w")
        self.event("run_start", pid=os.getpid(),
                   wall=time.time())

    # -- row plumbing -------------------------------------------------------

    def _write(self, row: dict, events=None, wait: bool = False) -> None:
        """Queue ``row`` and write out the queue's head: each row in turn,
        up to one whose ``events`` (a CUDA start and end event, whose time
        becomes its ``device_ms``) have not passed yet; ``wait``: wait for
        them all."""
        with self._lock:
            if self._f is None:      # closed: late rows drop silently
                return
            self._queue.append((row, events))
            self._drain(wait)

    def _drain(self, wait: bool) -> None:
        while self._queue:
            row, events = self._queue[0]
            if events is not None:
                start, end = events
                if not wait and not end.query():
                    return
                end.synchronize()
                row["device_ms"] = start.elapsed_time(end)
            self._queue.popleft()
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
        only at the end (``kernels/build.py``)."""
        self._write(self._row("span", name, t0=t0,
                              dur_s=self.clock() - t0, **fields))

    def _span_ended(self, sp: "_Span") -> None:
        """The row of a span of the log that has just ended."""
        dur = (sp.t1_ns - sp.t0_ns) * 1e-9
        row = self._row("span", sp.name, t0=self.clock() - dur, dur_s=dur,
                        id=sp.id, parent=sp.parent, root=sp.root,
                        **sp.fields)
        if sp.failed:
            row["failed"] = True
        self._write(row, sp.events and sp.events[:2],
                    wait=sp.parent is None)

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

    def span(self, name: str, **fields):
        """Timed phase: one span of the log and one ``span`` row with
        ``t0``/``dur_s``, written on exit (exceptions still close the span,
        flagged ``failed``)."""
        return _Scope(name, None, self, fields)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._drain(wait=True)
                self._f.close()
                self._f = None


# ---------------------------------------------------------------------------
# Module-level active recorder (the switch every producer checks)
# ---------------------------------------------------------------------------

def active() -> Optional[Recorder]:
    """The installed recorder, or None (telemetry off — the default)."""
    return _ACTIVE


def tracing() -> bool:
    """Whether spans are on: a recorder is installed or a profiler
    records."""
    return _TRACING


def _switched() -> None:
    global _TRACING
    _TRACING = _PROFILING or _ACTIVE is not None


def enable(path: str, *, run_id: Optional[str] = None,
           stream_every: int = 1) -> Recorder:
    """Install a recorder writing to ``path``; replaces (and closes) any
    previously active one."""
    global _ACTIVE
    rec = Recorder(path, run_id=run_id, stream_every=stream_every)
    with _LOCK:
        old, _ACTIVE = _ACTIVE, rec
        _switched()
    if old is not None:
        old.close()
    return rec


def disable() -> None:
    """Uninstall (and close) the active recorder, if any."""
    global _ACTIVE
    with _LOCK:
        old, _ACTIVE = _ACTIVE, None
        _switched()
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


# ---------------------------------------------------------------------------
# Spans and the span log
# ---------------------------------------------------------------------------

class _Span:
    """One entry of the span log."""

    __slots__ = ("name", "id", "parent", "root", "fields", "events",
                 "t0_ns", "t1_ns", "failed", "device_ms", "rec", "prof")

    def as_dict(self) -> dict:
        if self.device_ms is None and self.events is not None \
                and self.t1_ns is not None:
            start, end, _ = self.events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "root": self.root, "t0_ns": self.t0_ns,
                "t1_ns": self.t1_ns, "device_ms": self.device_ms,
                "failed": self.failed, **self.fields}


def _open_spans() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def _device_events(device):
    """(start, end, stream) for a span on a CUDA ``device``, else None."""
    if device is None:
        return None
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True),
            torch.cuda.current_stream(device))


def open_span(name: str, device=None, rec: Optional[Recorder] = None,
              **fields) -> _Span:
    """Start a span of the log (the caller checks :func:`tracing`) and
    return it; :func:`close_span` ends it. ``rec``: the recorder its row
    goes to (default the active one)."""
    stack = _open_spans()
    up = stack[-1] if stack else None
    sp = _Span()
    sp.name, sp.id, sp.fields = name, next(_IDS), fields
    sp.parent = None if up is None else up.id
    sp.root = sp.id if up is None else up.root
    sp.t1_ns, sp.failed, sp.device_ms = None, False, None
    sp.rec = _ACTIVE if rec is None else rec
    sp.events = _device_events(device)
    sp.prof = profiled(name)
    sp.prof.__enter__()
    stack.append(sp)
    _LOG.entries.append(sp)
    sp.t0_ns = CLOCK_NS()
    if sp.events is not None:
        sp.events[0].record(sp.events[2])
    return sp


def close_span(sp: _Span, failed: bool = False, wait: bool = False,
               **fields) -> None:
    """End ``sp``, adding ``fields``; ``wait``: wait for its device first
    (then its host time holds the device work enqueued inside it)."""
    if sp.events is not None:
        start, end, stream = sp.events
        end.record(stream)
        if wait:
            import torch
            torch.cuda.synchronize(stream.device)
    sp.t1_ns = CLOCK_NS()
    sp.failed = failed
    sp.fields.update(fields)
    sp.prof.__exit__(None, None, None)
    stack = _open_spans()
    if stack and stack[-1] is sp:
        stack.pop()
    elif sp in stack:
        stack.remove(sp)
    if sp.rec is not None:
        sp.rec._span_ended(sp)


class _Scope:
    """The context of one span; yields the recorder its row goes to (None
    while a profiler alone records)."""

    __slots__ = ("args", "sp")

    def __init__(self, name, device, rec, fields):
        self.args = (name, device, rec, fields)

    def __enter__(self):
        name, device, rec, fields = self.args
        self.sp = open_span(name, device, rec, **fields)
        return self.sp.rec

    def __exit__(self, typ, value, tb):
        close_span(self.sp, failed=typ is not None)
        return False


def span(name: str, device=None, **fields):
    """A span of the phase inside the ``with`` block, while tracing is on
    (``device``: the CUDA device whose work it also times); an exact no-op
    otherwise, so producers wrap phases unconditionally. Yields the
    active recorder, or None."""
    if not _TRACING:
        return _NULL
    return _Scope(name, device, None, fields)


def host_read(site: str, fn, *args):
    """``fn(*args)``, a read of a device value on the host: counted by
    ``site``, and a ``sync/<site>`` span while tracing is on."""
    _READS[site] += 1
    if not _TRACING:
        return fn(*args)
    _LOG.reads[site] += 1
    with _Scope("sync/" + site, None, None, {}):
        return fn(*args)


def spans() -> list:
    """The span log as dicts (module docstring), in the order the spans
    started; reading it clears nothing."""
    return [sp.as_dict() for sp in list(_LOG.entries)]


def counters(traced: bool = False) -> dict:
    """Host reads by site (:func:`host_read`) since the process started;
    ``traced``: those of the current span log, made while it recorded."""
    return dict(_LOG.reads if traced else _READS)


def _profiler_switched(on: bool) -> None:
    global _PROFILING, _LOG
    with _LOCK:
        if on and not _PROFILING:
            _LOG = _Log()
        _PROFILING = on
        _switched()


def _watch_profiler() -> None:
    """Follow torch's profiler (module docstring); a second call, as after
    a reload, wraps the setter it found the first time."""
    from torch.autograd import profiler as ap
    setter = getattr(ap, "_set_is_profiler_enabled", None)
    if setter is None:
        return
    setter = getattr(setter, "repro_obs_wraps", setter)

    def set_enabled(enable):
        setter(enable)
        _profiler_switched(bool(enable))

    set_enabled.repro_obs_wraps = setter
    ap._set_is_profiler_enabled = set_enabled
    _profiler_switched(bool(ap._is_profiler_enabled))


_watch_profiler()
