"""The span log (``obs/recorder.py``) on the time base of a device trace.

A ``torch.profiler`` trace gives its events in microseconds from the
trace's start; the span log gives host times in ``CLOCK_NS``
nanoseconds, the clock of the profiler's own stamps. A reduced trace no
longer holds its start on that clock, so :func:`align` finds it from
anchors that both hold: every counted host read (a ``sync/<site>`` span)
holds its device-to-host runtime calls (``cudaMemcpyAsync``, a
synchronise), and the host makes one call at a time. The
offset is the median of the differences between each matched pair: a
read and its calls, the mean of the differences of its start from the
first call's start and of its end from the last call's end (the host's
way into a read and out of it take about as long). The residual is how
far the pairs lie from the offset.

With the alignment, a moment of the trace (say the middle of a gap in
which the device idled) falls inside spans of the log: :func:`innermost`
names the innermost, :func:`by_span` sums a trace's idle gaps and the
spans' host and device times by span name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# the runtime calls in which a host read of a device value ends
READ_CALLS = ("cudaMemcpy", "cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
_SCORE_READS = 64        # offsets tried: these first reads x every call
_EPS = 1e-3              # us: a call that ends as a read ends is inside it
_CHUNK = 2048


@dataclasses.dataclass(frozen=True)
class Alignment:
    """The trace's zero on ``CLOCK_NS`` (``origin_ns``), from ``pairs`` of
    the log's ``reads`` host reads matched to runtime calls; ``residual_us``:
    the median distance of a pair's difference from the offset."""
    origin_ns: int
    residual_us: float
    pairs: int
    reads: int

    def us(self, t_ns) -> np.ndarray:
        """Host times of the log (ns) on the trace's time base (us)."""
        return (np.asarray(t_ns, dtype=np.int64) - self.origin_ns) * 1e-3


def _fit(t0: np.ndarray, t1: np.ndarray, start: np.ndarray,
         end: np.ndarray, offsets: np.ndarray) -> tuple:
    """For each offset, the reads whose spans (``t0``, ``t1`` less the
    offset) hold a whole call, with no call running as they start or end
    (the host makes one call at a time, so a read holds its own calls),
    and the calls those reads hold."""
    fits = np.empty(offsets.size, dtype=np.int64)
    held = np.empty(offsets.size, dtype=np.int64)
    for i in range(0, offsets.size, _CHUNK):
        a = t0[None, :] - offsets[i:i + _CHUNK, None] - _EPS
        b = t1[None, :] - offsets[i:i + _CHUNK, None] + _EPS
        after = np.searchsorted(start, a, side="left")
        last = np.maximum(np.searchsorted(start, b, side="right") - 1, 0)
        before = np.maximum(after - 1, 0)
        whole = (start[last] >= a) & (end[last] <= b)
        free = (end[before] <= a) | (start[before] >= a)
        ok = whole & free
        fits[i:i + _CHUNK] = ok.sum(1)
        held[i:i + _CHUNK] = np.where(ok, last - after + 1, 0).sum(1)
    return fits, held


def align(spans: Sequence[dict], host: Sequence[tuple]) -> \
        Optional[Alignment]:
    """The alignment of the span log ``spans`` (``obs.spans()``) to a
    trace whose host events ``host`` are (name, start, end) in
    microseconds, or None when no host read holds a call."""
    reads = sorted((s["t0_ns"], s["t1_ns"]) for s in spans
                   if s["name"].startswith("sync/") and s["t1_ns"] is not None)
    calls = sorted((a, b) for n, a, b in host if n.startswith(READ_CALLS))
    if not reads or not calls:
        return None
    base = reads[0][1]
    t0, t1 = ((np.array(r, dtype=np.int64) - base) * 1e-3
              for r in zip(*reads))
    start, end = (np.array(c, dtype=np.float64) for c in zip(*calls))
    # the offsets that put one of the first reads' end on a call's end; of
    # them, those that fit the most reads, first of the first reads, then
    # of all (an offset a period of a repeated program off fits nearly as
    # many at first, and loses the reads at the trace's end); of those,
    # the ones whose reads hold the most calls (an offset that leaves a
    # read's last call outside it still fits), and the middle one of these
    offsets = np.unique((t1[:_SCORE_READS, None] - end[None, :]).ravel())
    fit, _ = _fit(t0[:_SCORE_READS], t1[:_SCORE_READS], start, end, offsets)
    offsets = offsets[fit == fit.max()]
    fit, held = _fit(t0, t1, start, end, offsets)
    held = np.where(fit == fit.max(), held, -1)
    best = offsets[held == held.max()]
    offset = best[best.size // 2]
    # each read that fits pairs with its first and last calls
    a, b = t0 - offset - _EPS, t1 - offset + _EPS
    first = np.minimum(np.searchsorted(start, a, side="left"), start.size - 1)
    last = np.maximum(np.searchsorted(start, b, side="right") - 1, 0)
    before = np.maximum(first - 1, 0)
    ok = ((start[first] >= a) & (first <= last) & (end[last] <= b)
          & ((end[before] <= a) | (start[before] >= a)))
    if not ok.any():
        return None
    diff = 0.5 * (t1[ok] - end[last[ok]] + t0[ok] - start[first[ok]])
    mid = float(np.median(diff))
    return Alignment(origin_ns=base + int(round(mid * 1e3)),
                     residual_us=float(np.median(np.abs(diff - mid))),
                     pairs=int(ok.sum()), reads=len(reads))


def roots(spans: Sequence[dict], name: str) -> list:
    """The spans ``name`` opened at the top (one a ``solve`` call, say)
    that have ended, in the order they started."""
    return [s for s in spans if s["name"] == name and s["parent"] is None
            and s["t1_ns"] is not None]


def _intervals(spans: Sequence[dict], alignment: Alignment):
    done = [s for s in spans if s["t1_ns"] is not None]
    t0 = alignment.us([s["t0_ns"] for s in done])
    t1 = alignment.us([s["t1_ns"] for s in done])
    return done, t0, t1


def innermost(spans: Sequence[dict], alignment: Alignment,
              times_us) -> list:
    """For each moment of the trace (us), the innermost span of the log
    the host was in then (the shortest that holds it), or None."""
    done, t0, t1 = _intervals(spans, alignment)
    times = np.asarray(times_us, dtype=np.float64)
    out = []
    for i in range(0, times.size, _CHUNK // 8):
        t = times[i:i + _CHUNK // 8, None]
        length = np.where((t0 <= t) & (t <= t1), t1 - t0, np.inf)
        best = np.argmin(length, axis=1) if done else []
        out += [done[j] if np.isfinite(length[k, j]) else None
                for k, j in enumerate(best)]
    return out


def by_span(spans: Sequence[dict], alignment: Alignment,
            gaps: Sequence[tuple]) -> dict:
    """{span name: {"n", "host_ms", "device_ms", "idle_ms"}}: the spans'
    count, host and device time, and the device's idle time in the
    ``gaps`` (start, end us) whose middle the span is innermost at."""
    out: dict = {}
    for s in spans:
        if s["t1_ns"] is None:
            continue
        row = out.setdefault(s["name"], {"n": 0, "host_ms": 0.0,
                                         "device_ms": 0.0, "idle_ms": 0.0})
        row["n"] += 1
        row["host_ms"] += (s["t1_ns"] - s["t0_ns"]) * 1e-6
        row["device_ms"] += s["device_ms"] or 0.0
    mids = [0.5 * (a + b) for a, b in gaps]
    for (a, b), s in zip(gaps, innermost(spans, alignment, mids)):
        if s is not None:
            out[s["name"]]["idle_ms"] += (b - a) * 1e-3
    return out
