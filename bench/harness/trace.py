"""The device trace of a traced run (``--trace 1``), reduced to what the
per-layer metric readers and the result line need.

``torch.profiler`` records the card's operations (kernels, copies,
fills) and the host's CUDA runtime calls over a stretch of the measured
window, which the cell's run opens and closes with a synchronise. The host's
PyTorch operations are not recorded: recording them slowed a training
step by four fifths on the card. From the trace:

  * ``window_s``: from the first recorded event to the last, and
    ``busy_s``: the union of the device operations' intervals in it;
  * ``kernel(names)``: the device time and launch count of the kernels
    whose names hold one of ``names``;
  * ``breakdown()``: the device operations that took the most time, and
    the longest idle gaps, each named by the innermost CUDA runtime call
    the host was in at the gap's middle (none: the host was working
    between calls).
"""
from __future__ import annotations

import numpy as np

TOP = 10
NAME_CHARS = 160
BETWEEN_CALLS = "host work between CUDA calls"


def profiler():
    import torch
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(activities=[ProfilerActivity.CUDA])


class Trace:
    """The reduced trace. ``dev`` and ``host`` are (name, start, end)
    lists in microseconds on the profiler's clock; ``host_window_s`` is
    the stretch's length on the host's clock, the window where nothing
    was recorded."""

    def __init__(self, dev, host, host_window_s: float = 0.0):
        ends = [e for _, s, e in dev + host]
        if ends:
            self.t0 = min(s for _, s, _ in dev + host)
            self.t1 = max(ends)
            self.window_s = (self.t1 - self.t0) * 1e-6
        else:
            self.t0 = self.t1 = 0.0
            self.window_s = host_window_s
        self.dev, self.host = list(dev), list(host)
        self._merged = self._merge()

    @classmethod
    def from_profiler(cls, prof, host_window_s: float = 0.0) -> "Trace":
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in prof.events():
            row = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                dev.append(row)
            elif e.device_type == DeviceType.CPU:
                host.append(row)
        return cls(dev, host, host_window_s)

    def _merge(self):
        """The device-busy intervals inside the window, merged."""
        iv = sorted((max(s, self.t0), min(e, self.t1))
                    for _, s, e in self.dev)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged) * 1e-6

    @property
    def device_ops(self) -> int:
        """Device operations (kernels, copies, fills) in the window."""
        return len(self.dev)

    def kernel(self, names) -> tuple:
        """(seconds, launches) of the kernels whose names hold one of
        ``names``."""
        hits = [(e - s) for n, s, e in self.dev
                if any(k in n for k in names)]
        return sum(hits) * 1e-6, len(hits)

    def gaps(self):
        """The device's idle gaps inside the window: (start, end)."""
        out, t = [], self.t0
        for s, e in self._merged:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def breakdown(self) -> dict:
        by_name = {}
        for n, s, e in self.dev:
            by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        if self.host:
            names = [h[0] for h in self.host]
            starts = np.array([h[1] for h in self.host], dtype=np.float64)
            ends = np.array([h[2] for h in self.host], dtype=np.float64)
        idle = []
        for s, e in gaps:
            name = BETWEEN_CALLS
            if self.host:
                mid = 0.5 * (s + e)
                inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
                if inside.size:
                    j = inside[np.argmin(ends[inside] - starts[inside])]
                    name = names[j]
            idle.append([name[:NAME_CHARS], (e - s) * 1e-6])
        return {"device_ops": [[n[:NAME_CHARS], t] for n, t in ops],
                "idle_gaps": idle}
