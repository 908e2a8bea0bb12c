"""Streamed in-run metrics — the port's ``repro/obs/stream.py``, rebuilt
on pinned copies and CUDA events.

The reference's drivers compute their convergence metric inside a jitted
scan and stream it out with a host callback. The port's drivers are
Python loops whose per-round metric is a 0-d tensor on the run's device,
so streaming is a copy: when a recorder is active (:func:`stream_active`)
a driver opens a :class:`MetricStream` and pushes each round's value.

  * On a CUDA device a push enqueues a ``non_blocking`` copy of the value
    into its slot of a pinned host buffer and records an event behind it.
    Rows go out for the slots whose event ``query()`` says done, in
    round order, and :meth:`MetricStream.close` writes the rest after
    waiting on their events at the end of the run. The round loop never
    synchronizes.
  * On the CPU a row goes out as each round ends.

The values are the ones the driver stacks into its rels, bit for bit.
With telemetry off the drivers open no stream: no buffer, no event.

As in the reference, the spmd runners do not stream: each rank holds the
replicated metric, and a row per rank would be noise. They record spans
and the comms and staleness models instead.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

from repro_torch.obs import recorder as _recorder


def stream_active() -> bool:
    """Whether the drivers stream: iff a recorder is installed."""
    return _recorder.active() is not None


class MetricStream:
    """One run's stream of a per-round scalar ``name`` (``rounds`` slots)
    into the recorder ``rec``."""

    def __init__(self, rec, name: str, rounds: int, device):
        self._rec, self._name, self._rounds = rec, name, int(rounds)
        self._cuda = torch.device(device).type == "cuda"
        self._buf: Optional[torch.Tensor] = None   # pinned, on first push
        self._pending: collections.deque = collections.deque()

    def push(self, step: int, value: torch.Tensor) -> None:
        """Stream round ``step``'s 0-d ``value``."""
        if not self._cuda:
            self._rec.metric(self._name, step, float(value))
            return
        if self._buf is None:
            self._buf = torch.empty(self._rounds, dtype=value.dtype,
                                    pin_memory=True)
        self._buf[step].copy_(value, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(value.device))
        self._pending.append((step, done))
        self._emit(wait=False)

    def _emit(self, wait: bool) -> None:
        while self._pending:
            step, done = self._pending[0]
            if wait:
                done.synchronize()
            elif not done.query():
                return
            self._pending.popleft()
            self._rec.metric(self._name, step, float(self._buf[step]))

    def close(self) -> None:
        """Write every row still in flight (waits on their events)."""
        self._emit(wait=True)


def open_stream(name: str, rounds: int, device) -> Optional[MetricStream]:
    """A :class:`MetricStream` into the active recorder, or None when
    telemetry is off (the drivers then push nothing)."""
    rec = _recorder.active()
    return None if rec is None else MetricStream(rec, name, rounds, device)
