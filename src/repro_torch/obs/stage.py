"""Spans around the drivers' runs — the port's ``repro/obs/stage.py``,
rebuilt on CUDA events.

The reference splits a recorded call of a jitted runner into
``lower/compile/execute`` spans. The port's drivers are eager Python
loops over hand-written kernels: nothing is lowered or compiled per call
(the kernels' one compile is the ``kernels/build`` span of
``kernels/build.py``). So a recorded call is one span,

    <label>/execute   the call, up to ``torch.cuda.synchronize()`` on a
                      CUDA device (the reference blocks on its result
                      too), with the fields
                        launches   the hand-written kernels' launches in
                                   the call, by name
                        device_ms  CUDA-event time from the call's start
                                   to its end on the current stream (CUDA
                                   only)

and, under the spmd backend (``_group`` given), a ``comms_measured``
event with what this rank's collectives carried in the call
(``carried_bytes``, ``collectives``), where the reference records the
``comms_hlo`` bytes of its compiled module. There is no compile step to
fall back from, so the port has no ``stage_fallback`` event.

While a profiler records with no recorder installed, the call is one
more span of the log (``obs/recorder.py``), with its device time and no
wait. With telemetry OFF the call goes straight through: no event, no
sync.
"""
from __future__ import annotations

import torch

from repro_torch.obs import recorder as _recorder


def staged_call(fn, *args, _label: str, _device=None, _group=None, **kw):
    """Call ``fn(*args, **kw)``; with a recorder active, inside one
    ``<label>/execute`` span (``_device``: where the call runs; ``_group``:
    the spmd ``WorkerGroup`` whose collectives it counts)."""
    if not _recorder.tracing():
        return fn(*args, **kw)
    name = f"{_label}/execute"
    rec = _recorder.active()
    if rec is None:
        with _recorder.span(name, device=_device):
            return fn(*args, **kw)

    from repro_torch.kernels import launch_counts

    cuda = _device is not None and torch.device(_device).type == "cuda"
    counts0 = launch_counts()
    carried0 = ((_group.carried_bytes, _group.collectives)
                if _group is not None else None)
    sp = _recorder.open_span(name, device=_device if cuda else None)
    try:
        if cuda:
            with torch.cuda.device(_device):
                out = fn(*args, **kw)
        else:
            out = fn(*args, **kw)
    except BaseException:
        _recorder.close_span(sp, failed=True)
        raise
    counts = launch_counts()
    _recorder.close_span(sp, wait=cuda,
                         launches={k: counts[k] - counts0[k] for k in counts})
    if carried0 is not None:
        rec.event("comms_measured", label=_label,
                  carried_bytes=_group.carried_bytes - carried0[0],
                  collectives=_group.collectives - carried0[1])
    return out
