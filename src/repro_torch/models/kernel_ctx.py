"""Process-global switch that routes the LM forward through the
hand-written kernels: RMSNorm (``kernels/rmsnorm``) in
``layers.apply_norm``, flash attention (``kernels/flash_attention``) in
``attention.attend_train`` and the SSD chunk scan (``kernels/ssd_scan``)
in ``ssm.apply_ssm_train``.

The port's counterpart of ``repro/models/kernel_ctx.py``. The reference
reads it at trace time; PyTorch runs eagerly, so here it is read on every
call, and it must stay on through the backward pass too: under
``remat="block"`` the backward recomputes each block's forward, and the
recompute goes through the kernels again. ``train/step.py`` holds it
around the whole gradient computation.

There is no interpret bit: the kernels' wrappers run their plain version
for tensors on the CPU and launch the kernel for tensors on the card.
"""
from __future__ import annotations

import contextlib

_STATE = {"active": False}


def active() -> bool:
    return _STATE["active"]


@contextlib.contextmanager
def scope(active: bool = True):
    """Enable (or disable) kernel dispatch inside the ``with`` block."""
    prev = _STATE["active"]
    _STATE["active"] = bool(active)
    try:
        yield
    finally:
        _STATE["active"] = prev
