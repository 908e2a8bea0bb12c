"""The paper's technique as an LM-training feature: variance-reduced
gradient corrections over the finite sum of M fixed microbatches — the
port of ``repro/optim/vr_wrapper.py``.

  * ``centralvr`` — Algorithms 1/2: per-index gradient table (M rows),
    anchor gbar frozen over the epoch, refreshed from the running
    accumulator gtilde at epoch end. 1 gradient per step.
  * ``svrg``      — Algorithm 4: snapshot params + anchor; the correction
    g(x) - g(y) + gbar needs a second gradient at the snapshot.
  * ``saga``      — Algorithm 5: table + anchor updated every step.

The state lives in flat buffers shaped and typed like the trainer's
params, (W, N) for W workers: ``table`` is a list of M such buffers, one
per row, so a row is contiguous for every worker at once. The functions
update the state IN PLACE and return it. The fresh gradient ``g`` is
float32 (the trainer's accumulator); with bfloat16 master params the
state is bfloat16, and ``g`` enters the corrections cast to it, as the
reference casts it (``a.astype(t.dtype)``).

Writing the table row ``table[i] <- g``: when the row has ``g``'s dtype,
the row is rebound to the tensor ``g`` itself (no copy), ``g`` then
belongs to the table, and the caller takes the row it replaced as its
next gradient buffer (``train/step.py`` does); otherwise (bfloat16 rows)
``g`` is copied into the row, rounded to its dtype, and stays the
caller's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch


@dataclass
class VRState:
    table: List[torch.Tensor] = field(default_factory=list)  # M rows, or []
    gbar: Optional[torch.Tensor] = None       # anchor
    gtilde: Optional[torch.Tensor] = None     # running accumulator
    snapshot: Optional[torch.Tensor] = None   # params snapshot (svrg)
    idx: int = 0                              # microbatch index in [0, M)


def init_vr(mode: str, params: torch.Tensor, M: int) -> Optional[VRState]:
    """Zero state shaped like ``params`` (its dtype and device); svrg's
    snapshot starts as a copy of the params."""
    if mode == "none":
        return None
    zeros = lambda: torch.zeros_like(params)        # noqa: E731
    if mode == "svrg":
        return VRState(table=[], gbar=zeros(), gtilde=zeros(),
                       snapshot=params.clone())
    return VRState(table=[zeros() for _ in range(M)], gbar=zeros(),
                   gtilde=zeros())


def _roll(state: VRState):
    """Epoch end: gbar <- gtilde, gtilde <- 0 (a swap, no copy)."""
    state.gbar, state.gtilde = state.gtilde, state.gbar
    state.gtilde.zero_()


def _write_row(state: VRState, i: int, g):
    """table[i] <- g: a rebind when the dtypes agree, else a rounding copy
    into the row."""
    if state.table[i].dtype == g.dtype:
        state.table[i] = g
    else:
        state.table[i].copy_(g)


def correct(mode: str, state: VRState, g, M: int, *, g_snap=None,
            params=None, idx=None):
    """One VR step. Returns (corrected gradient v, state).

    g: fresh gradient at the current params (for table modes it becomes
    table row ``i``). g_snap: gradient of the SAME microbatch at the
    snapshot (svrg only). params: current params (svrg's snapshot refresh
    at epoch end, before the caller's update). idx: the scalar microbatch
    index, as the reference's callers pass it; defaults to state.idx.
    """
    i = state.idx if idx is None else idx
    at_epoch_end = i == M - 1

    dtype = state.gbar.dtype
    gs = g.to(dtype)
    if mode == "svrg":
        v = gs - g_snap.to(dtype) + state.gbar
        state.gtilde.add_(gs / M)
        if at_epoch_end:
            _roll(state)
            state.snapshot.copy_(params)
            state.idx = 0
        else:
            state.idx = i + 1
        return v, state

    old = state.table[i]
    v = gs - old + state.gbar
    if mode == "saga":
        state.gbar.add_((gs - old) / M)
        _write_row(state, i, g)
        state.idx = (i + 1) % M
        return v, state

    _write_row(state, i, g)
    state.gtilde.add_(gs / M)
    if at_epoch_end:
        _roll(state)
        state.idx = 0
    else:
        state.idx = i + 1
    return v, state


def apply(mode: str, state: VRState, g, M: int, *, lr: float, g_snap=None,
          params=None, idx=None):
    """Fused VR correction + SGD step: the arithmetic of ``correct``
    followed by ``optimizers.sgd`` / ``apply_updates``, as ONE launch of
    the K1 ``vr_update`` kernel over the flat buffers of all workers,
    writing x' into ``params`` and gtilde' (and SAGA's gbar') in place;
    with bfloat16 state the kernel computes in float32 and rounds each
    result to bfloat16, as the reference's kernel wrapper does. The table
    row is then written with ``g`` (``_write_row``). Returns (params,
    state)."""
    from repro_torch.kernels.vr_update import kernel as vr_kernel

    i = state.idx if idx is None else idx
    at_epoch_end = i == M - 1

    if mode == "svrg":
        if at_epoch_end:
            # the snapshot takes the pre-update iterate, as in ``correct``
            state.snapshot.copy_(params)
        vr_kernel.vr_update(params, g, g_snap, state.gbar, state.gtilde,
                            eta=lr, m=M, saga=False, inplace=True)
        if at_epoch_end:
            _roll(state)
            state.idx = 0
        else:
            state.idx = i + 1
        return params, state

    vr_kernel.vr_update(params, g, state.table[i], state.gbar, state.gtilde,
                        eta=lr, m=M, saga=(mode == "saga"), inplace=True)
    _write_row(state, i, g)
    if mode == "saga":
        # SAGA keeps no accumulator: drop the kernel's gtilde lane, as the
        # reference does
        state.gtilde.zero_()
        state.idx = (i + 1) % M
        return params, state
    if at_epoch_end:
        _roll(state)
        state.idx = 0
    else:
        state.idx = i + 1
    return params, state


def grads_per_step(mode: str) -> int:
    """Table 1: gradient evaluations per iteration."""
    return 2 if mode == "svrg" else 1


def storage_multiplier(mode: str, M: int) -> float:
    """Extra param-sized buffers held by the VR state."""
    if mode == "none":
        return 0.0
    if mode == "svrg":
        return 3.0            # snapshot + gbar + gtilde
    return float(M) + 2.0     # table + gbar + gtilde
