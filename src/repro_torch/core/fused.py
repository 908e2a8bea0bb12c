"""Fused-kernel bodies of the VR inner loops — the port of
``repro/core/fused.py`` (``make_params``, ``centralvr_epoch``,
``saga_steps``, ``svrg_steps``).

Each inner step runs its correction, parameter update, prox epilogue and
accumulator write as ONE launch of the hand-written ``vr_update`` kernel,
for all p workers at once: the worker axis is the leading dimension of
every operand, where the reference vmaps over workers. The margin dot
``a_i.x`` and the rank-1 gradients ``s*a_i`` stay plain torch, as they are
plain jnp outside the Pallas kernel in the reference.

The l2 term ``2*lam*x`` is folded into the kernel's ``decay``. The
reference pads vectors to its kernel tile; the CUDA kernel masks its
ragged edge instead, so nothing is padded.

Numerics: the fused step computes ``s_new*a - s_old*a`` where the unfused
body computes ``(s_new - s_old)*a``, and applies the decay
multiplicatively — the same real algebra with different rounding, so the
two agree to float tolerance, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import kernels
from repro_torch.core import convex
from repro_torch.kernels.vr_update import kernel as vr_kernel
from repro_torch.prox import operators as proxops


class FusedParams(NamedTuple):
    eta: float
    lam: float
    prox: Optional[proxops.ProxSpec]   # elementwise epilogue, or None


def make_params(flag, eta: float, lam: float, device,
                prox=None) -> FusedParams | None:
    """Resolve a driver's ``fused=`` flag for runs on ``device``.

    Returns ``None`` (the unfused body) or the kernel parameters. A
    non-elementwise prox disables fusion: "auto" falls back to the unfused
    body, and an explicit ``fused=True`` (already refused by RunSpec)
    raises here as a second line of defense.
    """
    if not kernels.resolve_fused(flag, device):
        return None
    if prox is not None:
        prox = proxops.parse(prox)
        if not proxops.is_elementwise(prox):
            if flag is True:
                raise ValueError(
                    f"fused=True cannot fuse the non-elementwise prox "
                    f"{prox.name!r}; use fused=False or 'auto'")
            return None
    return FusedParams(float(eta), float(lam), prox)


def centralvr_epoch(A, b, kind, x, table, gbar, orders, fp: FusedParams):
    """Fused CentralVR epoch for p workers: ``A`` (p, n, d), ``b`` (p, n),
    ``x`` and ``gbar`` (p, d), ``table`` (p, n), ``orders`` (p, T).

    The arithmetic of ``distributed._local_centralvr_epoch``'s unfused
    body with one kernel launch per step. Returns (x, table, acc); ``acc``
    is each worker's running gtilde accumulator (data term, mean over its
    shard). The inputs are not modified.
    """
    eta, lam, prox = fp
    n = A.shape[1]
    rows, labels = convex.gather_epoch(A, b, orders)
    x = x.clone(memory_format=torch.contiguous_format)
    gbar = gbar.expand(x.shape).clone(memory_format=torch.contiguous_format)
    table = table.clone()
    acc = torch.zeros_like(x)
    for t in range(orders.shape[1]):
        a = rows[:, t]
        idx = orders[:, t:t + 1]
        s_new = convex._pointwise_residual(torch.linalg.vecdot(a, x),
                                           labels[:, t], kind)
        # x and acc are updated in place; gbar is read only (no SAGA)
        vr_kernel.vr_update(x, s_new[:, None] * a, table.gather(1, idx) * a,
                            gbar, acc, eta=eta, m=n, saga=False,
                            decay=2.0 * lam, prox=prox, inplace=True)
        table.scatter_(1, idx, s_new[:, None])
    return x, table, acc


def saga_steps(A, b, kind, x, table, gbar, n_global: int, idx,
               fp: FusedParams):
    """Fused SAGA inner loop for p workers: the arithmetic of
    ``distributed._local_saga_steps`` (SAGA and D-SAGA) — the VR step and the running-mean gbar update (global 1/n scaling) in one
    launch per step, which writes x and gbar in place. ``A`` (p, n, d),
    ``b`` and ``table`` (p, n), ``x`` and ``gbar`` (p, d), ``idx`` (p, T).
    Returns (x, table, gbar); the inputs are not modified."""
    eta, lam, prox = fp
    rows, labels = convex.gather_epoch(A, b, idx)
    x = x.clone(memory_format=torch.contiguous_format)
    gbar = gbar.clone(memory_format=torch.contiguous_format)
    table = table.clone()
    scratch = torch.zeros_like(x)    # the gtilde lane: written, never read
    for t in range(idx.shape[1]):
        a = rows[:, t]
        i = idx[:, t:t + 1]
        s_new = convex._pointwise_residual(torch.linalg.vecdot(a, x),
                                           labels[:, t], kind)
        vr_kernel.vr_update(x, s_new[:, None] * a, table.gather(1, i) * a,
                            gbar, scratch, eta=eta, m=n_global, saga=True,
                            decay=2.0 * lam, prox=prox, inplace=True)
        table.scatter_(1, i, s_new[:, None])
    return x, table, gbar


def svrg_steps(A, b, kind, xbar, sbar, gbar, idx, fp: FusedParams):
    """Fused SVRG inner loop for p workers from the snapshot ``xbar``
    (p, d): the arithmetic of ``distributed._svrg_anchors``' unfused body
    (SVRG and D-SVRG).

    ``sbar`` (p, n) holds the snapshot residuals of each shard, so the
    anchor gradient is ``sbar[i] * a_i``; ``gbar`` is the full
    REGULARIZED gradient at the snapshot, (d,) or (p, d). The kernel's
    decay supplies ``2*lam*x``, so ``2*lam*xbar`` is subtracted from gbar
    once here:  v = s*a - sbar*a + (gbar - 2*lam*xbar) + [decay] 2*lam*x,
    the unfused body's  (s - sbar)*a + gbar + 2*lam*(x - xbar).
    Returns the final iterates (p, d)."""
    eta, lam, prox = fp
    n = A.shape[1]
    rows, labels = convex.gather_epoch(A, b, idx)
    x = xbar.clone(memory_format=torch.contiguous_format)
    gbar = (gbar - 2.0 * lam * xbar).contiguous()
    scratch = torch.zeros_like(x)    # the gtilde lane: written, never read
    for t in range(idx.shape[1]):
        a = rows[:, t]
        s_new = convex._pointwise_residual(torch.linalg.vecdot(a, x),
                                           labels[:, t], kind)
        vr_kernel.vr_update(x, s_new[:, None] * a,
                            sbar.gather(1, idx[:, t:t + 1]) * a, gbar,
                            scratch, eta=eta, m=n, saga=False,
                            decay=2.0 * lam, prox=prox, inplace=True)
    return x
