"""Fused-kernel bodies of the VR inner loops — the port of
``repro/core/fused.py`` (``make_params``, ``centralvr_epoch``,
``saga_steps``, ``svrg_steps``).

Each function runs a whole inner loop of p workers as ONE launch of the
hand-written ``vr_epoch`` kernel (K1's epoch route,
``kernels/vr_update/epoch.py``), where the reference runs each as one
jitted ``lax.scan`` of Pallas launches: per step the margin ``a_i.x``,
the residual, the correction, parameter update, prox epilogue and the
accumulator, gbar and table writes. The worker axis is the leading
dimension of every operand, where the reference vmaps over workers. On
CPU tensors the wrapper runs the kernel's plain version, a loop of K1's
plain version (``vr_update_ref``) step by step.

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
from repro_torch.kernels.vr_update import epoch as vr_epoch
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


def centralvr_epoch(A, b, kind, x, table, gbar, orders, fp: FusedParams,
                    *, track: bool = False):
    """Fused CentralVR epoch for p workers: ``A`` (p, n, d), ``b`` (p, n),
    ``x`` and ``gbar`` (p, d) (gbar may be (d,)), ``table`` (p, n),
    ``orders`` (p, T).

    The arithmetic of ``distributed._local_centralvr_epoch``'s unfused
    body as one ``vr_epoch`` launch (centralvr lane). Returns (x, table,
    acc); ``acc`` is each worker's running gtilde accumulator (data term,
    mean over its shard). ``track``: also the (p, T, d) iterates before
    each step, stored by the same launch (the kernel's tracked
    instantiation), as a fourth output. The inputs are not modified.
    """
    eta, lam, prox = fp
    x = x.contiguous()
    out = vr_epoch.vr_epoch_in_range(
        A, b, _index(orders), x, table.contiguous(),
        gbar.expand(x.shape).contiguous(), lane="centralvr", kind=kind,
        eta=eta, decay=2.0 * lam, m=A.shape[1], prox=prox, track=track)
    return (out[0], out[1], out[3]) + tuple(out[4:])


def saga_steps(A, b, kind, x, table, gbar, n_global: int, idx,
               fp: FusedParams):
    """Fused SAGA inner loop for p workers: the arithmetic of
    ``distributed._local_saga_steps`` (SAGA and D-SAGA) — the VR step and
    the running-mean gbar update (global 1/n scaling) — as one
    ``vr_epoch`` launch (saga lane). ``A`` (p, n, d), ``b`` and ``table``
    (p, n), ``x`` and ``gbar`` (p, d), ``idx`` (p, T), repeats allowed.
    Returns (x, table, gbar); the inputs are not modified."""
    eta, lam, prox = fp
    x, table, gbar, _ = vr_epoch.vr_epoch_in_range(
        A, b, _index(idx), x.contiguous(), table.contiguous(),
        gbar.contiguous(), lane="saga", kind=kind, eta=eta, decay=2.0 * lam,
        m=n_global, prox=prox)
    return x, table, gbar


def svrg_steps(A, b, kind, xbar, sbar, gbar, idx, fp: FusedParams):
    """Fused SVRG inner loop for p workers from the snapshot ``xbar``
    (p, d): the arithmetic of ``distributed._svrg_anchors``' unfused body
    (SVRG and D-SVRG) as one ``vr_epoch`` launch (svrg lane).

    ``sbar`` (p, n) holds the snapshot residuals of each shard, so the
    anchor gradient is ``sbar[i] * a_i``; ``gbar`` is the full
    REGULARIZED gradient at the snapshot, (d,) or (p, d). The kernel's
    decay supplies ``2*lam*x``, so ``2*lam*xbar`` is subtracted from gbar
    once here:  v = s*a - sbar*a + (gbar - 2*lam*xbar) + [decay] 2*lam*x,
    the unfused body's  (s - sbar)*a + gbar + 2*lam*(x - xbar).
    Returns the final iterates (p, d)."""
    eta, lam, prox = fp
    gbar = (gbar - 2.0 * lam * xbar).expand(xbar.shape).contiguous()
    x, _, _, _ = vr_epoch.vr_epoch_in_range(
        A, b, _index(idx), xbar.contiguous(), sbar.contiguous(), gbar,
        lane="svrg", kind=kind, eta=eta, decay=2.0 * lam, m=A.shape[1],
        prox=prox)
    return x


def _index(orders):
    """Visit orders as the kernel takes them: int64, contiguous. The
    drivers range-checked them once a run (``distributed._as_index``)."""
    return orders.to(torch.int64).contiguous()
