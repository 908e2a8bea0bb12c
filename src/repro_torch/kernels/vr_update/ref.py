"""Plain PyTorch version of the fused VR update — the arithmetic of the
CUDA kernel in ``csrc/vr_update.cu`` op for op, on any device.

The wrapper in ``kernel.py`` runs it for tensors on the CPU; tests hold it
against the reference's ``vr_update_ref`` followed by
``prox.operators.apply``, and ``chip_smoke.py`` holds the kernel against it
on the card.
"""
from __future__ import annotations

import torch

# prox epilogue kinds, as the kernel numbers them
PROX_KINDS = {None: 0, "l1": 1, "elasticnet": 2, "box": 3}


def epilogue_constants(prox, eta: float):
    """(kind, c1, c2) of the elementwise prox epilogue with eta folded in,
    as the reference kernel folds them at compile time:
    l1 -> (t, -), elasticnet -> (t, shrink), box -> (lo, hi), where
    t = eta*lam1 and shrink = 1/(1 + 2*eta*lam2)."""
    if prox is None:
        return PROX_KINDS[None], 0.0, 0.0
    name, params = prox
    if name == "l1":
        return PROX_KINDS[name], eta * params[0], 0.0
    if name == "elasticnet":
        lam1, lam2 = params
        return PROX_KINDS[name], eta * lam1, 1.0 / (1.0 + 2.0 * eta * lam2)
    if name == "box":
        return PROX_KINDS[name], params[0], params[1]
    raise ValueError(f"non-elementwise prox {name!r} cannot fuse")


def prox_epilogue(xn, kind: int, c1: float, c2: float):
    if kind == PROX_KINDS["l1"]:
        return torch.sign(xn) * torch.clamp(torch.abs(xn) - c1, min=0.0)
    if kind == PROX_KINDS["elasticnet"]:
        return (torch.sign(xn) * torch.clamp(torch.abs(xn) - c1, min=0.0)
                * c2)
    if kind == PROX_KINDS["box"]:
        return torch.clamp(xn, c1, c2)
    return xn


def vr_update_ref(x, g, g_old, gbar, gtilde, *, eta: float, m: int,
                  saga: bool = False, decay: float = 0.0, prox=None):
    """Returns (x', table', gtilde', gbar'):

        v       = g - g_old + gbar
        x'      = prox(x*(1 - eta*decay) - eta*v)
        table'  = g
        gtilde' = gtilde + g*(1/m)
        gbar'   = gbar + (g - g_old)*(1/m) if saga else gbar

    computed in g's dtype (float32 for bfloat16 state), each result
    rounded back to its operand's dtype, as the reference's flattening
    wrapper casts around its float32 kernel."""
    inv_m = 1.0 / m
    c = g.dtype
    xc, go, gb, gt = (t.to(c) for t in (x, g_old, gbar, gtilde))
    v = g - go + gb
    xn = xc * (1.0 - eta * decay) - eta * v
    xn = prox_epilogue(xn, *epilogue_constants(prox, eta))
    gtilde_new = (gt + g * inv_m).to(gtilde.dtype)
    gbar_new = ((gb + (g - go) * inv_m).to(gbar.dtype) if saga else gbar)
    return xn.to(x.dtype), g, gtilde_new, gbar_new
