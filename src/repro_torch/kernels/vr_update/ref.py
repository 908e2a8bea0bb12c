"""Plain PyTorch versions of the fused VR update — the arithmetic of the
CUDA kernel in ``csrc/vr_update.cu`` op for op, on any device — and of
the fused epoch of ``csrc/vr_epoch.cu``, a loop of that update.

The wrappers in ``kernel.py`` and ``epoch.py`` run them for tensors on
the CPU; tests hold them against the reference (``vr_update_ref``
followed by ``prox.operators.apply``; ``core/fused.py``'s epochs), and
``chip_smoke.py`` holds the kernels against them on the card.
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


# VR lanes of the epoch kernel (csrc/vr_epoch.cu), as it numbers them
LANES = {"centralvr": 0, "saga": 1, "svrg": 2}


def residual(z, bb, kind: str):
    """s = l'(z; b) per sample, the scalar the VR tables store, for a
    problem ``kind``: logistic, ridge, huber@delta, pseudo_huber@delta
    (delta 1.0 without a tag). The epoch kernel's loss stage, and the one
    definition the convex drivers use (``convex._pointwise_residual``)."""
    base, _, tail = kind.partition("@")
    delta = float(tail) if tail else 1.0
    if base == "logistic":
        return -bb * torch.sigmoid(-bb * z)
    if base == "ridge":
        return 2.0 * (z - bb)
    r = z - bb
    if base == "huber":
        return torch.clamp(r, -delta, delta)
    if base == "pseudo_huber":
        return r / torch.sqrt(1.0 + (r / delta) ** 2)
    raise ValueError(f"unknown problem kind {kind!r}")


def vr_epoch_ref(A, b, orders, x, table, gbar, *, lane: str, kind: str,
                 eta: float, decay: float, m: int, prox=None,
                 track: bool = False):
    """A fused VR epoch of p workers as a loop of steps, each one
    ``vr_update_ref`` (the arithmetic of ``csrc/vr_epoch.cu``): ``A``
    (p, n, d), ``b`` (p, n), ``orders`` (p, T) indices into each
    worker's shard, ``x`` and ``gbar`` (p, d), ``table`` (p, n). Step t
    visits i = orders[:, t]:

        s     = l'(a_i . x; b_i)          (:func:`residual`)
        x, acc, gbar <- vr_update_ref(x, s*a_i, table[i]*a_i, gbar, acc)
        table[i] = s                            (lanes centralvr and saga)

    ``lane``: "centralvr" (acc accumulates g/m, gbar read only), "saga"
    (gbar += (g - g_old)/m in the step, no acc) or "svrg" (``table`` is
    the snapshot residuals sbar, read only; no acc). Returns (x, table,
    gbar, acc): new tensors where the lane changes them, else the inputs
    themselves; acc is None outside the centralvr lane. ``track`` (the
    centralvr lane): a fifth output, the (p, T, d) iterates before each
    step. The inputs are not modified."""
    if lane not in LANES:
        raise ValueError(f"vr_epoch: lane must be one of {sorted(LANES)}, "
                         f"got {lane!r}")
    # the epoch's rows and labels in visit order, gathered once
    workers = torch.arange(A.shape[0], device=A.device)[:, None]
    rows, labels = A[workers, orders], b[workers, orders]
    saga = lane == "saga"
    x = x.clone()
    tbl = table if lane == "svrg" else table.clone()
    acc = torch.zeros_like(x)     # the gtilde lane; scratch outside centralvr
    traj = (x.new_empty((x.shape[0], orders.shape[1], x.shape[1]))
            if track else None)
    for t in range(orders.shape[1]):
        if track:
            traj[:, t] = x
        a = rows[:, t]
        idx = orders[:, t:t + 1]
        s = residual(torch.linalg.vecdot(a, x), labels[:, t], kind)
        x, _, acc, gbar = vr_update_ref(
            x, s[:, None] * a, tbl.gather(1, idx) * a, gbar, acc, eta=eta,
            m=m, saga=saga, decay=decay, prox=prox)
        if lane != "svrg":
            tbl.scatter_(1, idx, s[:, None])
    out = (x, tbl, gbar, acc if lane == "centralvr" else None)
    return out + (traj,) if track else out
