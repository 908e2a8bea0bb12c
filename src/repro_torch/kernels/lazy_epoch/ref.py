"""Plain PyTorch version of one lazy sparse epoch — the arithmetic of the
CUDA kernel ``csrc/lazy_epoch.cu``, step by step, on any device — and of
the closed-form drift map it applies to every skipped coordinate.

It is the counterpart of the reference's jitted scan ``_lazy_epoch``
(``src/repro/prox/lazy.py:215``), in the reference's order of operations.
The wrapper in ``kernel.py`` runs it for tensors on the CPU; tests hold it
against the reference, and ``chip_smoke.py`` holds the kernel against it
on the card. ``prox/lazy.py`` re-exports :func:`lazy_apply`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.vr_update.ref import residual


def soft(z, c):
    """Soft-threshold S_c(z) = sign(z) * max(|z| - c, 0)."""
    return torch.sign(z) * torch.clamp(torch.abs(z) - c, min=0.0)


def _ceil_steps(num, den, rem):
    """The largest step count that keeps the current sign,
    ``ceil(num/den) - 1``, clamped to [0, rem] in float64 BEFORE the cast
    to an integer. A tiny drift makes the quotient exceed 2**31 (or
    overflow to inf): the reference's cast saturates there, PyTorch's
    wraps to the most negative integer, and C++ leaves it undefined, so
    the clamp comes first (NaN counts as 0, as the reference's cast
    makes it)."""
    q = num / torch.where(den == 0.0, torch.ones_like(den), den)
    t = torch.ceil(q) - 1.0
    t = torch.where(t > 0.0, t, torch.zeros_like(t))
    return torch.minimum(t, rem.to(t.dtype)).to(rem.dtype)


def lazy_apply(z, k, b, c):
    """Apply ``psi^k`` elementwise, ``psi(z) = S_c(z + b)``, in closed form.

    psi is piecewise linear: while the iterate stays strictly positive it
    moves by ``b - c`` a step, while strictly negative by ``b + c``, and
    zero is absorbing iff ``|b| <= c``. Each of four rounds jumps to the
    end of the current phase in one masked closed-form advance
    (ceil-counted steps that keep the sign), then takes ONE exact psi step
    across the phase boundary; a trajectory crosses at most three phases,
    so four rounds consume ``k``. ``k`` is an integer tensor (>= 0)
    broadcastable against ``z``; ``b`` likewise; ``c`` a float."""
    z = torch.as_tensor(z)
    rem = torch.broadcast_to(torch.as_tensor(k, device=z.device),
                             z.shape).to(torch.int64)
    b = torch.broadcast_to(torch.as_tensor(b, dtype=z.dtype,
                                           device=z.device), z.shape)
    dp = b - c                          # per-step move while z > 0
    dn = b + c                          # per-step move while z < 0
    fin = torch.zeros_like(rem)
    absorbing = torch.abs(b) <= c
    for _ in range(4):
        pos, neg = z > 0, z < 0
        # closed-form advance within the current phase
        t_pos = torch.where(dp >= 0, rem, _ceil_steps(z, -dp, rem))
        t_neg = torch.where(dn <= 0, rem, _ceil_steps(-z, dn, rem))
        t_zero = torch.where(absorbing, rem, fin)
        t = torch.where(pos, t_pos, torch.where(neg, t_neg, t_zero))
        tf = t.to(z.dtype)
        z = torch.where(pos, z + tf * dp, torch.where(neg, z + tf * dn, z))
        rem = rem - t
        # one exact step across the phase boundary
        step = rem > 0
        z = torch.where(step, soft(z + b, c), z)
        rem = torch.where(step, rem - 1, rem)
    return z


def lazy_epoch_ref(idx, val, b, kind: str, z, table, gbar, perm, *,
                   eta: float, c: float, vr: bool):
    """One lazy epoch over the rows ``perm`` (T,) of the fixed-width sparse
    rows ``idx`` (n, width) int32 (distinct within a row) and ``val``
    (n, width), labels ``b`` (n,), from the iterate ``z`` (d,), the scalar
    table ``table`` (n,) and the frozen mean gradient ``gbar`` (d,).

    ``vr=True`` is the CentralVR epoch (correction from the table, drift
    ``-eta*gbar`` on every coordinate a step); ``vr=False`` the plain-SGD
    init epoch (no correction, no drift). Step t visits i = perm[t], whose
    entries of value 0 (``sparsify``'s padding) it skips, as the kernel
    does: J are the row's other coordinates. A value-0 entry applies
    exactly one drift step psi to its coordinate, which the next catch-up
    applies in closed form, so the skip changes the result by rounding
    only (the reference's scan, which updates them, agrees to 1e-10):

        zJ = lazy_apply(z[J], t - last[J], drift[J], c)   (catch the row up)
        s  = l'(val[i] . zJ; b[i])
        v  = (s - table[i]) * val[i] + gbar[J]            (vr; else s * val[i])
        z[J] = S_c(zJ - eta * v);  last[J] = t + 1;  table[i] = s
        acc[J] += s * val[i] / n

    then every coordinate catches up to step T. Returns (z, table, acc),
    new tensors; the inputs are not modified."""
    n = idx.shape[0]
    drift = -eta * gbar if vr else torch.zeros_like(gbar)
    z = z.clone()
    table = table.clone()
    last = torch.zeros(z.shape, dtype=torch.int64, device=z.device)
    acc = torch.zeros_like(z)
    T = perm.shape[0]
    for t, i in enumerate(perm.tolist()):
        live = val[i] != 0
        J = idx[i][live].long()
        w = val[i][live]
        zJ = lazy_apply(z[J], t - last[J], drift[J], c)
        s_new = residual(w @ zJ, b[i], kind)
        if vr:
            vJ = (s_new - table[i]) * w + gbar[J]
        else:
            vJ = s_new * w
        z[J] = soft(zJ - eta * vJ, c)
        last[J] = t + 1
        table[i] = s_new
        acc[J] += s_new * w / n
    # materialize: every coordinate catches up to the end of the epoch
    z = lazy_apply(z, T - last, drift, c)
    return z, table, acc
