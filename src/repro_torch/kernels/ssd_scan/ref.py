"""Plain PyTorch version of the SSD chunk scan — the arithmetic of the
CUDA kernel in ``csrc/ssd_scan.cu``, chunk by chunk, on any device.

Flat signature, as the reference's kernel: ``la`` (BH, S) log-decay,
``x`` (BH, S, P) discretized input, ``Bc`` / ``Cc`` (B, S, N) shared by
the H = BH // B heads of a batch row (row ``bh`` reads row ``bh // H``).
Per chunk of ``chunk`` steps, with the state ``h`` (BH, P, N) carried in
order from zero:

    L = cumsum(la)            (in float64, rounded once to float32)
    y = tril((C B^T) * exp(min(L_i - L_j, 0))) x  +  exp(L) * (C h^T)
    h = exp(L_Q) h + x^T (B * exp(L_Q - L))

S need not be a multiple of the chunk: the tail is padded with zero
log-decay and zero input, which leaves every real row unchanged.

The wrapper in ``kernel.py`` runs it for tensors on the CPU; tests hold
it against the reference's kernel (interpret mode) and oracles, and
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_scan_ref(la, x, Bc, Cc, *, chunk: int):
    BH, S = la.shape
    H = BH // Bc.shape[0]
    pad = (-S) % chunk
    f32 = torch.float32
    la, x = la.to(f32), x.to(f32)
    Bm, Cm = Bc.to(f32), Cc.to(f32)
    if pad:
        la = F.pad(la, (0, pad))
        x = F.pad(x, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    rows = torch.arange(BH, device=la.device) // H
    Bm, Cm = Bm[rows], Cm[rows]                     # (BH, S, N)
    Q, P, N = chunk, x.shape[-1], Bm.shape[-1]
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                   device=la.device))
    h = torch.zeros(BH, P, N, dtype=f32, device=la.device)
    ys = []
    for c0 in range(0, S + pad, Q):
        sl = slice(c0, c0 + Q)
        # in double, rounded once: the same float32 L in any summation
        # order (see the kernel's note)
        L = torch.cumsum(la[:, sl].double(), -1).to(f32)   # (BH, Q)
        Bq, Cq, xq = Bm[:, sl], Cm[:, sl], x[:, sl]
        scores = Cq @ Bq.transpose(1, 2)            # (BH, Q, Q)
        decay = torch.exp(torch.clamp(L[:, :, None] - L[:, None, :],
                                      max=0.0))
        w = torch.where(causal, scores * decay, 0.0)
        ys.append(w @ xq + torch.exp(L)[..., None]
                  * (Cq @ h.transpose(1, 2)))
        tot = L[:, -1:]                             # (BH, 1)
        h = (h * torch.exp(tot)[..., None]
             + xq.transpose(1, 2) @ (Bq * torch.exp(tot - L)[..., None]))
    return torch.cat(ys, 1)[:, :S]
