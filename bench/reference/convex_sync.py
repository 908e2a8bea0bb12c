"""Plain PyTorch reference of CentralVR-Sync (the paper's Algorithm 2) on
l2-regularised logistic regression.

f(x) = mean_j log(1 + exp(-b_j a_j.x)) + lam |x|^2 over all p * n rows.
The residual of row j is s_j(x) = -b_j sigmoid(-b_j a_j.x), so its
gradient is s_j a_j + 2 lam x.

Initialisation: every worker runs one plain SGD epoch from x = 0 over its
shard in the given order, writing s_j into its table and s_j a_j / n into
its accumulator; x is the workers' mean, gbar the accumulators' mean.
A round: every worker starts from x and runs one epoch in the given
order; step j takes v = (s_j - table_j) a_j + gbar + 2 lam x,
x <- x - eta v, table_j <- s_j, acc <- acc + s_j a_j / n; then x and gbar
are the workers' means. After each round the run records
|grad f(x)| / |grad f(0)|.

The step size is the practical c / L with c = 0.3 and L = sup l'' * max
row |a|^2 + 2 lam (sup l'' = 1/4 for the logistic loss). Workers, and
several draws of visit orders, are batch dimensions; each step is a
handful of plain tensor operations.
"""
from __future__ import annotations

import torch

ETA_C = 0.3


def step_size(A, lam: float) -> float:
    row_sq = (A * A).sum(-1).max()
    return float(ETA_C / (0.25 * row_sq + 2.0 * lam))


def residual(z, b):
    return -b * torch.sigmoid(-b * z)


def full_grad(A, b, lam: float, x):
    """grad f(x) over every row of every worker: A (p, n, d)."""
    s = residual(A @ x, b)                                   # (p, n)
    return torch.einsum("pn,pnd->d", s, A) / (A.shape[0] * A.shape[1]) \
        + 2.0 * lam * x


def _epoch(A, b, lam, eta, x, table, gbar, order, sgd: bool):
    """One local epoch of every worker of every draw: x (k, p, d), table
    (k, p, n), gbar (k, 1, d), order (k, p, T). The rows, labels and
    table entries each step visits are looked up by flat indices made
    once an epoch."""
    k, p, d = x.shape
    n = A.shape[1]
    rows = (torch.arange(p, device=A.device)[:, None] * n + order)  # k,p,T
    entries = (torch.arange(k, device=A.device)[:, None, None] * (p * n)
               + rows)
    rows = rows.reshape(k * p, -1).T.contiguous()                   # T,kp
    entries = entries.reshape(k * p, -1).T.contiguous()
    neg_b = -b.reshape(-1)[rows]                                     # T,kp
    A2, tbl = A.reshape(p * n, d), table.view(-1)
    x = x.reshape(k * p, d).clone()
    acc = torch.zeros_like(x)
    if not sgd:
        gbar = gbar.expand(k, p, d).reshape(k * p, d)
    for t in range(rows.shape[0]):
        a = A2.index_select(0, rows[t])
        s = neg_b[t] * torch.sigmoid(neg_b[t] * torch.linalg.vecdot(a, x))
        if sgd:
            v = torch.addcmul(x * (2.0 * lam), s[:, None], a)
        else:
            old = tbl.index_select(0, entries[t])
            v = torch.addcmul(torch.add(gbar, x, alpha=2.0 * lam),
                              (s - old)[:, None], a)
        tbl.index_copy_(0, entries[t], s)
        acc.addcmul_(s[:, None], a, value=1.0 / n)
        x.sub_(v, alpha=eta)
    return x.view(k, p, d), acc.view(k, p, d)


def solve(A, b, lam: float, init, rounds, dtype=torch.float64):
    """CentralVR-Sync from x = 0 for k draws of visit orders at once:
    ``init`` (k, p, n) and ``rounds`` (k, R, p, n). Returns (final x (k,
    d), rels (k, R)), both float64 on the device, computed in ``dtype``."""
    A, b = A.to(dtype), b.to(dtype)
    p, n, d = A.shape
    k = init.shape[0]
    eta = step_size(A, lam)
    x = torch.zeros((k, p, d), dtype=dtype, device=A.device)
    table = torch.zeros((k, p, n), dtype=dtype, device=A.device)
    x, acc = _epoch(A, b, lam, eta, x, table, None, init, sgd=True)
    xc, gbar = x.mean(1), acc.mean(1, keepdim=True)
    g0 = torch.linalg.vector_norm(full_grad(A, b, lam, torch.zeros(
        d, dtype=dtype, device=A.device)))
    rels = []
    for r in range(rounds.shape[1]):
        x, acc = _epoch(A, b, lam, eta, xc[:, None].expand(k, p, d), table,
                        gbar, rounds[:, r], sgd=False)
        xc, gbar = x.mean(1), acc.mean(1, keepdim=True)
        rels.append(torch.stack([torch.linalg.vector_norm(
            full_grad(A, b, lam, xc[i])) for i in range(k)]) / g0)
    return xc.double(), torch.stack(rels, 1).double()
