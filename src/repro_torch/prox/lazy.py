"""Sparse features with LAZY variance-reduced updates — the port of
``repro/prox/lazy.py`` (``sampling="sparse"``).

On sparse data the CentralVR step touches only the nonzero coordinates of
the sampled row through its correction term, but the epoch-frozen mean
gradient ``gbar`` and the prox are DENSE: every step, every untouched
coordinate j moves by the same fixed map

    psi(z) = S_c(z + b_j),     b_j = -eta * gbar_j,   c = eta * lam1

(soft-threshold ``S_c`` of the l1 prox; c = 0 without a prox). Since
``gbar`` is frozen for the epoch, k skipped steps compose in closed form
(``lazy_apply``: four masked phase advances with ceil-counted crossing
steps). Per-coordinate last-touched counters record when each coordinate
was last materialized; the catch-up is applied on gather, and one final
catch-up at epoch end materializes the dense iterate. Per-step work is
O(nnz) instead of O(d), and trajectories agree with the dense prox'd
CentralVR driver (``core/centralvr.py``) to 1e-10 in float64.

An epoch is one call of ``kernels/lazy_epoch``: on CUDA tensors one launch
of the hand-written kernel ``csrc/lazy_epoch.cu`` (the counterpart of the
reference's jitted scan ``_lazy_epoch``), on CPU tensors its plain
version, ``ref.lazy_epoch_ref``.

Scope: ``prob.lam == 0`` (a ridge term rescales x every step, which breaks
the closed-form composition) and prox None or ``l1`` (the only elementwise
prox that composes with the drift in closed form). ``solver.RunSpec``
enforces the same limits for ``sampling="sparse"``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import convex
from repro_torch.core.convex import DTYPE, Problem
from repro_torch.kernels.lazy_epoch import kernel as lazy_kernel
from repro_torch.kernels.lazy_epoch.ref import lazy_apply
from repro_torch.prox import operators as proxops

__all__ = ["SparseProblem", "sparsify", "make_sparse_data", "lazy_apply",
           "run_sparse"]


class SparseProblem(NamedTuple):
    """Fixed-width row storage: each row i holds ``width`` DISTINCT
    coordinates ``idx[i]`` with values ``val[i]`` (zero on padding
    entries). Distinctness makes padding exact: a zero-valued entry at
    coordinate j applies the plain drift map to j, which is what the lazy
    catch-up would have done (see :func:`sparsify`)."""

    idx: torch.Tensor      # (n, width) int32, distinct within each row
    val: torch.Tensor      # (n, width) feature values, 0.0 on padding
    b: torch.Tensor        # (n,) targets/labels
    lam: float             # kept for Problem parity; 0 on the lazy path
    kind: str
    d: int

    @property
    def n(self):
        return self.idx.shape[0]

    @property
    def width(self):
        return self.idx.shape[1]


_PACK_CACHE: dict = {}      # id(A) -> (A strong ref, width, SparseProblem)
_PACK_CACHE_CAP = 4


def _cached_sparsify(prob: Problem, width: Optional[int] = None):
    """:func:`sparsify` with a small keep-alive cache: repeated solves of
    the SAME problem (sweeps, warm timing calls) skip the repack. Keyed
    on ``id(prob.A)`` with the tensor held strongly, so the id stays valid
    for as long as the entry lives; at capacity the oldest entry goes."""
    k = id(prob.A)
    hit = _PACK_CACHE.get(k)
    if hit is not None and hit[0] is prob.A and hit[1] == width:
        return hit[2]
    sp = sparsify(prob, width)
    if len(_PACK_CACHE) >= _PACK_CACHE_CAP:
        _PACK_CACHE.pop(next(iter(_PACK_CACHE)))
    _PACK_CACHE[k] = (prob.A, width, sp)
    return sp


def sparsify(prob: Problem, width: Optional[int] = None) -> SparseProblem:
    """Pack a dense Problem into fixed-width sparse rows, losslessly, on
    the problem's device.

    ``width`` defaults to the largest row support; a stable argsort of the
    zero-mask puts each row's nonzero coordinates first (in coordinate
    order) and pads from that row's zero coordinates, so indices stay
    distinct within a row and every padding value is exactly 0."""
    A = prob.A
    n, d = A.shape
    mask = A != 0
    kmax = int(mask.sum(dim=1).max()) if n else 0
    w = kmax if width is None else int(width)
    if w < kmax:
        raise ValueError(
            f"sparsify: width={w} would drop nonzeros (max row support "
            f"is {kmax})")
    w = min(max(w, 1), d)
    order = torch.argsort((~mask).to(torch.uint8), dim=1,
                          stable=True)[:, :w]
    vals = A.gather(1, order)
    return SparseProblem(order.to(torch.int32).contiguous(),
                         vals.contiguous(), prob.b.contiguous(), prob.lam,
                         prob.kind, d)


def make_sparse_data(gen: torch.Generator, n: int, d: int, nnz: int, *,
                     kind: str = "ridge", noise: float = 0.01) -> Problem:
    """Synthetic sparse-feature problem on ``gen.device``, lam = 0 (the
    lazy path's regime): each row draws ``nnz`` distinct coordinates
    uniformly, values standard normal scaled by 1/sqrt(nnz); returned
    DENSE, so the dense drivers, the metric and the oracle run unchanged
    (:func:`run_sparse` packs it with :func:`sparsify`)."""
    if not 1 <= nnz <= d:
        raise ValueError(f"make_sparse_data: need 1 <= nnz={nnz} <= d={d}")
    if kind not in ("logistic", "ridge"):
        raise ValueError(f"make_sparse_data: unknown kind {kind!r}")
    dev = gen.device
    # the nnz smallest of d uniform draws a row: a uniform nnz-subset
    u = torch.rand(n, d, generator=gen, device=dev, dtype=DTYPE)
    idx = torch.topk(u, nnz, dim=1, largest=False).indices
    del u
    vals = torch.randn(n, nnz, generator=gen, device=dev,
                       dtype=DTYPE) / float(np.sqrt(nnz))
    A = torch.zeros(n, d, device=dev, dtype=DTYPE).scatter_(1, idx, vals)
    x_star = torch.randn(d, generator=gen, device=dev,
                         dtype=DTYPE) / float(np.sqrt(d))
    z = A @ x_star + noise * torch.randn(n, generator=gen, device=dev,
                                         dtype=DTYPE)
    b = torch.sign(z) if kind == "logistic" else z
    return Problem(A, b, 0.0, kind)


def run_sparse(prob: Problem, *, eta: float, epochs: int, orders=None,
               seed: int = 0, x0=None, prox=None):
    """Algorithm 1 with lazy sparse updates, the ``sampling="sparse"``
    execution of ``centralvr.run``: the same return (state, rels,
    grad_evals), the same visit orders (``orders`` = (init (n,),
    per-epoch (epochs, n)) permutations, e.g. the reference's draws via
    ``repro_torch.convert.centralvr_orders``; ``None`` draws them from a
    ``torch.Generator`` seeded with ``seed``), the same arithmetic
    restricted to row supports: the dense prox'd permutation driver is
    the exact oracle. One ``lazy_epoch`` call (one launch on the card)
    for the init epoch and one per epoch."""
    from repro_torch.core import centralvr
    from repro_torch.core.distributed import _as_orders, _generator

    if float(prob.lam) != 0.0:
        raise ValueError(
            "sparse lazy updates require lam == 0: the ridge term 2*lam*x "
            "multiplies every coordinate every step, which breaks the "
            "closed-form drift composition; use the dense driver (or fold "
            "the l2 term into the data)")
    px = proxops.parse(prox) if prox is not None else None
    if px is not None and px.name != "l1":
        raise ValueError(
            f"sparse lazy updates support prox None or 'l1', got "
            f"{px.name!r}: only the soft-threshold composes with the "
            "drift in closed form")
    c = eta * (px.params[0] if px is not None else 0.0)
    sp = _cached_sparsify(prob)
    n, d = prob.n, prob.d
    device = prob.A.device
    if orders is None:
        orders = centralvr.draw_orders(_generator(device, seed), n, epochs)
    init, per = _as_orders(orders, ((n,), (epochs, n)), device, n)

    def lazy_epoch(x, table, gbar, perm, vr):
        return lazy_kernel.lazy_epoch_in_range(
            sp.idx, sp.val, sp.b, sp.kind, x, table, gbar,
            perm.contiguous(), eta=eta, c=c, vr=vr)

    zeros = torch.zeros(d, dtype=prob.A.dtype, device=device)
    x = zeros if x0 is None else torch.as_tensor(
        x0, dtype=prob.A.dtype, device=device).contiguous()
    table = torch.zeros(n, dtype=prob.A.dtype, device=device)
    # init: one plain-SGD epoch (Algorithm 1 line 2), lazily
    x, table, gbar = lazy_epoch(x, table, zeros, init, False)
    g0 = convex.grad_norm0(prob, prox=px, eta=eta)
    rels = []
    for e in range(epochs):
        x, table, gbar = lazy_epoch(x, table, gbar, per[e], True)
        rels.append(convex.rel_grad_norm(prob, x, g0, prox=px, eta=eta))
    rels = (torch.stack(rels) if rels
            else torch.zeros(0, dtype=prob.A.dtype, device=device))
    grad_evals = n * np.arange(2, epochs + 2)
    return centralvr.VRState(x=x, table=table, gbar=gbar), rels, grad_evals
