"""The cases that hold ``lazy_epoch`` against its plain version on the
card, one list for ``chip_smoke.py`` (phase 5b (a)) and the card tests,
and the inputs of one call, drawn from a seeded generator on any device.

vr on and off x logistic and ridge x prox none and l1 at the agreement
tests' shape (n 48, d 40, width 3); width 1; widths above a block's
threads (300: 4 entries a thread; 1024: 8, the widest row the kernel
takes); zero absorbing (|eta * gbar| <= c); drift ~1e-300 and ~1e-12
with z ~ 0.1, where ceil(z / drift) passes 2**31 or overflows; the
README's sparse shape over a whole epoch.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

ETA = 0.05


class Case(NamedTuple):
    label: str
    shape: tuple          # (n, d, width)
    kind: str
    vr: bool
    l1: float             # the l1 weight: c = ETA * l1
    gbar_scale: float
    tiny: bool            # gbar entries ~1e-300 and ~1e-12 (no prox)
    seed: int


CASES = tuple(
    [Case(f"grid {kind} vr {vr} l1 {l1}", (48, 40, 3), kind, vr, l1, 0.01,
          False, 60 + k)
     for k, (vr, kind, l1) in enumerate(itertools.product(
         (True, False), ("logistic", "ridge"), (0.0, 0.02)))]
    + [Case("width 1", (64, 50, 1), "ridge", True, 0.02, 0.01, False, 68),
       Case("width 300", (64, 1000, 300), "logistic", True, 0.02, 0.01,
            False, 69),
       Case("width 1024", (32, 4000, 1024), "ridge", True, 0.0, 0.01, False,
            70),
       Case("zero absorbing", (200, 100, 5), "ridge", True, 0.01, 0.001,
            False, 71),
       Case("tiny drift", (200, 100, 5), "ridge", True, 0.0, 0.0, True, 72),
       Case("README shape", (4096, 16384, 32), "ridge", True, 0.001, 0.01,
            False, 73)])


def inputs(case: Case, device):
    """One call's arguments ``(idx, val, b, kind, z, table, gbar, perm)``
    and keywords ``(eta, c, vr)``: the sparse rows of ``make_sparse_data``
    (``sparsify``), a random iterate, table and gbar, and a permutation,
    from a generator seeded with ``case.seed``."""
    from repro_torch.prox import lazy

    n, d, width = case.shape
    g = torch.Generator(device=device).manual_seed(case.seed)
    sp = lazy.sparsify(lazy.make_sparse_data(g, n, d, width,
                                             kind=case.kind))
    f64 = dict(device=device, dtype=torch.float64)
    z = 0.1 * torch.randn(d, generator=g, **f64)
    table = 0.3 * torch.randn(n, generator=g, **f64)
    gbar = case.gbar_scale * torch.randn(d, generator=g, **f64)
    if case.tiny:
        scale = torch.where(torch.rand(d, generator=g, **f64) < 0.5, 1e-300,
                            1e-12)
        gbar = torch.randn(d, generator=g, **f64) * scale
    perm = torch.randperm(n, generator=g, device=device)
    return ((sp.idx, sp.val, sp.b, case.kind, z, table, gbar, perm),
            dict(eta=ETA, c=ETA * case.l1, vr=case.vr))
