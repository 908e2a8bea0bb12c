"""The cases that hold ``lazy_epoch`` against its plain version on the
card, one list for ``chip_smoke.py`` (phase 5b (a)) and the card tests,
and the inputs of one call, drawn from a seeded generator on any device.

vr on and off x logistic and ridge x prox none and l1 at the agreement
tests' shape (n 48, d 40, width 3); width 1; widths above a block's
threads (300: 4 entries a thread; 1024: 8, the widest row the kernel
takes); zero absorbing (|eta * gbar| <= c); drift ~1e-300 and ~1e-12
with z ~ 0.1, where ceil(z / drift) passes 2**31 or overflows; the
README's sparse shape over a whole epoch; rows of varying length (padding
entries of value 0, which the kernel skips) at the uniform-74 stand-in's
n and d, the epoch cut to its first 2000 steps; consecutive rows that
share most coordinates (d = 2 x width); rows visited twice in a row and
every other step; d past what the kernel's per-coordinate stamps hold in
shared memory (about 111,000 at width 74, 48,600 at width 1024), where it
tracks the last rows' coordinates in hash tables instead.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

ETA = 0.05
# the varying-length rows: a log-normal law of lengths (sigma 1) with
# this mean before the cut at the longest
MEAN_LENGTH = 74
LONGEST = 1024


class Case(NamedTuple):
    label: str
    shape: tuple          # (n, d, width)
    kind: str
    vr: bool
    l1: float             # the l1 weight: c = ETA * l1
    gbar_scale: float
    tiny: bool            # gbar entries ~1e-300 and ~1e-12 (no prox)
    seed: int
    ragged: bool = False  # lengths drawn by ``ragged_rows`` (width: the
                          # longest row; shape[2] is the law's cut)
    mean: float = MEAN_LENGTH   # the law's mean before the cut
    steps: int = 0        # 0: a whole epoch; else its first ``steps``
    repeats: bool = False  # the perm visits each row twice in a row, then
                           # rows a, b, a, b, ...


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
            False, 73),
       Case("varying length", (20242, 47236, LONGEST), "logistic", True,
            1e-5, 1e-3, False, 74, ragged=True, steps=2000),
       Case("shared coordinates", (200, 64, 32), "logistic", True, 0.02,
            0.01, False, 75),
       Case("shared coordinates, varying length", (200, 64, 32), "ridge",
            False, 0.02, 0.01, False, 76, ragged=True, mean=12),
       Case("repeated rows", (64, 200, 12), "ridge", True, 0.02, 0.01,
            False, 77, repeats=True),
       Case("d past the stamps", (256, 200000, 16), "logistic", True, 0.02,
            0.01, False, 78, repeats=True),
       Case("d past the stamps, width 1024", (48, 60000, 1024), "ridge",
            True, 0.0, 0.01, False, 79)])


def ragged_rows(g, n: int, d: int, longest: int, mean: float = MEAN_LENGTH):
    """Sparse rows of varying length, drawn from the generator ``g`` on its
    device: row i holds L_i = clamp(round(exp(mu + N(0, 1))), 1, longest)
    distinct coordinates, uniform over d (a log-normal law of lengths whose
    mean before the cut is ``mean``), with values N(0, 1) / sqrt(L_i), then
    zero-valued padding up to the longest row, as ``sparsify`` pads.
    Returns (idx (n, width) int32, val (n, width) float64, lengths)."""
    import math

    dev = g.device
    f64 = dict(device=dev, dtype=torch.float64)
    mu = math.log(mean) - 0.5
    lengths = torch.exp(mu + torch.randn(n, generator=g, **f64))
    lengths = lengths.round().clamp(1, min(longest, d)).long()
    width = int(lengths.max())
    # the ``width`` smallest of d uniform draws a row, some rows at a time
    idx = torch.cat([torch.topk(torch.rand(min(2048, n - r), d,
                                           generator=g, device=dev),
                                width, dim=1, largest=False).indices
                     for r in range(0, n, 2048)]).to(torch.int32)
    val = (torch.randn(n, width, generator=g, **f64)
           / lengths.to(torch.float64).sqrt()[:, None])
    val = torch.where(torch.arange(width, device=dev) < lengths[:, None],
                      val, torch.zeros((), **f64))
    return idx.contiguous(), val.contiguous(), lengths


def inputs(case: Case, device):
    """One call's arguments ``(idx, val, b, kind, z, table, gbar, perm)``
    and keywords ``(eta, c, vr)``: the sparse rows of ``make_sparse_data``
    (``sparsify``), a random iterate, table and gbar, and a permutation,
    from a generator seeded with ``case.seed``."""
    from repro_torch.prox import lazy

    n, d, width = case.shape
    g = torch.Generator(device=device).manual_seed(case.seed)
    f64 = dict(device=device, dtype=torch.float64)
    if case.ragged:
        idx, val, _ = ragged_rows(g, n, d, width, case.mean)
        b = torch.randn(n, generator=g, **f64)
        if case.kind == "logistic":
            b = torch.sign(b)
    else:
        sp = lazy.sparsify(lazy.make_sparse_data(g, n, d, width,
                                                 kind=case.kind))
        idx, val, b = sp.idx, sp.val, sp.b
    z = 0.1 * torch.randn(d, generator=g, **f64)
    table = 0.3 * torch.randn(n, generator=g, **f64)
    gbar = case.gbar_scale * torch.randn(d, generator=g, **f64)
    if case.tiny:
        scale = torch.where(torch.rand(d, generator=g, **f64) < 0.5, 1e-300,
                            1e-12)
        gbar = torch.randn(d, generator=g, **f64) * scale
    perm = torch.randperm(n, generator=g, device=device)
    if case.repeats:
        perm = torch.cat([perm.repeat_interleave(2),
                          torch.stack([perm, perm.roll(1)], 1).flatten()])
    if case.steps:
        perm = perm[:case.steps].contiguous()
    return ((idx, val, b, case.kind, z, table, gbar, perm),
            dict(eta=ETA, c=ETA * case.l1, vr=case.vr))
