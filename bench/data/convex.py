"""Data and visit orders of a distributed convex cell, made from the seed
on the device.

The benchmark's own copy of the paper's §6.2 generator (the program's
``core/convex.py`` ``make_logistic_data`` and ``core/distributed.py``
``make_distributed``): every worker holds its own n rows, the first half
of class +1 drawn normal around +mu, the rest of class -1 around -mu,
with mu = (0.5, 0, ..., 0). The whole (p, n, d) block is one draw.

Orders are permutations of each shard, one for the initialisation epoch
and one for each round, drawn as the argsort of uniform keys.
"""
from __future__ import annotations

import torch


def logistic(seed: int, *, p: int, n: int, d: int, device,
             dtype=torch.float64):
    """(A (p, n, d), b (p, n)) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((p, n, d), generator=gen, device=device, dtype=dtype)
    half = n // 2
    A[:, :half, 0] += 0.5
    A[:, half:, 0] -= 0.5
    b = torch.ones((p, n), device=device, dtype=dtype)
    b[:, half:] = -1.0
    return A, b


def orders(seed: int, *, sets: int, rounds: int, p: int, n: int, device):
    """``sets`` draws of (init (p, n), per-round (rounds, p, n)) int64
    permutations on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed + 7_919)
    keys = torch.rand((sets, rounds + 1, p, n), generator=gen,
                      device=device)
    perms = keys.argsort(dim=-1)
    return [(perms[s, 0].contiguous(), perms[s, 1:].contiguous())
            for s in range(sets)]
