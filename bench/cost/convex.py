"""Bytes of one fused CentralVR epoch (``vr_epoch``) of p workers over
their shards, float64: each visited row, its index, label and table
entry read once and the entry written once; each worker's x read and
written, gbar read and the accumulator written once."""
from __future__ import annotations


def vr_epoch_bytes(p: int, steps: int, d: int, item: int = 8) -> int:
    per_step = d * item + 8 + item + 2 * item
    return p * steps * per_step + 4 * p * d * item


def samples_per_solve(p: int, n: int, rounds: int) -> int:
    """Sample gradients one solve evaluates: the initialisation epoch
    and ``rounds`` local epochs of every worker."""
    return p * n * (rounds + 1)
