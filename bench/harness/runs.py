"""What a cell kind's run hands to ``run.py``, and the card helpers the
kinds share."""
from __future__ import annotations

import dataclasses
import gc

import torch


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    e2e: dict                     # end-to-end metrics, and extras to print
    checks: dict                  # {number compared: (value, limit)}
    memory_peak_bytes: int
    trace: object = None          # the traced stretch (harness/trace.py)
    run: dict = None              # what the per-layer readers read


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak(device) -> int:
    """The allocator's peak since its last reset (0 off the card)."""
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
