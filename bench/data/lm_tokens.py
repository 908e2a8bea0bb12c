"""Token blocks of a CentralVR training cell, drawn from the seed on the
device.

The benchmark's own copy of the port's synthetic stream (the program's
``data/synthetic.py``): the finite sum of M fixed components, each of A
microbatches of ``microbatch`` rows; step k trains on component k mod M,
so every communication epoch replays the same block. A row is random
tokens with a periodic pattern on 70% of its positions, so the loss can
fall. Every row of the block differs from every other.
"""
from __future__ import annotations

import torch


def epoch_tokens(seed: int, *, vocab: int, table_size: int, local_epoch: int,
                 accum: int, microbatch: int, seq: int,
                 device) -> torch.Tensor:
    """(1, M*K, A, microbatch, seq) int64 on ``device``: one worker's
    communication epoch."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = table_size * accum * microbatch
    base = torch.randint(0, vocab, (rows, seq), generator=gen, device=device)
    period = torch.randint(2, 17, (rows, 1), generator=gen, device=device)
    pos = torch.arange(seq, device=device)[None, :]
    structured = (pos % period) * 37 % vocab
    use = torch.rand((rows, seq), generator=gen, device=device) < 0.7
    comp = torch.where(use, structured, base).view(table_size, accum,
                                                   microbatch, seq)
    steps = torch.arange(table_size * local_epoch, device=device) % table_size
    return comp[steps][None].contiguous()
