"""Synthetic LM token streams with the finite-sum structure CentralVR
needs: each (worker w, microbatch index i) pair maps to a FIXED
microbatch, the same tokens every epoch, so f_i = loss(microbatch_i) is a
well-defined component function and the VR tables are meaningful.

The port's counterpart of ``repro/data/synthetic.py``. The tokens are
drawn with a ``torch.Generator`` seeded from (seed, worker, index), so
they are the same on every call and every restart, but they are not the
reference's ``jax.random`` tokens: agreement tests pass the reference's
``epoch_tokens`` block to the runner as ``tokens=`` instead.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig


def _generator(seed: int, *idx: int) -> torch.Generator:
    key = seed
    for i in idx:
        key = (key * 1_000_003 + i + 1) % (2 ** 63)
    return torch.Generator().manual_seed(key)


def microbatch_tokens(cfg: ModelConfig, seed: int, worker: int, index: int,
                      batch: int, seq: int) -> torch.Tensor:
    """The i-th FIXED microbatch of worker w: (batch, seq) int64 on the
    CPU, the same tokens on every call. Low-entropy structure (a periodic
    pattern on 70% of the positions) so the training loss can fall."""
    gen = _generator(seed, worker, index)
    base = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    period = torch.randint(2, 17, (batch, 1), generator=gen)
    pos = torch.arange(seq)[None, :]
    structured = (pos % period) * 37 % cfg.vocab_size
    use = torch.rand((batch, seq), generator=gen) < 0.7
    return torch.where(use, structured, base)


def epoch_tokens(cfg: ModelConfig, seed: int, *, workers: int, steps: int,
                 accum: int, microbatch: int, seq: int,
                 table_size: int) -> torch.Tensor:
    """All tokens of one communication epoch: (W, steps, A, mb, S). Step k
    uses component i = k mod M on every worker, microbatches
    i*A .. i*A + A - 1 of that worker. Because the stream is a finite sum,
    every later epoch replays this block verbatim."""
    out = torch.empty((workers, steps, accum, microbatch, seq),
                      dtype=torch.int64)
    for w in range(workers):
        for s in range(steps):
            idx = s % table_size
            for a in range(accum):
                out[w, s, a] = microbatch_tokens(cfg, seed, w, idx * accum + a,
                                                 microbatch, seq)
    return out


def frontend_embeds(cfg: ModelConfig, seed: int, batch: int,
                    dtype=torch.float32):
    """STUB modality frontend: pre-computed patch / frame embeddings
    (batch, frontend_tokens, d) on the CPU, the reference's stand-in for
    an encoder's output (normal draws, each token averaged with its
    neighbour's, so neighbouring tokens correlate); None for an arch
    without frontend tokens."""
    if not (cfg.frontend and cfg.frontend_tokens):
        return None
    gen = _generator(seed, 999)
    base = torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                       generator=gen, dtype=dtype)
    # smooth across tokens (neighbouring patches correlate)
    return 0.5 * base + 0.5 * torch.roll(base, 1, dims=1)


def eval_batch(cfg: ModelConfig, seed: int, batch: int,
               seq: int) -> torch.Tensor:
    """Held-out batch (indices offset far from the training table)."""
    return microbatch_tokens(cfg, seed, worker=10_000, index=0, batch=batch,
                             seq=seq)
