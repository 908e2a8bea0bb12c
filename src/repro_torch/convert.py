"""Carry data, state and randomness from the JAX reference (``repro``)
into the port, so that both packages compute the same run.

The reference's arrays arrive as anything ``np.asarray`` takes (a JAX
array converts without this module importing jax): a ``Problem`` /
``ShardedProblem`` or a ``VRState`` / ``SyncState`` becomes the port's
counterpart on ``device``.

The reference draws its visit orders inside its drivers with
``jax.random``; :func:`centralvr_orders` and :func:`sync_orders` replay
its key splits and return the draws as numpy arrays, in the ``orders``
layout of ``repro_torch.solve``. They take the caller's ``jax.random``
module as an argument, because this package never imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.centralvr import VRState
from repro_torch.core.convex import Problem
from repro_torch.core.distributed import ShardedProblem, SyncState


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def to_problem(ref, *, device) -> Problem | ShardedProblem:
    """A reference ``Problem`` (A of shape (n, d)) or ``ShardedProblem``
    (A of shape (p, ns, d)) as the port's, with ``lam`` kept at the
    reference's float32 value."""
    A, b = _tensor(ref.A, device), _tensor(ref.b, device)
    lam = float(np.asarray(ref.lam))
    cls = ShardedProblem if A.ndim == 3 else Problem
    return cls(A, b, lam, ref.kind)


def to_vr_state(ref, *, device) -> VRState:
    return VRState(*(_tensor(t, device) for t in (ref.x, ref.table,
                                                  ref.gbar)))


def to_sync_state(ref, *, device) -> SyncState:
    return SyncState(*(_tensor(t, device) for t in (ref.x, ref.tables,
                                                    ref.gbar)))


def centralvr_orders(random, key, n: int, epochs: int,
                     sampling: str = "permutation"):
    """The visit orders of ``repro.core.centralvr.run(..., key=key)``:
    (init permutation (n,), per-epoch orders (epochs, n))."""
    k_init, k_run = random.split(key)
    init = np.array(random.permutation(k_init, n))
    if sampling == "permutation":
        per = [random.permutation(k, n) for k in random.split(k_run, epochs)]
    else:
        per = [random.randint(k, (n,), 0, n)
               for k in random.split(k_run, epochs)]
    return init, np.stack([np.asarray(o) for o in per])


def sync_orders(random, key, p: int, ns: int, rounds: int):
    """The visit orders of ``repro.core.distributed.run_sync(..., key=key)``:
    (init permutations (p, ns), per-round permutations (rounds, p, ns))."""
    def perms(k):
        return np.stack([np.array(random.permutation(kw, ns))
                         for kw in random.split(k, p)])
    k_init, k_run = random.split(key)
    return perms(k_init), np.stack([perms(k)
                                    for k in random.split(k_run, rounds)])
