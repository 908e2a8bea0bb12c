"""Carry data, state and randomness from the JAX reference (``repro``)
into the port, so that both packages compute the same run.

The reference's arrays arrive as anything ``np.asarray`` takes (a JAX
array converts without this module importing jax): a ``Problem`` /
``ShardedProblem`` or a ``VRState`` / ``SyncState`` becomes the port's
counterpart on ``device``.

The reference's LM parameters (a tree of arrays, its layers stacked
along a leading axis for its scan) become the port's tree, one entry per
layer (:func:`lm_params_from_jax`), and its token blocks become int64
tensors (:func:`tokens_from_jax`).

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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def lm_params_from_jax(params_np, cfg):
    """The reference's LM params (``repro.models.model.init_params``'s
    tree, leaves as anything ``np.asarray`` takes) as the port's tree of
    CPU tensors: the scanned ``layers/stack`` (one dict per pattern
    position, each leaf with a leading super-block axis) is unstacked
    into one entry per layer, in layer order (super-block s, position j
    is layer s*len(pattern) + j), followed by the ``layers/tail``
    entries."""
    def tensor(a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":   # through float32, which holds it
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(a)

    stack, tail = params_np["layers"]["stack"], params_np["layers"]["tail"]
    n_super = (len(np.asarray(stack[0]["norm1"]["scale"]))
               if stack else 0)
    layers = [_tree_map(lambda a: tensor(np.asarray(a)[s]), stack[j])
              for s in range(n_super) for j in range(len(stack))]
    layers += [_tree_map(tensor, t) for t in tail]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: the reference params hold "
                         f"{len(layers)} layers, the config {cfg.num_layers}")
    return {"embed": _tree_map(tensor, params_np["embed"]),
            "layers": layers,
            "final_norm": _tree_map(tensor, params_np["final_norm"]),
            "head": _tree_map(tensor, params_np["head"])}


def tokens_from_jax(tokens) -> torch.Tensor:
    """A reference token block (e.g. ``synthetic.epoch_tokens``) as int64."""
    return torch.from_numpy(np.asarray(tokens).astype(np.int64))
