"""Carry data, state and randomness from the JAX reference (``repro``)
into the port, so that both packages compute the same run.

The reference's arrays arrive as anything ``np.asarray`` takes (a JAX
array converts without this module importing jax): a ``Problem`` /
``ShardedProblem`` or a ``VRState`` / ``SyncState`` / ``AsyncState`` /
``DSagaState`` becomes the port's counterpart on ``device``.

The reference's LM parameters (a tree of arrays, its layers stacked
along a leading axis for its scan) become the port's tree, one entry per
layer (:func:`lm_params_from_jax`), its decode and serve caches the
port's per-layer lists (:func:`decode_cache_from_jax`,
:func:`serve_cache_from_jax`), and its token blocks become int64 tensors
(:func:`tokens_from_jax`). On a process mesh, :func:`shard_params` gives
one mesh position's local flat buffer of the reference's params, and
:func:`gather_flat` puts every position's buffers back together.

The reference draws its visit orders and sample indices inside its
drivers with ``jax.random``; one function per driver here
(:func:`centralvr_orders`, :func:`sync_orders`, :func:`async_orders`, ...)
replays its key splits and returns the draws as numpy arrays, in the
``orders`` layout of ``repro_torch.solve``. They take the caller's
``jax.random`` module as an argument, because this package never imports
jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.centralvr import VRState
from repro_torch.core.convex import Problem
from repro_torch.core.distributed import (AsyncState, DSagaState,
                                          ShardedProblem, SyncState)


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


def to_async_state(ref, *, device) -> AsyncState:
    """A reference ``AsyncState`` (Algorithm 3, stale-fetch D-SAGA)."""
    return AsyncState(*(_tensor(t, device) for t in ref))


def to_dsaga_state(ref, *, device) -> DSagaState:
    """A reference ``DSagaState`` (instant-fetch D-SAGA)."""
    return DSagaState(*(_tensor(t, device) for t in ref))


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
    k_init, k_run = random.split(key)
    return _perms(random, k_init, p, ns), np.stack(
        [_perms(random, k, p, ns) for k in random.split(k_run, rounds)])


def _perms(random, key, p: int, ns: int):
    """One permutation of range(ns) per key of ``split(key, p)``, (p, ns)
    (the reference's ``sync_init`` and ``sync_round``)."""
    return np.stack([np.array(random.permutation(k, ns))
                     for k in random.split(key, p)])


def _randint_per_key(random, key, count: int, shape, high: int):
    """``randint(k, shape, 0, high)`` for each key of ``split(key, count)``,
    stacked: (count, *shape)."""
    return np.stack([np.array(random.randint(k, shape, 0, high))
                     for k in random.split(key, count)])


def _anchors(random, key, count: int, high: int, snapshot: str):
    """The SVRG anchor indices of ``snapshot="rand"``, drawn off
    ``fold_in(key, 1)`` so the main stream is unaffected; None else."""
    if snapshot != "rand":
        return None
    return np.array(random.randint(random.fold_in(key, 1), (count,), 0,
                                   high))


def sgd_orders(random, key, n: int, epochs: int):
    """The per-epoch permutations (epochs, n) of
    ``repro.core.baselines.run_sgd(..., key=key)``."""
    return np.stack([np.array(random.permutation(k, n))
                     for k in random.split(key, epochs)])


def svrg_orders(random, key, n: int, epochs: int, inner: int = 0,
                snapshot: str = "last"):
    """The draws of ``repro.core.baselines.run_svrg(..., key=key)``:
    (sample indices (epochs, inner), anchor indices (epochs,) or None);
    ``inner`` 0 means n."""
    inner = inner or n
    return (_randint_per_key(random, key, epochs, (inner,), n),
            _anchors(random, key, epochs, inner, snapshot))


def saga_orders(random, key, n: int, epochs: int):
    """The sample indices (epochs, n) of
    ``repro.core.baselines.run_saga(..., key=key)``."""
    return _randint_per_key(random, key, epochs, (n,), n)


def async_orders(random, key, p: int, ns: int, rounds: int):
    """The draws of ``repro.core.distributed.run_async(..., key=key)``:
    (init permutations (p, ns), per-event permutations (rounds * p, ns)
    in schedule order, whatever the speeds)."""
    k_init, k_run = random.split(key)
    return _perms(random, k_init, p, ns), _perms(random, k_run, rounds * p,
                                                 ns)


def elastic_orders(random, key, p: int, ns: int, rounds: int,
                   membership=None):
    """The draws of ``repro.core.elastic.run_async_elastic(..., key=key,
    membership=membership)``, in the ``orders`` layout of the port's
    ``run_async_elastic``: (init permutations (p, ns), ``{start round:
    per-event permutations ((rounds - start) * p_seg, n // p_seg)}``), one
    entry per shape segment. ``membership`` is either package's
    ``PlannedMembership`` or a ``{round: live ids}`` plan (None: the full
    fleet throughout). Segment 0 draws from ``split(key)[1]`` itself, the
    segment that begins at round r at width p from
    ``fold_in(fold_in(k_run, r), p)`` (the reference's ``segment_plan``),
    one permutation per key of its split, as ``_perm_rows`` draws them."""
    from repro_torch.core.elastic import PlannedMembership
    if membership is None or isinstance(membership, dict):
        membership = PlannedMembership(p, membership)
    k_init, k_run = random.split(key)
    n, live = p * ns, membership.live(0)
    starts = {0: len(live)}
    for r in membership.change_rounds():
        if 0 < r < rounds and membership.live(r) != live:
            live = membership.live(r)
            starts[r] = len(live)
    segments = {}
    for start, p_seg in starts.items():
        k_seg = (k_run if start == 0 else
                 random.fold_in(random.fold_in(k_run, start), p_seg))
        segments[start] = _perms(random, k_seg, (rounds - start) * p_seg,
                                 n // p_seg)
    return _perms(random, k_init, p, ns), segments


def dsvrg_orders(random, key, p: int, ns: int, rounds: int, tau: int = 0,
                 snapshot: str = "last"):
    """The draws of ``repro.core.distributed.run_dsvrg(..., key=key)``:
    (sample indices (rounds, p, tau), anchor indices (rounds,) or None);
    ``tau`` 0 means 2*ns."""
    tau = tau or 2 * ns
    idx = np.stack([_randint_per_key(random, k, p, (tau,), ns)
                    for k in random.split(key, rounds)])
    return idx, _anchors(random, key, rounds, tau, snapshot)


def dsaga_orders(random, key, p: int, ns: int, rounds: int,
                 tau: int = 100):
    """The per-event sample indices (rounds * p, tau), in schedule order,
    of ``repro.core.distributed.run_dsaga(..., key=key)``."""
    return _randint_per_key(random, key, rounds * p, (tau,), ns)


def dist_sgd_orders(random, key, p: int, ns: int, rounds: int,
                    tau: int = 0):
    """The sample indices (rounds, p, tau) of
    ``repro.core.baselines.run_dist_sgd(..., key=key)``; ``tau`` 0 means
    ns."""
    tau = tau or ns
    return np.stack([_randint_per_key(random, k, p, (tau,), ns)
                     for k in random.split(key, rounds)])


def easgd_orders(random, key, p: int, ns: int, rounds: int, tau: int = 16):
    """The sample indices (rounds, p, max(ns // tau, 1), tau) of
    ``repro.core.baselines.run_easgd(..., key=key)``."""
    spr = max(ns // tau, 1)
    return np.stack([_randint_per_key(random, k, p, (spr * tau,), ns)
                     for k in random.split(key, rounds)]).reshape(
        rounds, p, spr, tau)


def ps_svrg_orders(random, key, p: int, ns: int, rounds: int,
                   epoch_mult: int = 2):
    """The sample indices (rounds, epoch_mult * ns, p) of
    ``repro.core.baselines.run_ps_svrg(..., key=key)``."""
    return np.stack([_randint_per_key(random, k, epoch_mult * ns, (p,), ns)
                     for k in random.split(key, rounds)])


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
    entries; every leaf of a block (MoE and RG-LRU ones too) and the
    frontend stub's ``frontend_proj`` are carried as they are."""
    stack, tail = params_np["layers"]["stack"], params_np["layers"]["tail"]
    n_super = (len(np.asarray(stack[0]["norm1"]["scale"]))
               if stack else 0)
    layers = [_tree_map(lambda a: _tensor_of(np.asarray(a)[s]), stack[j])
              for s in range(n_super) for j in range(len(stack))]
    layers += [_tree_map(_tensor_of, t) for t in tail]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: the reference params hold "
                         f"{len(layers)} layers, the config {cfg.num_layers}")
    out = {"embed": _tree_map(_tensor_of, params_np["embed"]),
           "layers": layers,
           "final_norm": _tree_map(_tensor_of, params_np["final_norm"]),
           "head": _tree_map(_tensor_of, params_np["head"])}
    if "frontend_proj" in params_np:
        out["frontend_proj"] = _tensor_of(params_np["frontend_proj"])
    return out


def _sharded_layout(cfg, mesh_sizes, coords, fsdp):
    from repro_torch.train.step import ShardedLayout
    names, shape = tuple(mesh_sizes), tuple(mesh_sizes.values())
    if isinstance(coords, dict):
        coords = tuple(coords[a] for a in names)
    return ShardedLayout(cfg, names, shape, coords, fsdp=fsdp)


def shard_params(params_np, cfg, mesh_sizes: dict, coords, *,
                 fsdp: bool = True) -> torch.Tensor:
    """The reference's full LM params as the local flat buffer (N_local,)
    of the mesh position ``coords`` (a tuple in the order of
    ``mesh_sizes`` — ``{axis: size}`` in mesh order — or a dict by axis):
    each leaf's shard under ``sharding/specs.py`` (FSDP over 'data' when
    ``fsdp``), in ``train.step.ShardedLayout`` order, on the CPU."""
    lay = _sharded_layout(cfg, mesh_sizes, coords, fsdp)
    flat = torch.empty(lay.n, dtype=getattr(torch, cfg.param_dtype))
    return lay.load_(flat, lm_params_from_jax(params_np, cfg))


def shard_tree(params_np, cfg, mesh_sizes: dict, coords, *,
               fsdp: bool = False):
    """The reference's full LM params as the params tree of the mesh
    position ``coords`` (as in :func:`shard_params`): each leaf's shard
    under ``sharding/specs.py`` (``tree_specs``; FSDP over 'data' when
    ``fsdp``), as CPU tensors — the tree-form sibling of
    :func:`shard_params`, the params a tensor-parallel serving rank
    holds."""
    lay = _sharded_layout(cfg, mesh_sizes, coords, fsdp)
    return lay.shard_tree(lm_params_from_jax(params_np, cfg))


def gather_flat(flats, cfg, mesh_sizes: dict, *,
                fsdp: bool = True) -> torch.Tensor:
    """The inverse of :func:`shard_params`: every mesh position's local
    flat buffer, in rank order (row-major over ``mesh_sizes``), put
    together into the full flat buffer (N,) of ``models.model.ParamLayout``
    (whose ``views`` give the params tree)."""
    from repro_torch.launch.mesh import unravel
    shape = tuple(mesh_sizes.values())
    lay = _sharded_layout(cfg, mesh_sizes, (0,) * len(shape), fsdp)
    full = torch.zeros(lay.full.n, dtype=flats[0].dtype)
    for q, local in enumerate(flats):
        lay.scatter_into(full, torch.as_tensor(local).reshape(-1),
                         unravel(q, shape))
    return full


def _tensor_of(a):
    """A reference array as a CPU tensor; bfloat16 through float32, which
    holds it exactly."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _unstack_layers(cache_np, cfg, one):
    """The reference's ``{"stack": [per pattern position, leading
    super-block axis], "tail": [...]}`` as one entry per layer, in layer
    order; ``one(entry, kind, s)`` converts super-block ``s`` of a stacked
    entry (``s`` None: a tail entry)."""
    stack, tail = cache_np["stack"], cache_np["tail"]
    kinds = cfg.layer_kinds()

    def lead(entry):
        return np.shape(entry["k"] if isinstance(entry, dict) else entry[0])[0]
    n_super = lead(stack[0]) if stack else 0
    out = [one(stack[j], kinds[s * len(stack) + j], s)
           for s in range(n_super) for j in range(len(stack))]
    out += [one(t, kinds[len(out) + i], None) for i, t in enumerate(tail)]
    if len(out) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: the reference cache holds {len(out)} "
                         f"layers, the config {cfg.num_layers}")
    return out


def decode_cache_from_jax(cache_np, cfg):
    """The reference's lockstep decode cache (``repro.models.model.
    init_cache``'s tree: attention dicts of k / v, ``SSMCache`` and
    ``RecCache`` tuples of conv / h) as the port's list, one entry per
    layer, of CPU tensors: dicts for attention layers, the port's
    ``SSMCache`` / ``RecCache`` for ssm / rec layers."""
    from repro_torch.models import rglru, ssm

    def one(entry, kind, s):
        def pick(a):
            return _tensor_of(np.asarray(a) if s is None else np.asarray(a)[s])
        if kind in ("attn", "local"):
            return {k: pick(entry[k]) for k in ("k", "v")}
        cls = ssm.SSMCache if kind == "ssm" else rglru.RecCache
        return cls(conv=pick(entry[0]), h=pick(entry[1]))
    return _unstack_layers(cache_np, cfg, one)


def serve_cache_from_jax(cache_np, cfg):
    """The reference's serve cache (``repro.serve.runtime.init_cache``'s
    tree of k / v pools, lane buffers or rings) as the port's list, one
    ``{"k", "v"}`` dict of CPU tensors per layer."""
    def one(entry, kind, s):
        return {k: _tensor_of(np.asarray(entry[k]) if s is None
                              else np.asarray(entry[k])[s])
                for k in ("k", "v")}
    return _unstack_layers(cache_np, cfg, one)


def tokens_from_jax(tokens) -> torch.Tensor:
    """A reference token block (e.g. ``synthetic.epoch_tokens``) as int64."""
    return torch.from_numpy(np.asarray(tokens).astype(np.int64))
