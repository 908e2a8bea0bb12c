"""Placement rules for the zoo's parameter trees — the port of
``repro/sharding/specs.py``, as plain functions on path strings and
shapes.

A spec is a tuple with one entry per dimension: an axis name, a tuple of
axis names, or None (replicated), as the entries of a
``jax.sharding.PartitionSpec``. PyTorch has no PartitionSpec; the process
mesh (``launch/mesh.py``) and the sharded train step
(``train/step.py``) read these tuples.

Two parameter-placement modes, mirroring the paper-vs-beyond split:

  * ``dp_replicated=True`` (paper-faithful CentralVR): every worker holds a
    full model copy — params are replicated along the data/pod axes and
    tensor-parallel along 'model'.
  * ``dp_replicated=False``: additionally FSDP-shard the params' largest
    non-TP dim along 'data' (ZeRO-3); CentralVR workers then live on the
    'pod' axis.

Rules are path-pattern based: the port's one-entry-per-layer paths
(``layers/<i>/mixer/wq``) carry the reference's substrings, so a layer
leaf gets the reference's rule for its stacked leaf without the leading
stack axis. An axis that does not divide its dim is dropped
(``_fix_divisibility``). The SSM/RG-LRU mixers keep their head-structured
inner dims replicated over 'model'.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.config import ModelConfig


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _param_rule(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
                fsdp: Optional[str], axis_sizes: Optional[dict] = None):
    """The spec of one unstacked param leaf.

    Head-count-aware: tensor parallelism on attention uses the HEAD axis
    only when the padded head count divides the 'model' axis; otherwise
    attention is replicated over 'model' (FSDP over 'data' stays)."""
    tp = "model"
    tp_n = (axis_sizes or {}).get("model", 1)
    heads_ok = cfg.padded_heads % tp_n == 0

    def dims(*ds):
        return tuple(ds)

    if "embed/tok" in path:
        return dims(tp, fsdp)
    if "head/w" in path:
        return dims(fsdp, tp)
    if "frontend_proj" in path:
        return dims(fsdp, tp)

    # --- attention ---
    if "mixer/wq" in path:
        return dims(fsdp, tp if heads_ok else None, None)
    if "mixer/wk" in path or "mixer/wv" in path:
        # kv heads replicated over 'model' (kv_dim is small)
        return dims(fsdp, None, None)
    if "mixer/wo" in path:
        return dims(tp if heads_ok else None, None, fsdp)
    if "mixer/bq" in path:
        return dims(tp if heads_ok else None, None)
    if "mixer/bk" in path or "mixer/bv" in path:
        return dims(None, None)
    if "q_norm" in path or "k_norm" in path:
        return dims(None)

    # --- MoE --- (the cfg.is_moe guard keeps a dense arch's 3-D stacked
    # MLP weight off the expert rule)
    if "ffn/router" in path:
        return dims(None, tp)
    if cfg.is_moe and ("ffn/wg" in path or "ffn/wu" in path
                       or "ffn/wd" in path) and shape and len(shape) == 3:
        return dims(tp, fsdp, None)      # expert-parallel
    if "shared/wg" in path or "shared/wu" in path:
        return dims(fsdp, tp)
    if "shared/wd" in path:
        return dims(tp, fsdp)
    if "shared_gate" in path:
        return dims(None, None)

    # --- dense MLP ---
    if "ffn/wg" in path or "ffn/wu" in path or "ffn/wi" in path:
        return dims(fsdp, tp)
    if "ffn/wd" in path or "ffn/wo" in path:
        return dims(tp, fsdp)
    if "ffn/bi" in path:
        return dims(tp)
    if "ffn/bo" in path:
        return dims(None)

    # --- SSM (mamba2): inner dims head-structured; TP not applied ---
    if "mixer/in_proj" in path or "mixer/out_proj" in path:
        return dims(fsdp, None)
    if "mixer/conv_w" in path:
        return dims(None, None)

    # --- RG-LRU ---
    if "mixer/wx_in" in path or "mixer/wy_in" in path:
        return dims(fsdp, None)
    if "mixer/out" in path:
        return dims(None, fsdp)
    if "mixer/wa" in path or "mixer/wi" in path:
        return dims(None, None, None)

    # norms, scalars, small vectors: replicated
    return tuple(None for _ in shape)


def _axis_size(axis, sizes: dict) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(axis, 1)


def _fix_divisibility(spec, shape, sizes: dict):
    """Drop (replicate) every axis that does not divide its dim."""
    spec = list(spec)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        if shape[i] % _axis_size(ax, sizes) != 0:
            spec[i] = None
    return tuple(spec)


def leaf_spec(path: str, shape, cfg: ModelConfig, *, fsdp_axis=None,
              worker=None, axis_sizes: Optional[dict] = None):
    """The spec of one leaf of shape ``shape``: the structural rule of its
    trailing dims (probing progressively shorter trailing shapes until
    the rule's length fits), extra leading dims padded with None, the
    first of them given ``worker`` (the worker axes)."""
    shape = tuple(shape)
    for n in range(len(shape) + 1):
        base = _param_rule(path, shape[n:], cfg, fsdp_axis, axis_sizes)
        if len(base) == len(shape) - n:
            break
    else:                                   # scalar / unknown: replicate
        return tuple(None for _ in shape)
    if axis_sizes:
        base = _fix_divisibility(base, shape[n:], axis_sizes)
    lead = [None] * n
    if worker is not None and n > 0:
        lead[0] = worker
    return (*lead, *base)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and named
    tuples (a named tuple's fields by name); a leaf is anything else with
    a ``shape`` (a tensor, a meta tensor, a shape-and-dtype record).
    None and empty containers have no leaves and map to themselves."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def tree_specs(tree, cfg: ModelConfig, *, fsdp: bool,
               worker_axes: Tuple[str, ...] = (),
               axis_sizes: Optional[dict] = None):
    """The spec tree for ANY state tree whose leaves are params or
    param-shaped buffers (optimizer moments, VR tables, anchors,
    snapshots). The substring rules give the spec of the trailing param
    dims; extra leading dims (worker-copy axis, stack axis, VR table axis)
    are padded, the first leading dim of a multi-copy state taking the
    worker axes. With ``axis_sizes`` the specs are made divisible."""
    fsdp_axis = "data" if fsdp else None
    w = None
    if worker_axes:
        w = worker_axes if len(worker_axes) > 1 else worker_axes[0]
    return _map_with_path(
        lambda path, leaf: leaf_spec(_path_str(path), leaf.shape, cfg,
                                     fsdp_axis=fsdp_axis, worker=w,
                                     axis_sizes=axis_sizes), tree)


def param_specs(params, cfg: ModelConfig, *, fsdp: bool,
                worker_axes: Tuple[str, ...] = ()):
    return tree_specs(params, cfg, fsdp=fsdp, worker_axes=worker_axes)


def cache_specs(cache, cfg: ModelConfig):
    """KV/state caches: batch dim over 'data', everything else
    replicated; a stacked axis (a path through ``stack``) leading."""

    def spec_for(path, leaf):
        ps = _path_str(path)
        n_lead = 1 if "stack" in ps else 0
        shape = tuple(leaf.shape)[n_lead:]
        return (*([None] * n_lead), "data", *([None] * (len(shape) - 1)))

    return _map_with_path(spec_for, cache)


def batch_specs(worker_axes: Tuple[str, ...], data_axes: Tuple[str, ...]):
    """tokens: (W, A, mb, S) when a worker axis is present, else
    (A, mb, S)."""
    w = (worker_axes if len(worker_axes) > 1 else worker_axes[0]) \
        if worker_axes else None
    d = (data_axes if len(data_axes) > 1 else data_axes[0]) \
        if data_axes else None
    if worker_axes:
        return (w, None, d, None)
    return (None, d, None)
