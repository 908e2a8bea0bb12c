"""Explicit per-layer weight gather (ZeRO-3) — the port of
``repro/sharding/gather_ctx.py``.

Under FSDP every rank holds its 'data' shard of each leaf
(``sharding/specs.py``). When a block casts its weights to the compute
dtype (``models/transformer.py:_cast_params``), each FSDP-sharded leaf
is gathered to its FSDP-unsharded shape: one all-gather over 'data' of
the compute-dtype (bf16) copy per weight per layer execution, and in the
backward one reduce-scatter of its gradient back to the shard
(:func:`constrain`, an autograd function). The gather runs inside the
``remat="block"`` checkpoint region, so the backward's recompute gathers
again instead of keeping the whole weight — the reference's memory
behaviour, where GSPMD emits the same collectives. The embedding, the
head and the frontend projection are gathered the same way where the
model uses them (``models/model.py``).

The context is process-global, as the reference's; the sharded train
step (``train/step.py``) enables it around each step's forward and
backward (:func:`scope`), so it never leaks into another runtime.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

_CTX: dict = {"mesh": None, "cfg": None, "sizes": None}


def enable(mesh, cfg, sizes: dict) -> None:
    _CTX.update(mesh=mesh, cfg=cfg, sizes=sizes)


def disable() -> None:
    _CTX.update(mesh=None, cfg=None, sizes=None)


def active() -> bool:
    return _CTX["mesh"] is not None


@contextlib.contextmanager
def scope(mesh, cfg, sizes: dict):
    """The context enabled for the body, and the previous one restored."""
    prev = dict(_CTX)
    enable(mesh, cfg, sizes)
    try:
        yield
    finally:
        _CTX.update(prev)


def gather_spec(path_str: str, shape) -> Optional[tuple]:
    """The use-time (FSDP-removed) spec of a leaf of full shape
    ``shape``, or None if the leaf isn't FSDP-sharded (no gather)."""
    if not active():
        return None
    from repro_torch.sharding import specs
    cfg, sizes = _CTX["cfg"], _CTX["sizes"]
    shape = tuple(shape)
    with_f = specs._param_rule(path_str, shape, cfg, "data", sizes)
    no_f = specs._param_rule(path_str, shape, cfg, None, sizes)
    if len(with_f) != len(shape) or with_f == no_f:
        return None
    return specs._fix_divisibility(no_f, shape, sizes)


def _fsdp_dim(path_str: str, shape) -> Optional[int]:
    """The dim of a leaf of full shape ``shape`` that its stored spec
    shards over 'data' (the FSDP rule, axes that do not divide dropped),
    or None."""
    from repro_torch.sharding import specs
    shape = tuple(shape)
    stored = specs._fix_divisibility(
        specs._param_rule(path_str, shape, _CTX["cfg"], "data",
                          _CTX["sizes"]), shape, _CTX["sizes"])
    if len(stored) != len(shape):
        return None
    return next((i for i, a in enumerate(stored) if a == "data"), None)


class _Gather(torch.autograd.Function):
    """All-gather over 'data' along ``dim``; backward: reduce-scatter of
    the gradient back to this rank's shard."""

    @staticmethod
    def forward(ctx, w, dim, group):
        from repro_torch.core import spmd
        ctx.dim, ctx.group = dim, group
        return spmd.all_gather_dim(w, group, dim)

    @staticmethod
    def backward(ctx, ct):
        from repro_torch.core import spmd
        return (spmd.reduce_scatter_dim(ct.contiguous(), ctx.group, ctx.dim),
                None, None)


def constrain(path_str: str, w, shape=None):
    """``w`` (this rank's shard of a leaf whose full shape is ``shape``)
    gathered to its FSDP-unsharded shape; ``w`` itself when the context
    is off or the leaf is not FSDP-sharded."""
    if not active():
        return w
    dim = _fsdp_dim(path_str, tuple(w.shape) if shape is None else shape)
    if dim is None:
        return w
    group = _CTX["mesh"].group("data")
    if group.world == 1:
        return w
    return _Gather.apply(w, dim, group)


@functools.lru_cache(maxsize=None)
def block_shapes(cfg, kind: str) -> dict:
    """The full shapes of one block's leaves, by block-relative path
    (``mixer/wq``, ...)."""
    from repro_torch.models import transformer
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                out[path] = v
    walk(transformer.init_block(cfg, kind, lambda shape, init: tuple(shape)),
         "")
    return out
