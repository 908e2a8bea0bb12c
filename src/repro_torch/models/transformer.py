"""Decoder stack — the port of ``repro/models/transformer.py``: every
block kind of the zoo (``attn``, ``local`` sliding-window attention,
Mamba2 ``ssm`` and the RG-LRU ``rec``), each non-ssm block with its FFN,
dense or MoE, for training, the lockstep decode and the serving
runtime's stack walk.

The reference stacks the layers' params per pattern position and scans
over super-blocks, with the remainder layers as an unrolled tail; the
port keeps one params entry per layer in a list, in ``cfg.layer_kinds()``
order (tail included), and loops. Decode and serve caches follow the
same layout: one entry per layer. ``remat="block"`` (and ``"full"``)
recompute each block in the backward pass through
``torch.utils.checkpoint``, as ``jax.checkpoint`` does around the
reference's scan body; ``remat="dots"`` saves the block's plain 2-D
matrix products and recomputes the rest, the reference's
``checkpoint_dots_with_no_batch_dims`` policy (the MoE experts' and the
RG-LRU gates' batched products are recomputed, as there).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig
from repro_torch.models import attention, layers, moe, rglru, ssm

REMAT = ("none", "block", "full", "dots")

# products without batch dimensions: a (B, S, d) @ (d, k) projection
# reaches autograd as one of these on flattened rows
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def init_block(cfg: ModelConfig, kind: str, new) -> Dict[str, Any]:
    p = {"norm1": layers.init_norm(cfg, new)}
    if kind in ("attn", "local"):
        p["mixer"] = attention.init_attn(cfg, new)
    elif kind == "ssm":
        p["mixer"] = ssm.init_ssm(cfg, new)
    elif kind == "rec":
        p["mixer"] = rglru.init_rglru(cfg, new)
    else:
        raise ValueError(kind)
    if kind != "ssm":                   # ssm blocks have no separate MLP
        p["norm2"] = layers.init_norm(cfg, new)
        p["ffn"] = (moe.init_moe(cfg, new) if cfg.is_moe
                    else layers.init_mlp(cfg, new))
    return p


def init_stack(cfg: ModelConfig, new):
    """One params entry per layer, in layer order."""
    return [init_block(cfg, kind, new) for kind in cfg.layer_kinds()]


def _cast_params(p, dtype, cfg: Optional[ModelConfig] = None,
                 kind: Optional[str] = None, _path: str = ""):
    """Cast every float param to the compute dtype at point of use (params
    are stored in param_dtype, float32, for the optimizer) — the SSM's
    A_log, D and dt_bias too, as the reference casts every float leaf —
    and, when the explicit weight-gather context is active, gather each
    FSDP-sharded leaf of a ``kind`` block to its FSDP-unsharded shape
    (``sharding/gather_ctx.py``)."""
    from repro_torch.sharding import gather_ctx

    if isinstance(p, dict):
        return {k: _cast_params(v, dtype, cfg, kind,
                                f"{_path}/{k}" if _path else k)
                for k, v in p.items()}
    if p.is_floating_point() and p.dtype != dtype:
        p = p.to(dtype)
    if gather_ctx.active() and kind is not None and p.is_floating_point():
        p = gather_ctx.constrain(_path, p,
                                 gather_ctx.block_shapes(cfg, kind)[_path])
    return p


def apply_block_train(p, cfg: ModelConfig, kind: str, x,
                      window: Optional[int] = None):
    """Returns (x, aux): aux is the MoE FFN's load-balance loss, else 0.
    On a mesh, the leaves are the rank's shards: FSDP ones are gathered
    here, and attention and the dense MLP run tensor-parallel where their
    leaves are split over 'model' (``sharding/tp.py``)."""
    from repro_torch.sharding import tp
    p = _cast_params(p, getattr(torch, cfg.dtype), cfg, kind)
    h = layers.apply_norm(p["norm1"], x, cfg.norm_type)
    if kind == "attn":
        mix = attention.attend_train(p["mixer"], cfg, h, window=window)
    elif kind == "local":
        mix = attention.attend_train(p["mixer"], cfg, h,
                                     window=cfg.local_window)
    elif kind == "ssm":
        mix = ssm.apply_ssm_train(p["mixer"], cfg, h)
    else:
        mix = rglru.apply_rec_train(p["mixer"], cfg, h)
    x = x + mix
    aux = 0.0
    if "ffn" in p:
        h = layers.apply_norm(p["norm2"], x, cfg.norm_type)
        if cfg.is_moe:
            # routed over the global batch, as the reference's (on a mesh
            # whose batch axes split the rows, ``sharding/tp.py``)
            y, aux = moe.apply_moe(p["ffn"], cfg, tp.gather_batch(h))
            y = tp.batch_rows(y, h.shape[0])
        else:
            y = layers.apply_mlp(p["ffn"], h, cfg.mlp_type,
                                 tp_split=_mlp_split(p["ffn"], cfg))
        x = x + y
    return x, aux


def _mlp_split(p, cfg: ModelConfig) -> bool:
    """Whether the dense MLP's hidden dim is split over 'model'."""
    from repro_torch.sharding import tp
    w = p["wg"] if "wg" in p else p["wi"]
    return tp.split(w.shape[1], cfg.d_ff)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def apply_stack_train(layers_p, cfg: ModelConfig, x, *,
                      remat: str = "block", window: Optional[int] = None):
    """x: (B, S, d) -> (x after every layer, the blocks' aux summed)."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    extra = {}
    if remat == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    aux = 0.0
    for p, kind in zip(layers_p, cfg.layer_kinds()):
        if remat == "none":
            x, a = apply_block_train(p, cfg, kind, x, window)
        else:
            x, a = checkpoint(apply_block_train, p, cfg, kind, x, window,
                              use_reentrant=False, preserve_rng_state=False,
                              **extra)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Decode and serving: one cache entry per layer
# ---------------------------------------------------------------------------

def layer_window(cfg: ModelConfig, kind: str):
    """The sliding window of a layer kind: cfg.local_window for 'local',
    cfg.sliding_window (None: full attention) for the others."""
    return cfg.local_window if kind == "local" else cfg.sliding_window


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, *, device=None):
    if kind == "attn":
        return attention.init_cache(cfg, batch, max_len, dtype,
                                    device=device)
    if kind == "local":
        return attention.init_cache(cfg, batch, max_len, dtype,
                                    window=cfg.local_window, device=device)
    if kind == "ssm":
        return ssm.init_ssm_cache(cfg, batch, dtype, device=device)
    return rglru.init_rec_cache(cfg, batch, dtype, device=device)


def apply_block_decode(p, cfg: ModelConfig, kind: str, x, cache, pos: int):
    """One block, one token for every row at position ``pos``: (x, cache),
    the cache written in place."""
    p = _cast_params(p, getattr(torch, cfg.dtype), cfg, kind)
    h = layers.apply_norm(p["norm1"], x, cfg.norm_type)
    if kind == "attn":
        mix, cache = attention.attend_decode(p["mixer"], cfg, h, cache, pos)
    elif kind == "local":
        mix, cache = attention.attend_decode(p["mixer"], cfg, h, cache, pos,
                                             window=cfg.local_window)
    elif kind == "ssm":
        mix, cache = ssm.apply_ssm_decode(p["mixer"], cfg, h, cache)
    else:
        mix, cache = rglru.apply_rec_decode(p["mixer"], cfg, h, cache)
    x = x + mix
    if "ffn" in p:
        h = layers.apply_norm(p["norm2"], x, cfg.norm_type)
        if cfg.is_moe:
            y, _ = moe.apply_moe(p["ffn"], cfg, h)
        else:
            y = layers.apply_mlp(p["ffn"], h, cfg.mlp_type)
        x = x + y
    return x, cache


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                     device=None):
    """The lockstep decode's caches, one per layer in layer order."""
    return [init_block_cache(cfg, kind, batch, max_len, dtype, device=device)
            for kind in cfg.layer_kinds()]


def apply_stack_serve(layers_p, cache, cfg: ModelConfig, x, block_fn):
    """The serving runtime's stack walk: ``block_fn(block_params,
    block_cache, kind, layer_window, x)`` returns ``(x, new_block_cache)``
    for each layer in turn; ``layer_window`` is the kind's sliding window
    (:func:`layer_window`). Returns (x, the per-layer caches)."""
    new = []
    for p, c, kind in zip(layers_p, cache, cfg.layer_kinds()):
        x, c = block_fn(p, c, kind, layer_window(cfg, kind), x)
        new.append(c)
    return x, new


def init_stack_serve_cache(cfg: ModelConfig, make_block_cache):
    """The serve cache, one entry per layer: ``make_block_cache(kind,
    layer_window)`` builds one layer's (paged pool / ring / dense lane
    buffer)."""
    return [make_block_cache(kind, layer_window(cfg, kind))
            for kind in cfg.layer_kinds()]


def apply_stack_decode(layers_p, cache, cfg: ModelConfig, x, pos: int):
    """x: (B, 1, d) -> (x, the per-layer caches, written in place)."""
    new = []
    for p, c, kind in zip(layers_p, cache, cfg.layer_kinds()):
        x, c = apply_block_decode(p, cfg, kind, x, c, pos)
        new.append(c)
    return x, new
