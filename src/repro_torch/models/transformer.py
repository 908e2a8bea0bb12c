"""Decoder stack, train path — the port of ``repro/models/transformer.py``
for ``attn`` blocks (the other block kinds, ``local`` / ``ssm`` / ``rec``,
and MoE FFNs are still to port, see ROADMAP.md).

The reference stacks the layers' params and scans over them; the port
keeps one params entry per layer in a list and loops. ``remat="block"``
(and ``"full"``) recompute each block in the backward pass through
``torch.utils.checkpoint``, as ``jax.checkpoint`` does around the
reference's scan body.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import attention, layers

REMAT = ("none", "block", "full")


def _check_kinds(cfg: ModelConfig):
    kinds = set(cfg.layer_kinds())
    if kinds != {"attn"} or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: only dense 'attn' blocks are ported (this arch has "
            f"{sorted(kinds)}{', MoE' if cfg.is_moe else ''}); the other "
            "block kinds are ROADMAP.md queue 1, item 12")


def init_block(cfg: ModelConfig, kind: str, new) -> Dict[str, Any]:
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md queue 1, "
            "item 12)")
    return {"norm1": layers.init_norm(cfg, new),
            "mixer": attention.init_attn(cfg, new),
            "norm2": layers.init_norm(cfg, new),
            "ffn": layers.init_mlp(cfg, new)}


def init_stack(cfg: ModelConfig, new):
    """One params entry per layer, in layer order."""
    _check_kinds(cfg)
    return [init_block(cfg, kind, new) for kind in cfg.layer_kinds()]


def _cast_params(p, dtype):
    """Cast float params to the compute dtype at point of use (params are
    stored in param_dtype, float32, for the optimizer)."""
    if isinstance(p, dict):
        return {k: _cast_params(v, dtype) for k, v in p.items()}
    return p.to(dtype) if p.is_floating_point() else p


def apply_block_train(p, cfg: ModelConfig, x,
                      window: Optional[int] = None):
    p = _cast_params(p, getattr(torch, cfg.dtype))
    h = layers.apply_norm(p["norm1"], x, cfg.norm_type)
    x = x + attention.attend_train(p["mixer"], cfg, h, window=window)
    h = layers.apply_norm(p["norm2"], x, cfg.norm_type)
    return x + layers.apply_mlp(p["ffn"], h, cfg.mlp_type)


def apply_stack_train(layers_p, cfg: ModelConfig, x, *,
                      remat: str = "block", window: Optional[int] = None):
    """x: (B, S, d) -> x after every layer."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    _check_kinds(cfg)
    for p in layers_p:
        if remat == "none":
            x = apply_block_train(p, cfg, x, window)
        else:
            x = checkpoint(apply_block_train, p, cfg, x, window,
                           use_reentrant=False, preserve_rng_state=False)
    return x
