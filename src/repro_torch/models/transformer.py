"""Decoder stack, train path — the port of ``repro/models/transformer.py``
for ``attn`` blocks and Mamba2 ``ssm`` blocks (the other block kinds,
``local`` and ``rec``, and MoE FFNs are still to port, see ROADMAP.md).

The reference stacks the layers' params and scans over them; the port
keeps one params entry per layer in a list and loops. ``remat="block"``
(and ``"full"``) recompute each block in the backward pass through
``torch.utils.checkpoint``, as ``jax.checkpoint`` does around the
reference's scan body; ``remat="dots"`` saves the block's plain 2-D
matrix products and recomputes the rest, the reference's
``checkpoint_dots_with_no_batch_dims`` policy.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig
from repro_torch.models import attention, layers, ssm

REMAT = ("none", "block", "full", "dots")
KINDS = ("attn", "ssm")

# products without batch dimensions: a (B, S, d) @ (d, k) projection
# reaches autograd as one of these on flattened rows
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _check_kinds(cfg: ModelConfig):
    kinds = set(cfg.layer_kinds())
    if len(kinds) != 1 or not kinds <= set(KINDS) or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: only dense 'attn' blocks or 'ssm' blocks are ported "
            f"(this arch has {sorted(kinds)}{', MoE' if cfg.is_moe else ''});"
            " the other block kinds are ROADMAP.md queue 1, item 12")


def init_block(cfg: ModelConfig, kind: str, new) -> Dict[str, Any]:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md queue 1, "
            "item 12)")
    p = {"norm1": layers.init_norm(cfg, new)}
    if kind == "ssm":                   # ssm blocks have no separate MLP
        p["mixer"] = ssm.init_ssm(cfg, new)
        return p
    p["mixer"] = attention.init_attn(cfg, new)
    p["norm2"] = layers.init_norm(cfg, new)
    p["ffn"] = layers.init_mlp(cfg, new)
    return p


def init_stack(cfg: ModelConfig, new):
    """One params entry per layer, in layer order."""
    _check_kinds(cfg)
    return [init_block(cfg, kind, new) for kind in cfg.layer_kinds()]


def _cast_params(p, dtype):
    """Cast every float param to the compute dtype at point of use (params
    are stored in param_dtype, float32, for the optimizer) — the SSM's
    A_log, D and dt_bias too, as the reference casts every float leaf."""
    if isinstance(p, dict):
        return {k: _cast_params(v, dtype) for k, v in p.items()}
    return p.to(dtype) if p.is_floating_point() else p


def apply_block_train(p, cfg: ModelConfig, kind: str, x,
                      window: Optional[int] = None):
    p = _cast_params(p, getattr(torch, cfg.dtype))
    h = layers.apply_norm(p["norm1"], x, cfg.norm_type)
    if kind == "ssm":
        return x + ssm.apply_ssm_train(p["mixer"], cfg, h)
    x = x + attention.attend_train(p["mixer"], cfg, h, window=window)
    h = layers.apply_norm(p["norm2"], x, cfg.norm_type)
    return x + layers.apply_mlp(p["ffn"], h, cfg.mlp_type)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def apply_stack_train(layers_p, cfg: ModelConfig, x, *,
                      remat: str = "block", window: Optional[int] = None):
    """x: (B, S, d) -> x after every layer."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    _check_kinds(cfg)
    extra = {}
    if remat == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    for p, kind in zip(layers_p, cfg.layer_kinds()):
        if remat == "none":
            x = apply_block_train(p, cfg, kind, x, window)
        else:
            x = checkpoint(apply_block_train, p, cfg, kind, x, window,
                           use_reentrant=False, preserve_rng_state=False,
                           **extra)
    return x
