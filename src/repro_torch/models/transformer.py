"""Decoder stack, train path — the port of ``repro/models/transformer.py``:
every block kind of the zoo (``attn``, ``local`` sliding-window attention,
Mamba2 ``ssm`` and the RG-LRU ``rec``), each non-ssm block with its FFN,
dense or MoE.

The reference stacks the layers' params per pattern position and scans
over super-blocks, with the remainder layers as an unrolled tail; the
port keeps one params entry per layer in a list, in ``cfg.layer_kinds()``
order (tail included), and loops. ``remat="block"`` (and ``"full"``)
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


def _cast_params(p, dtype):
    """Cast every float param to the compute dtype at point of use (params
    are stored in param_dtype, float32, for the optimizer) — the SSM's
    A_log, D and dt_bias too, as the reference casts every float leaf."""
    if isinstance(p, dict):
        return {k: _cast_params(v, dtype) for k, v in p.items()}
    return p.to(dtype) if p.is_floating_point() else p


def apply_block_train(p, cfg: ModelConfig, kind: str, x,
                      window: Optional[int] = None):
    """Returns (x, aux): aux is the MoE FFN's load-balance loss, else 0."""
    p = _cast_params(p, getattr(torch, cfg.dtype))
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
            y, aux = moe.apply_moe(p["ffn"], cfg, h)
        else:
            y = layers.apply_mlp(p["ffn"], h, cfg.mlp_type)
        x = x + y
    return x, aux


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
