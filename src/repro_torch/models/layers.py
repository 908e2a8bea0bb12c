"""Shared layer primitives: norms, MLPs, rotary embeddings, embedding and
head — the port of ``repro/models/layers.py``.

Params are plain nested dicts of tensors, in the reference's layouts.
``init_*`` takes ``new(shape, init)``, a callable that returns the tensor
for one parameter (``init`` is ``"ones"``, ``"zeros"``, ``"log_arange"``
— log(1..n), the SSM's A_log — or ``("normal", std[, (axis, keep)])``,
normal with the entries from ``keep`` on along ``axis`` zeroed): the
caller decides whether that allocates, fills a view of a flat buffer, or
only records the shape (see ``models/model.py``). Creation order is the
layout order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import kernel_ctx


def dense(in_axis_size: int, keep=None):
    """The initializer of a dense weight: normal with std 1/sqrt(fan_in);
    ``keep=(axis, n)`` zeroes the entries from ``n`` on along ``axis``."""
    std = 1.0 / math.sqrt(in_axis_size)
    return ("normal", std) if keep is None else ("normal", std, keep)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, new):
    p = {"scale": new((cfg.d_model,), "ones")}
    if cfg.norm_type == "layernorm":
        p["bias"] = new((cfg.d_model,), "zeros")
    return p


def _rmsnorm_plain(x, scale, eps: float):
    from repro_torch.kernels.rmsnorm import ref
    return ref.rmsnorm_ref(x, scale, eps=eps)


class _RMSNormFused(torch.autograd.Function):
    """RMSNorm whose forward is the K2 kernel and whose backward
    differentiates the plain version from (x, scale) — the reference's
    ``_rmsnorm_fused`` custom_vjp: the kernel is forward-only."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        from repro_torch.kernels.rmsnorm import kernel
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return kernel.rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, ct):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            sd = scale.detach().requires_grad_()
            y = _rmsnorm_plain(xd, sd, ctx.eps)
            gx, gs = torch.autograd.grad(y, (xd, sd), ct)
        return gx, gs, None


def apply_norm(p, x, norm_type: str, eps: float = 1e-6):
    if norm_type == "layernorm":
        xf = x.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = (y * p["scale"].to(torch.float32)
             + p["bias"].to(torch.float32))
        return y.to(x.dtype)
    if kernel_ctx.active():
        return _RMSNormFused.apply(x, p["scale"], eps)
    return _rmsnorm_plain(x, p["scale"], eps)


def rms_norm_1d(scale, x, eps: float = 1e-6):
    """RMSNorm over the last axis with a free-standing scale (qk_norm)."""
    return _rmsnorm_plain(x, scale, eps)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, new, d_ff: int = 0):
    d, ff = cfg.d_model, (d_ff or cfg.d_ff)
    if cfg.mlp_type == "swiglu":
        return {"wg": new((d, ff), dense(d)), "wu": new((d, ff), dense(d)),
                "wd": new((ff, d), dense(ff))}
    p = {"wi": new((d, ff), dense(d)), "wo": new((ff, d), dense(ff))}
    if cfg.mlp_bias:
        p["bi"] = new((ff,), "zeros")
        p["bo"] = new((d,), "zeros")
    return p


def apply_mlp(p, x, mlp_type: str):
    if mlp_type == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
        return h @ p["wd"]
    h = x @ p["wi"]
    if "bi" in p:
        h = h + p["bi"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h, approximate="tanh")
    h = h @ p["wo"]
    if "bo" in p:
        h = h + p["bo"]
    return h


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Angles in
    float32; the result is cast back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, new):
    return {"tok": new((cfg.vocab_size, cfg.d_model), ("normal", 0.02))}


def embed_tokens(p, tokens):
    return p["tok"][tokens.to(torch.int64)]


def init_lm_head(cfg: ModelConfig, new):
    if cfg.tie_embeddings:
        return {}
    return {"w": new((cfg.d_model, cfg.vocab_size), dense(cfg.d_model))}


def _matmul(a, b):
    """a @ b with JAX's type promotion (bf16 @ f32 runs in f32)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


def lm_logits(head_p, embed_p, x, tie: bool):
    if tie:
        return x @ embed_p["tok"].T.to(x.dtype)
    return _matmul(x, head_p["w"])
