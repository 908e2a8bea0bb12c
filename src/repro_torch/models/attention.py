"""GQA attention for the train path — the port of the train half of
``repro/models/attention.py`` (decode and serving are still to port, see
ROADMAP.md).

The chunked online-softmax form and the naive form live beside the
flash kernel's plain version in ``kernels/flash_attention/ref.py`` and are
re-exported here. Under ``kernel_ctx`` the score / softmax / weighted-sum
pipeline runs as the K3 flash kernel, one launch per layer per forward,
with the chunked form's autograd as its backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF, chunked_attention, naive_attention)
from repro_torch.models import kernel_ctx, layers


def init_attn(cfg: ModelConfig, new):
    """wq (d, H, hd), wk / wv (d, KV, hd), wo (H, hd, d), biases (H, hd) /
    (KV, hd), as the reference lays them out (H = ``cfg.padded_heads``)."""
    d, KV, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    H = cfg.padded_heads        # physical heads (>= logical num_heads)
    # the padded heads' columns of wq and rows of wo start at zero, as the
    # reference zeroes them; ``_head_mask`` keeps them inert: their
    # outputs never reach wo, and no gradient flows into them
    n = cfg.num_heads
    p = {
        "wq": new((d, H, hd), layers.dense(d, keep=(1, n))),
        "wk": new((d, KV, hd), layers.dense(d)),
        "wv": new((d, KV, hd), layers.dense(d)),
        "wo": new((H, hd, d), layers.dense(H * hd, keep=(0, n))),
    }
    if cfg.qkv_bias:
        p["bq"] = new((H, hd), "zeros")
        p["bk"] = new((KV, hd), "zeros")
        p["bv"] = new((KV, hd), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = new((hd,), "ones")
        p["k_norm"] = new((hd,), "ones")
    return p


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _project_qkv(p, cfg: ModelConfig, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = layers.rms_norm_1d(p["q_norm"], q)
        k = layers.rms_norm_1d(p["k_norm"], k)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _head_mask(cfg: ModelConfig, out):
    """Zero the padded heads' outputs (none unless ``pad_heads_to`` is
    set), so they are exactly inert."""
    H = cfg.padded_heads
    if H == cfg.num_heads:
        return out
    mask = (torch.arange(H, device=out.device) < cfg.num_heads).to(out.dtype)
    return out * mask[..., :, None]


class _FlashFused(torch.autograd.Function):
    """Flash attention whose forward is the K3 kernel and whose backward
    recomputes through ``chunked_attention`` — the reference's
    ``_flash_fused`` custom_vjp: the kernel is forward-only."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        from repro_torch.kernels.flash_attention import kernel
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return kernel.flash_attention(q, k, v, window=window)

    @staticmethod
    def backward(ctx, ct):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = chunked_attention(*qkv, window=ctx.window)
            grads = torch.autograd.grad(out, qkv, ct)
        return (*grads, None)


def attend_train(p, cfg: ModelConfig, x, *, window: Optional[int] = None):
    """Full block for train/prefill: project, attention, out-projection.

    Under ``kernel_ctx`` the attention runs as the K3 kernel (one launch
    per layer), except for softcapped archs, which the kernel does not
    implement."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    w = window if window is not None else cfg.sliding_window
    if kernel_ctx.active() and cfg.attn_logit_softcap is None:
        out = _FlashFused.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), w)
    else:
        out = chunked_attention(q, k, v, window=w,
                                softcap=cfg.attn_logit_softcap)
    out = _head_mask(cfg, out)
    H, hd = out.shape[2], out.shape[3]
    # einsum("bshk,hkd->bsd") as one matmul
    return out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, -1)
