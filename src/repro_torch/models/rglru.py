"""RG-LRU recurrent block (RecurrentGemma / Griffin [arXiv:2402.19427])
— the port of ``repro/models/rglru.py``: the prefix scan for train and
prefill, and for decode the O(1) step ``rglru_step`` over a ``RecCache``
(the last CONV_K - 1 conv inputs and the float32 state).

    r_t = sigmoid(W_a x_t)          recurrence gate (block-diagonal, per head)
    i_t = sigmoid(W_x x_t)          input gate
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference scans over time with ``jax.lax.associative_scan``; the port
runs the same linear recurrence as a Hillis-Steele prefix scan in plain
PyTorch, log2(S) passes over (B, S, dr), for any S. It combines in
another order than ``associative_scan``, so the two differ by rounding.
It scans (a, h) pairs, never cumulative sums of log a: exp(-sum log a)
overflows float32 within a few hundred steps.

The block is Griffin's: two d -> dr branches, branch one a causal
depthwise conv (width 4) then the RG-LRU, branch two GeLU; their product,
projected back.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers

CONV_K = 4
C_RGLRU = 8.0


def init_rglru(cfg: ModelConfig, new):
    """wx_in / wy_in (d, dr), conv_w (4, dr), conv_b (dr,), the per-head
    gates wa / wi (H, hb, hb), lambda (dr,) and out (dr, d), dr = d."""
    d = cfg.d_model
    dr = d                                  # Griffin uses d_rec = d_model
    H = cfg.rglru_heads or cfg.num_heads
    hb = dr // H
    return {
        "wx_in": new((d, dr), layers.dense(d)),
        "wy_in": new((d, dr), layers.dense(d)),
        "conv_w": new((CONV_K, dr), ("normal", 0.1)),
        "conv_b": new((dr,), "zeros"),
        "wa": new((H, hb, hb), ("normal", 1.0 / math.sqrt(hb))),
        "wi": new((H, hb, hb), ("normal", 1.0 / math.sqrt(hb))),
        # softplus^-1(-log u / c), u uniform in [0.9, 0.999]: a^c in the
        # paper's init range
        "lambda": new((dr,), "rglru_lambda"),
        "out": new((dr, d), layers.dense(dr)),
    }


def _blockdiag(w, x):
    """x: (..., dr) -> per-head block-diagonal matmul; w: (H, hb, hb)."""
    H, hb, _ = w.shape
    xh = x.reshape(*x.shape[:-1], H, hb)
    return torch.einsum("...hb,hbc->...hc", xh, w).reshape(x.shape)


def _gates(p, x):
    """Returns (log_a, gated_input) for the RG-LRU at inputs x (B,S,dr),
    in float32."""
    r = torch.sigmoid(_blockdiag(p["wa"], x).to(torch.float32))
    i = torch.sigmoid(_blockdiag(p["wi"], x).to(torch.float32))
    log_a = -C_RGLRU * F.softplus(p["lambda"]) * r
    a2 = torch.exp(2.0 * log_a)
    gated = (torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * i
             * x.to(torch.float32))
    return log_a, gated


def rglru_scan(p, x):
    """x: (B, S, dr) -> h: (B, S, dr), h_final. Parallel prefix scan: pass
    k folds into each h_t the prefix ending 2**k steps earlier, by the
    reference's combine (a_l, h_l), (a_r, h_r) -> (a_l a_r, a_r h_l + h_r)."""
    log_a, h = _gates(p, x)
    a = torch.exp(log_a)
    S, off = x.shape[1], 1
    while off < S:
        h = torch.cat([h[:, :off], a[:, off:] * h[:, :-off] + h[:, off:]], 1)
        if 2 * off < S:                     # the last pass needs no a
            a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        off *= 2
    return h, h[:, -1]


def apply_rec_train(p, cfg: ModelConfig, u):
    """Griffin recurrent block, full sequence. u: (B, S, d)."""
    x = u @ p["wx_in"]
    # jax.nn.gelu defaults to the tanh approximation
    y = F.gelu(u @ p["wy_in"], approximate="tanh")
    # causal depthwise conv, the reference's sum of shifted products
    pad = F.pad(x, (0, 0, CONV_K - 1, 0))
    x = sum(pad[:, i:i + u.shape[1], :] * p["conv_w"][i]
            for i in range(CONV_K)) + p["conv_b"]
    h, _ = rglru_scan(p, x)
    return (h.to(u.dtype) * y) @ p["out"]


def rglru_step(p, x, h_prev):
    """x: (B, 1, dr); the O(1) decode step: (h (B, 1, dr), h (B, dr))."""
    log_a, b = _gates(p, x)
    h = torch.exp(log_a[:, 0]) * h_prev + b[:, 0]
    return h[:, None, :], h


class RecCache(NamedTuple):
    conv: torch.Tensor  # (B, CONV_K-1, dr)
    h: torch.Tensor     # (B, dr) float32


def init_rec_cache(cfg: ModelConfig, batch: int, dtype, *,
                   device=None) -> RecCache:
    dr = cfg.d_model
    return RecCache(
        conv=torch.zeros((batch, CONV_K - 1, dr), dtype=dtype, device=device),
        h=torch.zeros((batch, dr), dtype=torch.float32, device=device))


def apply_rec_decode(p, cfg: ModelConfig, u, cache: RecCache):
    """u: (B, 1, d). Returns (out, cache): the cache's tensors are written
    in place."""
    x_new = u @ p["wx_in"]                                 # (B, 1, dr)
    y = F.gelu(u @ p["wy_in"], approximate="tanh")
    conv_in = torch.cat([cache.conv, x_new], 1)
    x = (sum(conv_in[:, i, :] * p["conv_w"][i] for i in range(CONV_K))
         + p["conv_b"])[:, None, :]
    h_seq, h = rglru_step(p, x, cache.h)
    cache.conv.copy_(conv_in[:, 1:])
    cache.h.copy_(h)
    return (h_seq.to(u.dtype) * y) @ p["out"], cache
