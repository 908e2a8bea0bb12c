"""Mamba2 / SSD (state-space duality) block, train path — the port of
``repro/models/ssm.py`` (decode and its cache wait for serving, ROADMAP.md
queue 1, item 14).

The chunked SSD algorithm splits the sequence into chunks of Q steps;
within a chunk the recurrence takes its dual, attention-like quadratic
form, and the (B, H, P, N) state passes between chunks. The reference
scans over the chunks; the port computes every chunk's dual form at once
and passes the state between chunks with one (nc+1) x (nc+1) decay
product, so the autograd graph has a fixed, small number of operations
whatever the length (a loop over chunks would issue hundreds of small
launches per layer in the backward).

Under ``kernel_ctx`` the block's scan runs as the K4 kernel
(``kernels/ssd_scan``, zero initial state, as this block uses it), whose
backward differentiates :func:`_ssd_chunked`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import kernel_ctx, layers

CONV_K = 4  # depthwise conv kernel size (Mamba default)


def dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    H = di // cfg.ssm_head_dim
    return di, H, cfg.ssm_head_dim, cfg.ssm_state


def init_ssm(cfg: ModelConfig, new):
    """in_proj (d, 2di + 2N + H), conv_w (CONV_K, di + 2N), conv_b, A_log
    = log(1..H), D = 1, dt_bias = 0 (H,), the gated norm's scale (di,)
    and out_proj (di, d), in the reference's order and layouts. The
    reference keeps A_log, D and dt_bias in float32 whatever param_dtype
    is; here every leaf shares the trainer's flat buffer, so they take
    param_dtype (with bfloat16 masters, A_log is rounded to bfloat16)."""
    d = cfg.d_model
    di, H, P, N = dims(cfg)
    return {
        "in_proj": new((d, 2 * di + 2 * N + H), layers.dense(d)),
        "conv_w": new((CONV_K, di + 2 * N), ("normal", 0.1)),
        "conv_b": new((di + 2 * N,), "zeros"),
        "A_log": new((H,), "log_arange"),
        "D": new((H,), "ones"),
        "dt_bias": new((H,), "zeros"),
        "norm": new((di,), "ones"),
        "out_proj": new((di, d), layers.dense(di)),
    }


def _split_proj(cfg: ModelConfig, proj):
    di, H, P, N = dims(cfg)
    return torch.split(proj, [di, di, N, N, H], dim=-1)   # z, x, B, C, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, kernel CONV_K. xBC: (B, S, C)."""
    pad = F.pad(xBC, (0, 0, CONV_K - 1, 0))
    S = xBC.shape[1]
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(CONV_K))
    return F.silu(out + b)


def _segsum_decay(tot):
    """tot: (B, nc, H) per-chunk log-decay -> (B, H, nc+1, nc+1) with
    entry [z, j] = exp(sum_{j <= k < z} tot_k) for j <= z, else 0: the
    factor by which source j (0: the initial state, j > 0: chunk j-1's
    contribution) reaches the state entering chunk z. The sums are
    running sums of masked copies, never differences of prefix sums, so
    no large terms cancel; the exp sees only masked (finite) values."""
    B_, nc, H = tot.shape
    dev = tot.device
    z = torch.arange(nc + 1, device=dev)[:, None]
    k = torch.arange(nc, device=dev)[None, :]
    t = tot.permute(0, 2, 1)[:, :, None, :]                 # (B, H, 1, nc)
    m = torch.where(k < z, t, 0.0)                          # (B, H, nc+1, nc)
    seg = m.flip(-1).cumsum(-1).flip(-1)                    # sum_{k >= j}
    seg = F.pad(seg, (0, 1))                                # j = nc: 0
    j = torch.arange(nc + 1, device=dev)[None, :]
    return torch.where(j <= z, torch.exp(torch.where(j <= z, seg, 0.0)),
                       0.0)


def _ssd_chunked(x, dt, A_log, Bc, Cc, h0, chunk: int):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H); Bc, Cc: (B, S, N); h0: (B, H, P, N).
    Returns (y: (B, S, H, P) float32, h_final (B, H, P, N)).
    """
    B_, S, H, P = x.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:                      # pad to a chunk multiple (zero input,
        pad = Q - S % Q            # zero log-decay: padding is inert)
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    f32 = torch.float32

    dt = dt.to(f32)
    h0 = h0.to(f32)
    a = -torch.exp(A_log.to(f32))                         # (H,) negative
    la = a[None, None, :] * dt                            # (B, S, H)
    xdt = x.to(f32) * dt[..., None]                       # discretized input

    la_c = la.reshape(B_, nc, Q, H)
    x_c = xdt.reshape(B_, nc, Q, H, P)
    B_c = Bc.reshape(B_, nc, Q, N).to(f32)
    C_c = Cc.reshape(B_, nc, Q, N).to(f32)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))

    L = torch.cumsum(la_c, dim=2)                         # (B, nc, Q, H)
    # intra-chunk dual quadratic form, every chunk at once; the decay is
    # masked by min(., 0) before the exp, so no inf reaches the product
    scores = C_c @ B_c.transpose(-1, -2)                  # (B, nc, Q, Q)
    decay = torch.exp(torch.clamp(L[:, :, :, None, :] - L[:, :, None, :, :],
                                  max=0.0))               # (B, nc, Q, Q, H)
    w = scores[..., None] * decay * causal[:, :, None]
    y = torch.einsum("bcqkh,bckhp->bcqhp", w, x_c)
    # each chunk's own contribution to the state at its end
    tot = L[:, :, -1, :]                                  # (B, nc, H)
    dte = torch.exp(tot[:, :, None, :] - L)               # (B, nc, Q, H)
    cs = torch.einsum("bcqn,bcqhp->bchpn", B_c, x_c * dte[..., None])
    # the state entering every chunk (and the final one), from h0 and the
    # chunks before it
    src = torch.cat([h0[:, None], cs], 1)                 # (B, nc+1, H, P, N)
    h_in = torch.einsum("bhzj,bjhpn->bzhpn", _segsum_decay(tot), src)
    # inter-chunk: the contribution of the carried state
    y = y + (torch.einsum("bcqn,bchpn->bcqhp", C_c, h_in[:, :nc])
             * torch.exp(L)[..., None])
    y = y.reshape(B_, S, H, P)
    return y[:, :S_orig], h_in[:, nc]


def ssd_naive(x, dt, A_log, Bc, Cc, h0):
    """Sequential reference recurrence (tests compare against this)."""
    f32 = torch.float32
    dt = dt.to(f32)
    h = h0.to(f32)
    a = -torch.exp(A_log.to(f32))
    ys = []
    for t in range(x.shape[1]):
        xt, dtt = x[:, t].to(f32), dt[:, t]
        bt, ct = Bc[:, t].to(f32), Cc[:, t].to(f32)
        decay = torch.exp(a * dtt)                        # (B, H)
        upd = torch.einsum("bhp,bn->bhpn", xt * dtt[..., None], bt)
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, ct))
    return torch.stack(ys, 1), h


class _SSDFused(torch.autograd.Function):
    """The SSD scan from a zero state whose forward is the K4 kernel and
    whose backward differentiates :func:`_ssd_chunked`: the kernel is
    forward-only, as the reference's kernels are."""

    @staticmethod
    def forward(ctx, x, dt, A_log, Bc, Cc, chunk):
        from repro_torch.kernels.ssd_scan import kernel
        ctx.save_for_backward(x, dt, A_log, Bc, Cc)
        ctx.chunk = chunk
        return kernel.ssd_scan(x, dt, A_log, Bc, Cc, chunk=chunk)

    @staticmethod
    def backward(ctx, ct):
        x, dt, A_log, Bc, Cc = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_()
                   for t in (x, dt, A_log, Bc, Cc)]
            B_, _, H, P = x.shape
            h0 = torch.zeros(B_, H, P, Bc.shape[-1], dtype=torch.float32,
                             device=x.device)
            y, _ = _ssd_chunked(*ins, h0, ctx.chunk)
            grads = torch.autograd.grad(y, ins, ct)
        return (*grads, None)


def apply_ssm_train(p, cfg: ModelConfig, u):
    """u: (B, S, d) -> (B, S, d). Full block: proj, conv, SSD, gate, norm."""
    di, H, P, N = dims(cfg)
    B_, S, _ = u.shape
    proj = u @ p["in_proj"]
    z, xs, Bc, Cc, dt = _split_proj(cfg, proj)
    xBC = _causal_conv(torch.cat([xs, Bc, Cc], -1), p["conv_w"], p["conv_b"])
    xs, Bc, Cc = torch.split(xBC, [di, N, N], dim=-1)
    dt = dt.to(torch.float32) + p["dt_bias"]
    dt = torch.logaddexp(dt, dt.new_zeros(()))            # softplus
    x_h = xs.reshape(B_, S, H, P)
    if kernel_ctx.active():
        y = _SSDFused.apply(x_h, dt, p["A_log"], Bc, Cc, cfg.ssm_chunk)
    else:
        h0 = torch.zeros(B_, H, P, N, dtype=torch.float32, device=u.device)
        y, _ = _ssd_chunked(x_h, dt, p["A_log"], Bc, Cc, h0, cfg.ssm_chunk)
    y = y + p["D"][None, None, :, None] * x_h.to(torch.float32)
    y = y.reshape(B_, S, di).to(u.dtype)
    y = layers.rms_norm_1d(p["norm"], y * F.silu(z))
    return y @ p["out_proj"]
