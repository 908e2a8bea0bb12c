"""GQA attention — the port of ``repro/models/attention.py``: chunked
causal attention for train and prefill, single-token KV-cache attention
for the lockstep decode (``attend_decode``), and the serving runtime's
explicit-context attention (``attend_serve``).

The chunked online-softmax form and the naive form live beside the
flash kernel's plain version in ``kernels/flash_attention/ref.py`` and are
re-exported here. Under ``kernel_ctx`` the score / softmax / weighted-sum
pipeline of the train path runs as the K3 flash kernel, one launch per
layer per forward, with the chunked form's autograd as its backward.
Decode and serving attention are plain PyTorch, as the reference's are
plain JAX: they reach no Pallas kernel.
"""
from __future__ import annotations

import math
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


def _head_mask(cfg: ModelConfig, out, h0: int = 0):
    """Zero the padded heads' outputs (none unless ``pad_heads_to`` is
    set), so they are exactly inert. ``out`` holds heads h0, h0 + 1, ...
    (a tensor-parallel rank's heads start at h0)."""
    if cfg.padded_heads == cfg.num_heads:
        return out
    heads = torch.arange(h0, h0 + out.shape[-2], device=out.device)
    mask = (heads < cfg.num_heads).to(out.dtype)
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


def tp_kv_heads(H: int, KV: int, h0: int, h1: int):
    """The kv heads that q heads [h0, h1) of H read (GQA: head h reads kv
    head h // (H / KV)): (k0, k1, index), the range [k0, k1) to slice,
    and ``index`` None when the slice keeps the kernel's own ``h // g``
    map right for the local heads, else the kv head of each local q head
    within the slice (one kv head per q head is then gathered)."""
    g = H // KV
    k0, k1 = h0 // g, (h1 - 1) // g + 1
    hl, kvl = h1 - h0, k1 - k0
    want = [(h0 + j) // g - k0 for j in range(hl)]
    if hl % kvl == 0 and want == [j // (hl // kvl) for j in range(hl)]:
        return k0, k1, None
    return k0, k1, want


def _attend_tp(p, cfg: ModelConfig, x, w):
    """Attention over this rank's q heads (``wq``/``bq``/``wo`` split over
    'model' by heads; ``wk``/``wv`` replicated, each rank slicing the kv
    heads its q heads read), ending in one all-reduce over 'model'."""
    from repro_torch.sharding import tp
    Hl = p["wq"].shape[1]
    h0 = tp.rank() * Hl
    k0, k1, index = tp_kv_heads(cfg.padded_heads, cfg.num_kv_heads, h0,
                                h0 + Hl)
    x = tp.copy_in(x)
    # replicated leaves used for a slice of the work: their gradients sum
    # the ranks' slices
    kv = {n: tp.copy_in(p[n])[..., k0:k1, :] if p[n].dim() == 3
          else tp.copy_in(p[n])[k0:k1] for n in ("wk", "wv", "bk", "bv")
          if n in p}
    norms = {n: tp.copy_in(p[n]) for n in ("q_norm", "k_norm") if n in p}
    local = dict(p, **kv, **norms)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project_qkv(local, cfg, x, positions)
    if index is not None:
        sel = torch.tensor(index, device=k.device)
        k, v = k.index_select(2, sel), v.index_select(2, sel)
    return output_proj_serve(p, cfg, _attention_core(cfg, q, k, v, w))


def _attention_core(cfg: ModelConfig, q, k, v, w):
    if kernel_ctx.active() and cfg.attn_logit_softcap is None:
        return _FlashFused.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), w)
    return chunked_attention(q, k, v, window=w,
                             softcap=cfg.attn_logit_softcap)


def attend_train(p, cfg: ModelConfig, x, *, window: Optional[int] = None):
    """Full block for train/prefill: project, attention, out-projection.

    Under ``kernel_ctx`` the attention runs as the K3 kernel (one launch
    per layer), except for softcapped archs, which the kernel does not
    implement. On a mesh whose 'model' axis splits the q heads, each
    rank attends over its heads (:func:`_attend_tp`)."""
    from repro_torch.sharding import tp
    w = window if window is not None else cfg.sliding_window
    if tp.split(p["wq"].shape[1], cfg.padded_heads):
        return _attend_tp(p, cfg, x, w)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    return output_proj_serve(p, cfg, _attention_core(cfg, q, k, v, w))


# ---------------------------------------------------------------------------
# Decode (single token, KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               *, window: Optional[int] = None, device=None):
    """Cache for one attention layer. Window (or hybrid-local) layers use a
    ring buffer of ``window`` slots; full attention keeps max_len slots."""
    w = window if window is not None else cfg.sliding_window
    slots = min(max_len, w) if w else max_len
    shape = (batch, slots, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attend_decode(p, cfg: ModelConfig, x, cache, pos: int, *,
                  window: Optional[int] = None):
    """x: (B, 1, d); pos: the current position (an int, the same for every
    row). Returns (out, cache): the cache's tensors are written in place,
    where the reference returns new ones. A windowed cache is a ring:
    slot = pos % slots."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    slots = cache["k"].shape[1]
    slot = pos % slots
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]

    KV, hd = cfg.num_kv_heads, cfg.head_dim
    G = cfg.padded_heads // KV
    qh = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bckh->bkgc", qh.to(torch.float32),
                     cache["k"].to(torch.float32))
    s = s / math.sqrt(hd)
    if cfg.attn_logit_softcap:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    # slots filled so far, with sequential decode: min(pos + 1, slots)
    valid = torch.arange(slots, device=x.device) < min(pos + 1, slots)
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(cache["v"].dtype)
    out = torch.einsum("bkgc,bckh->bkgh", w, cache["v"])
    out = out.reshape(B, 1, cfg.padded_heads, hd)
    return output_proj_serve(p, cfg, out), cache


# ---------------------------------------------------------------------------
# Serving: explicit-context attention (chunked prefill / per-lane decode)
# ---------------------------------------------------------------------------
#
# The serving runtime (repro_torch/serve) batches sequences at different
# positions in one program, so the lockstep ``attend_decode`` does not
# apply. In ``attend_serve`` queries carry their own absolute positions and
# the key/value context is an explicit stream with per-entry absolute
# positions and a validity mask: what a paged pool gather, a dense lane
# buffer or a sliding-window ring gives. Its online softmax over kv chunks
# is the scheme of ``chunked_attention``.


def ring_positions(last_pos, slots: int):
    """Absolute position held by each slot of a sequentially-written ring.

    ``last_pos``: (B,) the last absolute position written (-1 if empty).
    Slot c holds the largest written position = c (mod slots); returns
    (pos (B, slots), valid (B, slots)) with unwritten slots invalid.
    """
    c = torch.arange(slots, device=last_pos.device)
    pos = last_pos[:, None] - torch.remainder(last_pos[:, None] - c[None, :],
                                              slots)
    valid = (pos >= 0) & (last_pos >= 0)[:, None]
    return pos, valid


def attend_serve(q, q_pos, k, v, k_pos, k_valid, *, window=None,
                 softcap=None, kv_chunk: int = 128):
    """q: (B, C, H, hd); q_pos: (B, C); k, v: (B, T, KV, hd); k_pos /
    k_valid: (B, T).

    Causal against absolute positions (key visible iff valid and ``k_pos
    <= q_pos``; window: ``k_pos > q_pos - window``). Fully-masked query
    rows return exact zeros (padded prefill positions and dead decode
    lanes, which the caller discards). Online softmax over kv chunks of
    the context, in the reference's order of updates: a Python loop over
    the chunks where the reference scans, the context padded to whole
    chunks with position -1, invalid.
    """
    B, C, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    T = k.shape[1]
    kv_chunk = min(kv_chunk, T)
    n = -(-T // kv_chunk)
    pad = n * kv_chunk - T
    if pad:
        k = torch.cat([k, k.new_zeros(B, pad, KV, hd)], 1)
        v = torch.cat([v, v.new_zeros(B, pad, KV, hd)], 1)
        k_pos = torch.cat([k_pos, k_pos.new_full((B, pad), -1)], 1)
        k_valid = torch.cat([k_valid, k_valid.new_zeros(B, pad)], 1)
    acc_t = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(B, C, KV, G, hd).to(acc_t)
    # the context in the accumulator's type once (exact), and the mask of
    # the whole context once: each chunk takes its slice of both
    v_dtype = v.dtype
    k, v = k.to(acc_t), v.to(acc_t)
    mask = k_valid[:, None, :] & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & (k_pos[:, None, :] > (q_pos[:, :, None] - window))
    mask = mask[:, :, None, None, :]                      # (B, C, 1, 1, T)
    m = torch.full((B, C, KV, G), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((B, C, KV, G), dtype=acc_t, device=q.device)
    acc = torch.zeros((B, C, KV, G, hd), dtype=acc_t, device=q.device)
    for j in range(n):
        blk = slice(j * kv_chunk, (j + 1) * kv_chunk)
        s = torch.einsum("bqkgh,bckh->bqkgc", qh, k[:, blk]) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mk = mask[..., blk]
        s = torch.where(mk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # the explicit re-mask keeps fully-masked rows exactly zero (m_new
        # stays NEG_INF there, so exp(s - m_new) would be 1, not 0)
        p = torch.where(mk, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        if v_dtype != acc_t:              # the weights at v's precision
            p = p.to(v_dtype).to(acc_t)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p,
                                                   v[:, blk])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, C, H, hd).to(q.dtype)


def project_qkv_serve(p, cfg: ModelConfig, x, positions):
    """The projection for the serving runtime: per-lane absolute positions
    (B, S) drive rope, unlike the lockstep decode. Under tensor
    parallelism q holds this rank's heads and k / v every kv head (the
    serve cache is whole on every rank)."""
    return _project_qkv(p, cfg, x, positions)


def serve_heads(p, cfg: ModelConfig):
    """This rank's q heads under tensor-parallel serving, as (h0, k0, k1,
    index) (:func:`tp_kv_heads`), or None where the q heads are whole."""
    from repro_torch.sharding import tp
    Hl = p["wq"].shape[1]
    if not tp.split(Hl, cfg.padded_heads):
        return None
    h0 = tp.rank() * Hl
    return (h0, *tp_kv_heads(cfg.padded_heads, cfg.num_kv_heads, h0,
                             h0 + Hl))


def kv_local(t, heads):
    """The kv heads of ``t`` (..., KV, hd) that the rank's q heads read
    (``heads`` from :func:`serve_heads`): the slice [k0, k1), with one kv
    head gathered per q head where the split breaks the ``h // g`` map;
    ``t`` itself where the heads are whole."""
    if heads is None:
        return t
    t = t[..., heads[1]:heads[2], :]
    if heads[3] is None:
        return t
    return t.index_select(-2, torch.tensor(heads[3], device=t.device))


def output_proj_serve(p, cfg: ModelConfig, out):
    """Head-masked output projection, shared with the train and decode
    paths: einsum("bshk,hkd->bsd") as one matmul. Where ``wo`` holds this
    rank's heads (tensor-parallel serving), the product is a partial sum
    that one all-reduce over 'model' completes."""
    from repro_torch.sharding import tp
    Hl = p["wo"].shape[0]
    split = tp.split(Hl, cfg.padded_heads)
    out = _head_mask(cfg, out, tp.rank() * Hl if split else 0)
    B, S, H, hd = out.shape
    y = out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, -1)
    return tp.reduce_out(y) if split else y
