"""Plain PyTorch versions of causal GQA attention: the chunked
online-softmax form (``chunked_attention``, the port of the reference's
``models/attention.py::chunked_attention``, which the model runs unfused
and whose autograd is the fused path's backward), the naive quadratic
form (``naive_attention``, small shapes only), and
:func:`flash_attention_ref`, the arithmetic of the CUDA kernel in
``csrc/flash_attention.cu``: the chunked form at the kernel's query and
key blocks (``BLOCKS``), on a sequence padded to the query block.

The wrapper in ``kernel.py`` runs :func:`flash_attention_ref` for tensors
on the CPU; ``chip_smoke.py`` holds the kernel against it on the card.
Layouts are the reference's: q (B, S, H, hd), k and v (B, S, KV, hd).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
# the CUDA kernel's (query block, key block) by dtype and head size: the
# table of launch_hd<bf16> and launch_hd<float> in csrc/flash_attention.cu
# (tests/test_torch_lm_kernels.py holds the two together)
BLOCKS = {
    torch.bfloat16: {32: (128, 64), 64: (128, 64), 128: (128, 64),
                     256: (64, 64)},
    torch.float32: {32: (64, 64), 64: (64, 64), 128: (64, 64),
                    256: (64, 32)},
}


def blocks(dtype, head_dim: int):
    """(query block, key block) of the kernel for q's dtype and head size:
    the bf16 entry for bfloat16, the float32 entry for any other dtype
    (the CPU runs float64 too); a head size the kernel does not take takes
    the entry of the next larger one, or of the largest."""
    table = BLOCKS[torch.bfloat16 if dtype == torch.bfloat16
                   else torch.float32]
    return table[min((h for h in table if h >= head_dim),
                     default=max(table))]


def chunked_attention(q, k, v, *, window: Optional[int] = None,
                      q_chunk: int = 512, kv_chunk: int = 512,
                      softcap: Optional[float] = None):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd); returns (B, S, H, hd).

    Causal; optional sliding window (key j visible to query i iff
    i - window < j <= i). Online softmax over kv chunks, accumulated in
    float32 (float64 for float64 inputs); p is cast to v's dtype before
    the product with v. Chunks wholly in a query chunk's future are
    skipped: with the running max already finite they change nothing.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, S)
    nq, nk = S // q_chunk, S // kv_chunk
    if nq * q_chunk != S or nk * kv_chunk != S:
        raise ValueError(f"chunked_attention: S={S} is not a multiple of "
                         f"the chunks ({q_chunk}, {kv_chunk})")
    acc_t = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(hd)
    qs = q.reshape(B, nq, q_chunk, KV, G, hd)
    ks = k.reshape(B, nk, kv_chunk, KV, hd)
    vs = v.reshape(B, nk, kv_chunk, KV, hd)
    pos = torch.arange(S, device=q.device)
    outs = []
    for qi in range(nq):
        q_blk = qs[:, qi].to(acc_t)                  # (B, qc, KV, G, hd)
        qp = pos[qi * q_chunk:(qi + 1) * q_chunk][:, None]
        m = torch.full((B, q_chunk, KV, G), NEG_INF, dtype=acc_t,
                       device=q.device)
        l = torch.zeros((B, q_chunk, KV, G), dtype=acc_t, device=q.device)
        acc = torch.zeros((B, q_chunk, KV, G, hd), dtype=acc_t,
                          device=q.device)
        for kj in range(nk):
            if kj * kv_chunk > (qi + 1) * q_chunk - 1:
                break
            kp = pos[kj * kv_chunk:(kj + 1) * kv_chunk][None, :]
            s = torch.einsum("bqkgh,bckh->bqkgc", q_blk,
                             ks[:, kj].to(acc_t)) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            mask = kp <= qp
            if window is not None:
                mask = mask & (kp > (qp - window))
            s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckh->bqkgh", p.to(v.dtype).to(acc_t),
                vs[:, kj].to(acc_t))
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.stack(outs, 1).reshape(B, S, H, hd)


def naive_attention(q, k, v, *, window: Optional[int] = None):
    """Quadratic reference (small shapes only): scores in float32, softmax,
    weights cast to v's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgh,bckh->bqkgc", qh.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(hd)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = j <= i
    if window is not None:
        mask = mask & (j > (i - window))
    s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def flash_attention_ref(q, k, v, *, window: Optional[int] = None,
                        block: Optional[tuple] = None):
    """The kernel's function: causal GQA attention chunked by the kernel's
    (query block, key block) for q's dtype and head size (``blocks``), or
    by ``block``. S need not be a multiple of the blocks: the sequence is
    padded with zeros to the query block, which the key block divides;
    causality hides the padding from every real query, and a key block of
    padding after a row's visible keys changes none of its values."""
    B, S, H, hd = q.shape
    q_blk, kv_blk = block or blocks(q.dtype, hd)
    pad = (-S) % q_blk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    out = chunked_attention(q, k, v, window=window, q_chunk=q_blk,
                            kv_chunk=kv_blk)
    return out[:, :S]
