"""Plain PyTorch reference of a dense decoder LM trained by CentralVR with
SGD, in float32 with TF32 off.

The model is the published Qwen2 block (arXiv:2407.10671; the Hugging Face
``Qwen2ForCausalLM``): token embedding; per layer a pre-norm RMSNorm,
grouped-query attention with biases on q, k and v and rotary embeddings
(``rotate_half`` form, angles in float32), causal softmax, the output
projection, a second RMSNorm and the SwiGLU MLP; a final RMSNorm and an
untied head. The loss is the mean next-token cross-entropy of a step's
tokens.

CentralVR (the paper's Algorithm 1 with one worker): M table rows, one a
component; step k visits component i = k mod M with its fresh gradient g,
takes v = g - table[i] + gbar, x <- x - lr * v, table[i] <- g, and
gtilde <- gtilde + g / M; after the last component of an epoch gbar <-
gtilde and gtilde <- 0. Table, gbar and gtilde start at zero.

Memory: each layer is recomputed in the backward pass, attention a block
of queries at a time and the loss a block of positions at a time, so the
reference fits beside its float32 state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 1024
LOSS_BLOCK = 1024


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x: (B, S, heads, hd)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.int64).float() / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, q0: int):
    """Queries q0 .. q0 + len - 1 against keys 0 .. q0 + len - 1. q: (B,
    Sq, KV, G, hd); k, v: (B, Sk, KV, hd)."""
    hd = q.shape[-1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) / math.sqrt(hd)
    qpos = torch.arange(q0, q0 + q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    s = s.masked_fill(kpos > qpos, float("-inf"))
    return torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(s, dim=-1), v)


def attention(q, k, v):
    """Causal grouped-query attention. q: (B, S, H, hd); k, v: (B, S, KV,
    hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    q = q.view(B, S, KV, H // KV, hd)
    out = []
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, S)
        out.append(checkpoint(_attend_block, q[:, q0:q1], k[:, :q1],
                              v[:, :q1], q0, use_reentrant=False))
    return torch.cat(out, dim=1).reshape(B, S, H * hd)


def block(x, w: dict, i: int, conf: dict):
    d = conf["hidden_size"]
    H, KV = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // H
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    p = f"layers.{i}."
    B, S, _ = x.shape
    h = rmsnorm(x, w[p + "attn_norm"], eps)
    q = (h @ w[p + "wq"] + w[p + "bq"]).view(B, S, H, hd)
    k = (h @ w[p + "wk"] + w[p + "bk"]).view(B, S, KV, hd)
    v = (h @ w[p + "wv"] + w[p + "bv"]).view(B, S, KV, hd)
    x = x + attention(rope(q, theta), rope(k, theta), v) @ w[p + "wo"]
    h = rmsnorm(x, w[p + "mlp_norm"], eps)
    return x + (F.silu(h @ w[p + "wg"]) * (h @ w[p + "wu"])) @ w[p + "wd"]


def _nll_sum(x, head, labels):
    logits = x @ head
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, labels[..., None])[..., 0]).sum()


def loss(w: dict, conf: dict, tokens):
    """Mean next-token cross-entropy of ``tokens`` (B, S)."""
    x = w["embed"][tokens]
    for i in range(conf["num_hidden_layers"]):
        x = checkpoint(block, x, w, i, conf, use_reentrant=False)
    x = rmsnorm(x, w["final_norm"], conf["rms_norm_eps"])
    x, labels = x[:, :-1], tokens[:, 1:]
    total = x.new_zeros(())
    for s0 in range(0, x.shape[1], LOSS_BLOCK):
        total = total + checkpoint(_nll_sum, x[:, s0:s0 + LOSS_BLOCK],
                                   w["head"], labels[:, s0:s0 + LOSS_BLOCK],
                                   use_reentrant=False)
    return total / labels.numel()


def train(conf: dict, train: dict, flat: torch.Tensor, leaves: dict,
          tokens: torch.Tensor, steps: int) -> dict:
    """Follows CentralVR-SGD for ``steps`` steps from the weights in
    ``flat`` (float32, updated in place; ``leaves`` are its views by
    name). ``tokens``: (1, M*K, A, mb, S), step k reads block k mod M*K.

    Returns {"losses": [step loss], "grad0": {leaf: norm of the first
    step's gradient}, "x": flat after the steps}."""
    M, lr = train["vr_table_size"], train["learning_rate"]
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        names = list(leaves)
        table = [torch.zeros_like(flat) for _ in range(M)]
        gbar, gtilde = torch.zeros_like(flat), torch.zeros_like(flat)
        g = torch.empty_like(flat)
        gviews = [g[_span(flat, leaves[n])].view_as(leaves[n])
                  for n in names]
        losses, grad0 = [], None
        E = tokens.shape[1]
        for k in range(steps):
            block_tokens = tokens[0, k % E]            # (A, mb, S)
            A = block_tokens.shape[0]
            params = [leaves[n].detach().requires_grad_() for n in names]
            w = dict(zip(names, params))
            step_loss = 0.0
            for a in range(A):
                lo = loss(w, conf, block_tokens[a])
                grads = torch.autograd.grad(lo, params)
                for j, gr in enumerate(grads):
                    if a == 0:
                        gviews[j].copy_(gr)
                    else:
                        gviews[j].add_(gr)
                del grads
                step_loss += float(lo.detach()) / A
            if A > 1:
                g.div_(A)
            losses.append(step_loss)
            if k == 0:
                grad0 = {n: float(torch.linalg.vector_norm(gv))
                         for n, gv in zip(names, gviews)}
            i = k % M
            with torch.no_grad():
                v = table[i].neg_().add_(g).add_(gbar)   # in the row's room
                flat.add_(v, alpha=-lr)
                table[i].copy_(g)
                gtilde.add_(g, alpha=1.0 / M)
                if i == M - 1:
                    gbar.copy_(gtilde)
                    gtilde.zero_()
        return {"losses": losses, "grad0": grad0, "x": flat}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _span(flat: torch.Tensor, view: torch.Tensor) -> slice:
    o = view.storage_offset() - flat.storage_offset()
    return slice(o, o + view.numel())
