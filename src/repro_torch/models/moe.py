"""Mixture-of-Experts FFN, train path — the port of ``repro/models/moe.py``:
top-k routing with capacity-based sort dispatch, the reference's algorithm
step for step, so that the same tokens are dropped.

Routing: softmax over all experts, top-K of the probabilities (ties to the
lower expert index, as ``jax.lax.top_k``), renormalised; the Switch
load-balance loss. Dispatch: the (token, k) pairs are sorted by expert
(stably), each pair's slot is its position in its expert's list, and
pairs past the capacity go to one extra slot that reads a zero row. The
expert products are batched GEMMs over E (``torch.bmm``, so that under
``remat="dots"`` they are recomputed as the reference's
``checkpoint_dots_with_no_batch_dims`` recomputes them); the combine is
token-major through the inverse permutation. The reference reaches no
Pallas kernel here, and neither does the port.

Expert parallelism: on a mesh whose 'model' axis splits the experts
(``sharding/specs.py`` puts ``wg``/``wu``/``wd`` at ``(model, data,
None)`` and the router's columns at ``(None, model)``), each rank holds
E/tp experts and their router columns. The rank's logits are gathered
over 'model' (``tp.gather_out``), so every rank routes, drops and
computes the aux loss alike on the full (T, E); it fills only its own
experts' slots, and its weighted combine is a partial sum that one
``tp.reduce_out`` over 'model' completes, (T, d) a layer. Where the
reference lets GSPMD place the collectives, the port's are explicit,
each with its conjugate backward (``sharding/tp.py``). An expert count
that the 'model' axis does not divide stays replicated, and the MoE
then runs as on one device.

Supports the two MoE flavours of the zoo: qwen3-moe-30b-a3b (128 routed
experts, top-8) and qwen2-moe-a2.7b (60 routed, top-4, a shared SwiGLU
expert with a sigmoid gate; the shared expert is the tensor-parallel MLP
where its hidden dim is split over 'model').
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers


def init_moe(cfg: ModelConfig, new):
    """router (d, E), wg / wu (E, d, ff), wd (E, ff, d); the shared expert
    and its gate where the arch has them. Layout order as the
    reference's dict."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": new((d, E), layers.dense(d)),
        "wg": new((E, d, ff), layers.dense(d)),
        "wu": new((E, d, ff), layers.dense(d)),
        "wd": new((E, ff, d), layers.dense(ff)),
    }
    if cfg.shared_expert_d_ff:
        sff = cfg.shared_expert_d_ff
        p["shared"] = {"wg": new((d, sff), layers.dense(d)),
                       "wu": new((d, sff), layers.dense(d)),
                       "wd": new((sff, d), layers.dense(sff))}
        if cfg.shared_expert_gate:
            p["shared_gate"] = new((d, 1), layers.dense(d))
    return p


def _top_k(probs, k: int):
    """The k largest of each row, descending, ties to the lower index (as
    ``jax.lax.top_k``; ``torch.topk`` leaves ties unordered)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def apply_moe(p, cfg: ModelConfig, x, capacity_factor: float = 0.0):
    """x: (B, S, d) -> (y, aux_loss). capacity_factor 0 -> cfg value. On
    a mesh whose 'model' axis splits the experts, ``p`` holds this rank's
    experts and router columns (see the module docstring)."""
    from repro_torch.sharding import tp
    capacity_factor = capacity_factor or cfg.moe_capacity_factor
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    dev = x.device
    xt = x.reshape(T, d)
    # expert parallel: this rank's experts [e0, e0 + El); its share of the
    # router and of the dispatch reaches xt's gradient through one copy_in
    El = p["wg"].shape[0]
    split = tp.split(El, E)
    e0 = tp.rank() * El if split else 0
    xs = tp.copy_in(xt) if split else xt

    # a bf16 router (params cast to the compute dtype) is promoted to f32
    logits = layers._matmul(xs.to(torch.float32), p["router"])   # (T, E/tp)
    if split:
        logits = tp.gather_out(logits)                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_e = _top_k(probs, K)                              # (T, K)
    topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)

    # load-balance auxiliary loss (Switch-style); density carries no
    # gradient, router_prob does. Every rank holds the full probs, so the
    # loss is replicated and is not summed over 'model'
    density = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, topk_e.reshape(-1),
        torch.ones(T * K, dtype=torch.float32, device=dev)) / (T * K)
    router_prob = probs.mean(0)
    aux = (cfg.router_aux_coef * E
           * torch.sum(density * router_prob)).to(torch.float32)

    # capacity-based sort dispatch
    cap = max(int(capacity_factor * T * K / E), 8)
    flat_e = topk_e.reshape(-1)                                    # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_w = topk_p.reshape(-1)

    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    t_sorted = flat_t[order]
    pos_in_e = torch.arange(T * K, device=dev)
    counts = torch.bincount(e_sorted, minlength=E)
    e_start = torch.cumsum(counts, 0) - counts      # start offset per expert
    slot = pos_in_e - e_start[e_sorted]
    keep = slot < cap
    buf_idx = torch.where(keep, e_sorted * cap + slot, E * cap)  # overflow

    # source token of every buffer position; T reads the zero row. The
    # rank gathers its own experts' slots only
    src = torch.full((E * cap + 1,), T, dtype=torch.int64,
                     device=dev).scatter_(0, buf_idx, t_sorted)[:-1]
    src = src[e0 * cap:(e0 + El) * cap]
    xt_pad = torch.cat([xs, xs.new_zeros(1, d)])
    xin = xt_pad[src].reshape(El, cap, d)                          # gather

    h = F.silu(torch.bmm(xin, p["wg"])) * torch.bmm(xin, p["wu"])
    yexp = torch.bmm(h, p["wd"])                                # (El, cap, d)

    # combine, token-major: each (token, k)'s buffer slot through the
    # inverse permutation, then a gather of the expert outputs; a slot of
    # another rank's experts (or a dropped pair) reads the zero row
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=dev))
    slot_flat = buf_idx[inv] - e0 * cap                            # (T*K,)
    slot_flat = torch.where((slot_flat >= 0) & (slot_flat < El * cap),
                            slot_flat, El * cap)
    yexp_pad = torch.cat([yexp.reshape(El * cap, d), yexp.new_zeros(1, d)])
    contrib = yexp_pad[slot_flat].reshape(T, K, d)                 # gather
    w = flat_w.reshape(T, K).to(contrib.dtype)
    if split:
        # each rank's combine reaches only its experts' weights: their
        # gradient is summed over 'model', as the partial sums are
        w = tp.copy_in(w)
    y = torch.bmm(w[:, None, :], contrib)[:, 0].to(x.dtype)       # tkd,tk->td
    if split:
        y = tp.reduce_out(y)

    if "shared" in p:
        sp = p["shared"]
        sh = layers.apply_mlp(sp, xt, "swiglu", tp_split=tp.split(
            sp["wg"].shape[1], cfg.shared_expert_d_ff))
        if "shared_gate" in p:
            sh = sh * torch.sigmoid(xt @ p["shared_gate"])
        y = y + sh

    return y.reshape(B, S, d), aux
