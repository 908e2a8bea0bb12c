"""Gradient transformations (optax-style minimal API) — the port of
``repro/optim/optimizers.py``. Each optimizer is an (init, update) pair:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The LM trainer passes its flat (W, N) float32 buffers: params, grads and
updates are single tensors, and the state holds tensors of the same
shape. ``apply_updates`` adds in place (the reference returns new
params; in place saves a param-sized buffer).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def apply_updates(params, updates):
    return params.add_(updates.to(params.dtype))


def weak(value: float, like: torch.Tensor):
    """A Python scalar as JAX's weak typing applies it to ``like``: in
    ``like``'s dtype. For bfloat16 that rounds the scalar to bfloat16
    (``-0.1 * v`` multiplies by -0.10009765625); PyTorch would keep it in
    float32 inside the product."""
    if like.dtype in (torch.bfloat16, torch.float16):
        return torch.tensor(value, dtype=like.dtype, device=like.device)
    return value


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return weak(-lr, grads) * grads, state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return torch.zeros_like(params)

    def update(grads, m, params=None):
        m = weak(beta, m) * m + grads
        return weak(-lr, m) * m, m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: int


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (decoupled decay when weight_decay > 0). The bias
    corrections are computed in float32, as the reference computes them."""

    def init(params):
        z = torch.zeros(params.shape, dtype=torch.float32,
                        device=params.device)
        return AdamState(mu=z, nu=z.clone(), count=0)

    def update(grads, state, params):
        c = state.count + 1
        g = grads.to(torch.float32)
        mu = b1 * state.mu + (1 - b1) * g
        nu = b2 * state.nu + (1 - b2) * torch.square(g)
        f32 = torch.float32
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** torch.tensor(c, dtype=f32)
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** torch.tensor(c, dtype=f32)
        u = -lr * (mu / bc1.item()) / (torch.sqrt(nu / bc2.item()) + eps)
        if weight_decay:
            u = u - lr * weight_decay * params.to(torch.float32)
        return u, AdamState(mu=mu, nu=nu, count=c)

    return Optimizer(init, update)


def make(name: str, lr: float, weight_decay: float = 0.0) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr)
    if name == "adam":
        return adam(lr)
    if name == "adamw":
        return adam(lr, weight_decay=weight_decay or 0.01)
    raise ValueError(f"unknown optimizer {name!r}")
