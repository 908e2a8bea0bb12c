"""The weights of a dense decoder cell, made from the seed on the device.

The benchmark names its leaves itself (``leaves``) and lays them out in
one flat float32 buffer in that order. Every matrix is drawn normal with
the configuration's ``initializer_range`` as its standard deviation, as
the source's own initialisation draws them; norms' scales start at one,
biases at zero. The buffer is drawn in chunks of ``CHUNK`` elements, each
from a generator of its own seeded from (seed, chunk), so a few large
calls make it and any run makes the same numbers again.

Matrices are stored (in, out): a layer computes ``x @ w``.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 28


def leaves(conf: dict):
    """[(name, shape, init)] of a dense decoder with an untied head, in
    layout order; init is "normal", "ones" or "zeros"."""
    d, ff, V = conf["hidden_size"], conf["intermediate_size"], conf["vocab_size"]
    H, KV = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // H
    out = [("embed", (V, d), "normal")]
    for i in range(conf["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (d,), "ones"),
                (p + "wq", (d, H * hd), "normal"),
                (p + "bq", (H * hd,), "zeros"),
                (p + "wk", (d, KV * hd), "normal"),
                (p + "bk", (KV * hd,), "zeros"),
                (p + "wv", (d, KV * hd), "normal"),
                (p + "bv", (KV * hd,), "zeros"),
                (p + "wo", (H * hd, d), "normal"),
                (p + "mlp_norm", (d,), "ones"),
                (p + "wg", (d, ff), "normal"),
                (p + "wu", (d, ff), "normal"),
                (p + "wd", (ff, d), "normal")]
    out += [("final_norm", (d,), "ones"), ("head", (d, V), "normal")]
    return out


def offsets(conf: dict):
    """{name: (offset, shape)} and the total element count."""
    out, n = {}, 0
    for name, shape, _ in leaves(conf):
        out[name] = (n, shape)
        n += math.prod(shape)
    return out, n


def views(flat: torch.Tensor, conf: dict) -> dict:
    """{name: view of ``flat`` shaped as the leaf}."""
    offs, _ = offsets(conf)
    return {name: flat[o:o + math.prod(s)].view(s)
            for name, (o, s) in offs.items()}


def make(conf: dict, seed: int, device) -> torch.Tensor:
    """The flat float32 weights of ``conf`` drawn from ``seed``."""
    _, n = offsets(conf)
    flat = torch.empty(n, dtype=torch.float32, device=device)
    std = conf["initializer_range"]
    for c, start in enumerate(range(0, n, CHUNK)):
        gen = torch.Generator(device=device).manual_seed(
            (seed * 1_000_003 + c + 1) % 2 ** 63)
        flat[start:start + CHUNK].normal_(0.0, std, generator=gen)
    v = views(flat, conf)
    for name, _, init in leaves(conf):
        if init == "ones":
            v[name].fill_(1.0)
        elif init == "zeros":
            v[name].zero_()
    return flat
