"""Operations and bytes of a dense decoder's training step and of its
kernels, from the configuration's shapes.

``step_flops`` is the model's forward and backward work: 6 FLOPs a token
for every matrix parameter a token uses (the head included, the embedding
lookup not), and causal attention's score and value products, 12 FLOPs a
visible (query, key) pair a head dimension a layer. The recompute that
``remat`` adds is not counted.
"""
from __future__ import annotations


def dims(conf: dict):
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    return (d, H, conf["num_key_value_heads"], conf.get("head_dim") or d // H,
            conf["intermediate_size"], conf["vocab_size"],
            conf["num_hidden_layers"])


def matmul_params(conf: dict) -> int:
    d, H, KV, hd, ff, V, L = dims(conf)
    layer = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * ff
    return L * layer + d * V


def pairs(seq: int) -> int:
    """Visible (query, key) pairs of one causal sequence."""
    return seq * (seq + 1) // 2


def step_flops(conf: dict, traffic: dict) -> float:
    d, H, KV, hd, ff, V, L = dims(conf)
    rows = traffic["accum"] * traffic["microbatch"]
    tokens = rows * traffic["seq"]
    attn = 12 * pairs(traffic["seq"]) * H * hd * L * rows
    return 6.0 * matmul_params(conf) * tokens + attn


def k1_bytes(n_params: int, workers: int = 1) -> int:
    """One fused VR step over (W, N) float32 state: x, the table row, gbar,
    gtilde and the fresh gradient read once, x and gtilde written once."""
    return 7 * 4 * n_params * workers


def flash_fwd(seq: int, heads: int, kv_heads: int, head_dim: int,
              batch: int):
    """(FLOPs, bytes) of one causal attention forward in bf16: the score
    and value products over the visible pairs; q, k, v read and the
    output written once."""
    flops = 4 * pairs(seq) * head_dim * heads * batch
    nbytes = 2 * batch * seq * head_dim * (2 * heads + 2 * kv_heads)
    return flops, nbytes
