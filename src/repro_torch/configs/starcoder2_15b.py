"""StarCoder2-15B [arXiv:2402.19173] — dense, GQA (48Q/4KV), RoPE,
LayerNorm + bias, GELU MLP (d_ff=24576), sliding-window-capable (4096).
The reference's ``repro/configs/starcoder2_15b.py``, number for number.
"""
from repro_torch.config import ModelConfig, register

STARCODER2_15B = register(ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=True,
    rope_theta=100_000.0,
    norm_type="layernorm",
    mlp_type="gelu",
    mlp_bias=True,
))
