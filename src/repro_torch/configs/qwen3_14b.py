"""Qwen3-14B [hf:Qwen/Qwen3-8B family card] — dense, GQA (40Q/8KV), qk_norm,
no QKV bias, head_dim=128.
The reference's ``repro/configs/qwen3_14b.py``, number for number.
"""
from repro_torch.config import ModelConfig, register

QWEN3_14B = register(ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qkv_bias=False,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
))
