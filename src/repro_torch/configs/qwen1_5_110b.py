"""Qwen1.5-110B [hf:Qwen/Qwen1.5 family card] — dense flagship: 80L,
d_model=8192, GQA 64Q/8KV, d_ff=49152, QKV bias. The memory-stress arch.
The reference's ``repro/configs/qwen1_5_110b.py``, number for number.
"""
from repro_torch.config import ModelConfig, register

QWEN1_5_110B = register(ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
))
