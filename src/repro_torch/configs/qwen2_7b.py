"""Qwen2-7B [arXiv:2407.10671] — dense decoder, GQA (28Q/4KV), QKV bias.
The reference's ``repro/configs/qwen2_7b.py``, number for number."""
from repro_torch.config import ModelConfig, register

QWEN2_7B = register(ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    tie_embeddings=False,
))
