"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — MoE: 128 experts, top-8, no shared
expert; GQA 32Q/4KV, qk_norm, head_dim=128, moe_d_ff=768.
The reference's ``repro/configs/qwen3_moe_30b_a3b.py``, number for number.
"""
from repro_torch.config import ModelConfig, register

QWEN3_MOE_30B_A3B = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                # kept for config parity; MoE path uses moe_d_ff
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=768,
    norm_type="rmsnorm",
    mlp_type="swiglu",
))
