"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — MoE: 60 routed experts
top-4 + 4 shared experts (shared intermediate 4x1408=5632) with a shared-
expert gate; 16 heads (kv=16 => MHA), QKV bias.
The reference's ``repro/configs/qwen2_moe_a2_7b.py``, number for number.
"""
from repro_torch.config import ModelConfig, register

QWEN2_MOE_A2_7B = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    num_experts=60,
    num_experts_per_tok=4,
    moe_d_ff=1408,
    shared_expert_d_ff=5632,   # = 4 shared experts x 1408
    shared_expert_gate=True,
    norm_type="rmsnorm",
    mlp_type="swiglu",
))
