"""InternVL2-26B [arXiv:2404.16821] — VLM: InternViT-6B frontend (STUB) +
InternLM2-20B language decoder (48L, d=6144, 48Q/8KV GQA, d_ff=16384).

Per the assignment carve-out, the vision encoder is a stub:
``input_specs()``/the data pipeline provide pre-computed patch embeddings of
shape (batch, frontend_tokens, d_model); the decoder we implement consumes
them interleaved before the text tokens.
The reference's ``repro/configs/internvl2_26b.py``, number for number.
"""
from repro_torch.config import ModelConfig, register

INTERNVL2_26B = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    qkv_bias=False,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    frontend="vision",
    frontend_tokens=256,   # 256 visual tokens per image tile (InternVL2 pixel-shuffle)
))
