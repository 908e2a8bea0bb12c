"""Mamba2-130M [arXiv:2405.21060] — attention-free SSM with SSD blocks.

24 layers, d_model=768, expand=2 (d_inner=1536), d_state=128, head_dim=64
(=> 24 SSD heads), vocab 50280 (GPT-NeoX tokenizer, padded).
The reference's ``repro/configs/mamba2_130m.py``, number for number."""
from repro_torch.config import ModelConfig, register

MAMBA2_130M = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,            # SSD heads = d_inner / ssm_head_dim
    num_kv_heads=24,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    norm_type="rmsnorm",
    tie_embeddings=True,
))
