"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427] — hybrid: RG-LRU recurrent
blocks + local attention, pattern 2 recurrent : 1 local-attn (window 2048).

26 layers, d_model=2560, 10 heads (MQA kv=1, head_dim=256), GeGLU d_ff=7680,
vocab 256000.
The reference's ``repro/configs/recurrentgemma_2b.py``, number for number.
"""
from repro_torch.config import ModelConfig, register

RECURRENTGEMMA_2B = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rec", "rec", "local"),
    local_window=2048,
    rglru_heads=10,
    norm_type="rmsnorm",
    mlp_type="swiglu",      # GeGLU ~ gated MLP; gate activation is gelu in-model
    tie_embeddings=True,
    attn_logit_softcap=None,
))
