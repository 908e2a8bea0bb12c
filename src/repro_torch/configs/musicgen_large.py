"""MusicGen-large [arXiv:2306.05284] — decoder-only LM over EnCodec tokens.

48 layers, d_model=2048, 32 heads (kv=32 => plain MHA), d_ff=8192 (GELU MLP,
LayerNorm), vocab 2048 (EnCodec codebook size). The EnCodec audio codec is
the STUB frontend: the pipeline supplies codebook token embeddings; the
delay-pattern interleave of the 4 codebooks is applied token-side.
The reference's ``repro/configs/musicgen_large.py``, number for number.
"""
from repro_torch.config import ModelConfig, register

MUSICGEN_LARGE = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    norm_type="layernorm",
    mlp_type="gelu",
    mlp_bias=True,
    frontend="audio",
    frontend_tokens=0,      # conditioning-free (unconditional generation path)
))
