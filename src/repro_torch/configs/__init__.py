"""Problem presets (``paper_convex``) and the model architectures of the
port. Importing this package registers every arch of the reference in
``repro_torch.config``'s registry; ``ASSIGNED_ARCHS`` is the reference's
tuple, in its order."""
from repro_torch.configs import (  # noqa: F401
    internvl2_26b,
    mamba2_130m,
    musicgen_large,
    qwen1_5_110b,
    qwen2_7b,
    qwen2_moe_a2_7b,
    qwen3_14b,
    qwen3_moe_30b_a3b,
    recurrentgemma_2b,
    starcoder2_15b,
)

ASSIGNED_ARCHS = (
    "qwen2-7b",
    "internvl2-26b",
    "mamba2-130m",
    "qwen3-14b",
    "musicgen-large",
    "qwen3-moe-30b-a3b",
    "starcoder2-15b",
    "recurrentgemma-2b",
    "qwen2-moe-a2.7b",
    "qwen1.5-110b",
)
