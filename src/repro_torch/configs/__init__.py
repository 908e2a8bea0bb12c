"""Problem presets (``paper_convex``) and the model architectures of the
port. Importing this package registers every arch the port runs in
``repro_torch.config``'s registry: ``qwen2-7b`` and ``mamba2-130m`` (the
other archs of the reference are listed in ROADMAP.md)."""
from repro_torch.configs import mamba2_130m, qwen2_7b  # noqa: F401

ASSIGNED_ARCHS = ("qwen2-7b", "mamba2-130m")
