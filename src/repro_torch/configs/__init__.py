"""Problem presets (``paper_convex``) and the model architectures of the
port. Importing this package registers every arch the port runs in
``repro_torch.config``'s registry; so far that is ``qwen2-7b`` (the other
archs of the reference are listed in ROADMAP.md)."""
from repro_torch.configs import qwen2_7b  # noqa: F401

ASSIGNED_ARCHS = ("qwen2-7b",)
