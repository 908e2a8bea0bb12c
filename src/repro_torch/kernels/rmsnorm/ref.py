"""Plain PyTorch version of the fused RMSNorm — the arithmetic of the
CUDA kernel in ``csrc/rmsnorm.cu`` and of the reference's
``repro/kernels/rmsnorm/ref.py::rmsnorm_ref``, on any device.

The wrapper in ``kernel.py`` runs it for tensors on the CPU; tests hold it
against the reference's oracle and its Pallas kernel in interpret mode,
and ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, *, eps: float = 1e-6):
    """y = x * rsqrt(mean(x^2) + eps) * scale over the last axis, in
    float32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)
            * scale.to(torch.float32)).to(x.dtype)
