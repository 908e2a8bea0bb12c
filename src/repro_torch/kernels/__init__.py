"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``), which the wrapper runs for tensors on the CPU:

  vr_update/        K1, fused CentralVR/SAGA update; replaces the Pallas
                    kernel ``repro/kernels/vr_update/kernel.py``: per step
                    (``kernel.py``, the LM's) and per epoch of the convex
                    paths (``epoch.py``, ``csrc/vr_epoch.cu``)
  rmsnorm/          K2, fused RMSNorm; replaces
                    ``repro/kernels/rmsnorm/kernel.py``
  flash_attention/  K3, causal GQA flash attention, forward; replaces
                    ``repro/kernels/flash_attention/kernel.py``
  ssd_scan/         K4, Mamba2 SSD chunk scan, forward; replaces
                    ``repro/kernels/ssd_scan/kernel.py``
  lazy_epoch/       one lazy sparse CentralVR epoch (``prox/lazy.py``);
                    replaces no Pallas kernel: the counterpart of the
                    reference's jitted scan ``_lazy_epoch``

All five are CUDA C++ for sm_90a, built by ``build.py``. As in the
reference, ``ssd_scan`` (the model-layout entry) is exported here lazily.
``resolve_fused()`` is the one place that turns a ``fused=`` flag into a
decision, so every caller agrees on the dispatch, and
``resolve_device()`` the one place that picks an entry point's device.
"""
from __future__ import annotations

import torch

_LAZY = {"ssd_scan": ("repro_torch.kernels.ssd_scan.kernel", "ssd_scan")}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib
    return getattr(importlib.import_module(mod_name), attr)


def has_kernel_support(device) -> bool:
    """True on a CUDA device of compute capability 9.0 (Hopper), the one
    target the kernels are compiled for."""
    device = torch.device(device)
    return (device.type == "cuda"
            and torch.cuda.get_device_capability(device) == (9, 0))


def resolve_fused(flag, device) -> bool:
    """Resolve a ``fused=True|False|"auto"`` flag for runs on ``device``.

    * True   -> the kernel path: on a CUDA tensor the wrapper launches the
                hand-written kernel (or raises); on a CPU tensor it runs
                the kernel's plain version, the counterpart of the
                reference's Pallas interpret mode.
    * "auto" -> the kernel path only where it is compiled for the device
                (a Hopper card), else the unfused body.
    * False  -> the unfused body.
    """
    if flag == "auto":
        return has_kernel_support(device)
    if flag is True:
        return True
    if flag is False or flag is None:
        return False
    raise ValueError(f"fused must be True, False or 'auto', got {flag!r}")


def resolve_device(device, caller: str) -> torch.device:
    """``device``, or the current CUDA device when it is None; raises when
    there is no card — never a silent fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller} runs on the CUDA device and found none; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
