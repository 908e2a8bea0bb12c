"""K3 wrapper: build, argument checks, launch and launch count of the
hand-written CUDA kernel ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``_flash_kernel`` of
``src/repro/kernels/flash_attention/kernel.py`` (``flash_attention``).
Its bound on an H100 is operations: the causal half of QK^T and PV,
2*2*(S^2/2)*hd*H flops per batch row over 989 TFLOP/s of dense bf16 —
7.6 us at S = 1024, H = 28, hd = 128 (in float32, over 67 TFLOP/s).

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/torch_ext/`` (``kernels/build.py``) and loaded with ctypes. It
takes bfloat16 or float32 q, k, v in the model's layout with head sizes
32, 64, 128 and 256 (every head size of the repo's configs). bfloat16
runs on the tensor cores through wgmma, its tiles loaded by TMA from
tensor maps that the launch encodes over the tensors as they lie;
float32 runs without tensor cores, in full float32. The blocks of query
rows and keys are ``ref.BLOCKS``. Dispatch is on the tensors' device:
CUDA tensors launch the kernel (or raise), CPU tensors run the plain
version of ``ref.py``. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}     # as the source numbers them

# kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(kbuild.build(SOURCE)[0]))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [ptr] * 4 + [i32] * 5 + [
            ctypes.c_double, i32, i32, ptr]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, S, H, hd) and k, v "
                         f"(B, S, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, hd):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={k.shape[2]}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be None or >= 1, "
                         f"got {window}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")


def check_supported(head_dim: int, dtype) -> None:
    """Raise unless the kernel takes this head size and dtype on the card;
    the fused trainer calls it when it is built, so a model the kernel
    does not take is refused before its first step."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention: the kernel takes bfloat16 or "
                        f"float32, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {head_dim} is not one "
                         f"of {HEAD_DIMS}")


def flash_attention(q, k, v, *, window: Optional[int] = None):
    """Causal GQA attention: q (B, S, H, hd), k and v (B, S, KV, hd) ->
    (B, S, H, hd); query head h reads kv head h // (H // KV); scale
    1/sqrt(hd); ``window``: keys with k_pos > q_pos - window only."""
    global launches
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    B, S, H, hd = q.shape
    check_supported(hd, q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: q is on {q.device}, the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _load()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        k.shape[2], hd, 1.0 / math.sqrt(hd), window or 0, DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    launches += 1
    return out
