"""K2 wrapper: build, argument checks, launch and launch count of the
hand-written CUDA kernel ``csrc/rmsnorm.cu``.

Replaces the Pallas TPU kernel ``_rmsnorm_kernel`` of
``src/repro/kernels/rmsnorm/kernel.py`` (``rmsnorm``). Its bound on an
H100 is bytes: one read of x and one write of y, 2*rows*d*itemsize over
3.35 TB/s — 4.4 us at 1024 x 3584 and 7.5 us at 8192 x 768 in bfloat16.
A row is held in registers as 16-byte vectors by one warp, or by a few
warps of a block when it is wide (:func:`vector_plan` picks the plan), or,
where 16-byte vectors do not fit the row, goes to the row-per-block loop.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/torch_ext/`` (``kernels/build.py``) and loaded with ctypes.
Dispatch is on the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run the plain version of ``ref.py``. There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.rmsnorm import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
# the loop keeps the row in shared memory as float32, beside the block's
# 36 bytes of static shared memory: 48 KB in all without an opt-in
MAX_D = (48 * 1024 - 64) // 4
DTYPES = (torch.float32, torch.bfloat16)
VEC_BYTES = 16
# the vector body's instantiations in csrc/rmsnorm.cu: (16-byte vectors a
# lane holds, warps a row spans)
PLANS = ((1, 1), (2, 1), (4, 1), (4, 2), (4, 4), (4, 8))
WARPS_PER_ROW = sorted({w for _, w in PLANS})

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
        ptr = ctypes.c_void_p
        lib.rmsnorm_launch.argtypes = [ptr, ptr, ptr, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_double,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ptr]
        lib.rmsnorm_launch.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def vector_plan(d: int, itemsize: int, *addresses: int) -> tuple:
    """The launch's path for rows of ``d`` elements of ``itemsize`` bytes
    at these addresses (x, scale, y): the vector body's (vectors a lane
    holds, warps a row spans), one of ``PLANS`` -- the fewest warps that
    hold the row at 4 vectors a lane or fewer, and the fewest vectors that
    cover it -- or (0, 0) for the row-per-block loop, which takes a row
    whose bytes are not a multiple of 16, an address that is not 16-byte
    aligned, or a row wider than 8 warps hold (bf16 beyond 8192
    elements, float32 beyond 4096)."""
    row_bytes = d * itemsize
    if row_bytes % VEC_BYTES or any(a % VEC_BYTES for a in addresses):
        return (0, 0)
    vecs = row_bytes // VEC_BYTES
    wpr = next((w for w in WARPS_PER_ROW if vecs <= 4 * 32 * w), None)
    if wpr is None:
        return (0, 0)
    need = -(-vecs // (32 * wpr))
    return next((v, w) for v, w in PLANS if w == wpr and v >= need)


def check_launch(x, scale) -> None:
    """Raise for what the kernel does not take (the CPU's plain version
    takes any of it): a dtype other than float32 or bfloat16, a
    non-contiguous operand, a width outside 1..MAX_D."""
    d = x.shape[-1]
    if x.dtype not in DTYPES or scale.dtype not in DTYPES:
        raise TypeError(f"rmsnorm: x and scale must be float32 or bfloat16, "
                        f"got {x.dtype} and {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm: d={d} is outside 1..{MAX_D}")


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm of x (..., d) with scale (d,) over the last axis; returns a
    new tensor shaped and typed like x (see ``ref.rmsnorm_ref``)."""
    global launches
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale has shape {tuple(scale.shape)}, "
                         f"expected ({d},)")
    if scale.device != x.device:
        raise ValueError(f"rmsnorm: scale is on {scale.device}, x on "
                         f"{x.device}")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    check_launch(x, scale)
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"rmsnorm: x is on {x.device}, the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    lib = _load()
    vpl, wpr = vector_plan(d, x.element_size(), x.data_ptr(),
                           scale.data_ptr(), y.data_ptr())
    err = lib.rmsnorm_launch(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                             rows, d, eps,
                             int(x.dtype == torch.bfloat16),
                             int(scale.dtype == torch.bfloat16), vpl, wpr,
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm: launch failed: "
                           f"{lib.rmsnorm_error_string(err).decode()}")
    launches += 1
    return y
