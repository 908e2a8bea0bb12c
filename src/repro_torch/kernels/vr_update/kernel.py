"""K1 wrapper: build, argument checks, launch and launch count of the
hand-written CUDA kernel ``csrc/vr_update.cu``.

Replaces the Pallas TPU kernel ``_vr_update_kernel`` of
``src/repro/kernels/vr_update/kernel.py`` (``vr_update_flat``). Its bound
on an H100 is bytes: 5 reads and 2 writes of the (p, d) batch (x' and
gtilde'; gbar' is a third write only with SAGA), so 7*p*d*itemsize over
3.35 TB/s — 0.134 us at p=8, d=1000 in float64. A launch per inner step
costs far more than that, so the convex epoch loop is launch-bound (see
the source's note).

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use, from the
package's own source, into ``build/torch_ext/`` at the root of the
checkout (``kernels/build.py``), and loaded with ctypes through its plain
C interface (no PyTorch headers, so the build takes seconds).

Dispatch is on the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run the plain version of ``ref.py``. There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.vr_update import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "vr_update.cu"
NVCC_FLAGS = kbuild.NVCC_FLAGS

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
        for fn in (lib.vr_update_f32, lib.vr_update_f64, lib.vr_update_bf16,
                   lib.vr_update_bf16_f32old):
            fn.argtypes = [ptr] * 8 + [ctypes.c_int64] + [ctypes.c_double] * 3 \
                + [ctypes.c_int] * 2 + [ctypes.c_double] * 2 + [ptr]
            fn.restype = ctypes.c_int
        lib.vr_update_error_string.argtypes = [ctypes.c_int]
        lib.vr_update_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


STATE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def grad_dtype(state_dtype):
    """The dtype of the fresh gradient ``g`` for state of ``state_dtype``:
    float32 beside bfloat16 state (the trainer accumulates in float32),
    else the state's own."""
    return torch.float32 if state_dtype == torch.bfloat16 else state_dtype


def _check(x, g, g_old, gbar, gtilde):
    ts = (x, g, g_old, gbar, gtilde)
    names = ("x", "g", "g_old", "gbar", "gtilde")
    if x.dtype not in STATE_DTYPES:
        raise TypeError(f"vr_update: dtype must be float32, float64 or "
                        f"bfloat16, got {x.dtype}")
    gdt = grad_dtype(x.dtype)
    allowed = {"x": (x.dtype,), "gbar": (x.dtype,), "gtilde": (x.dtype,),
               "g": (gdt,), "g_old": (x.dtype, gdt)}
    for name, t in zip(names, ts):
        if t.device != x.device:
            raise ValueError(f"vr_update: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype not in allowed[name]:
            raise TypeError(f"vr_update: {name} is {t.dtype}, x is "
                            f"{x.dtype} (it must be one of "
                            f"{allowed[name]})")
        if t.shape != x.shape:
            raise ValueError(f"vr_update: {name} has shape "
                             f"{tuple(t.shape)}, x {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"vr_update: {name} is not contiguous")


def vr_update(x, g, g_old, gbar, gtilde, *, eta: float, m: int,
              saga: bool = False, decay: float = 0.0, prox=None,
              inplace: bool = False):
    """The fused VR update of a (p, d) batch (any shape, the same for all
    five operands); returns (x', table', gtilde', gbar') — see
    ``ref.vr_update_ref`` for the arithmetic. All five share one dtype
    (float32 or float64), or the state is bfloat16 with a float32 ``g``
    (and ``g_old`` bfloat16 or float32); the arithmetic is then float32.

    ``prox`` is an elementwise :class:`repro_torch.prox.operators.ProxSpec`
    (l1, elasticnet, box) or None. table' is ``g`` itself (table' = g),
    and without SAGA gbar' is ``gbar`` itself (gbar' = gbar); the kernel
    stores neither. ``inplace=True`` writes x', gtilde' (and gbar' with
    SAGA) into ``x``, ``gtilde`` and ``gbar``, so a step allocates
    nothing; otherwise those outputs are new tensors.
    """
    global launches
    _check(x, g, g_old, gbar, gtilde)
    if x.device.type == "cpu":
        xo, tbl, gto, gbo = ref.vr_update_ref(
            x, g, g_old, gbar, gtilde, eta=eta, m=m, saga=saga, decay=decay,
            prox=prox)
        if not inplace:
            return xo, tbl, gto, gbo
        x.copy_(xo)
        gtilde.copy_(gto)
        if gbo is not gbar:
            gbar.copy_(gbo)
        return x, g, gtilde, gbar
    if x.device.type != "cuda":
        raise ValueError(f"vr_update runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"vr_update: x is on {x.device}, the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    if inplace:
        x_out, gtilde_out, gbar_out = x, gtilde, gbar
    else:
        x_out, gtilde_out = torch.empty_like(x), torch.empty_like(gtilde)
        gbar_out = torch.empty_like(gbar) if saga else gbar
    kind, c1, c2 = ref.epilogue_constants(prox, eta)
    lib = _load()
    if x.dtype == torch.bfloat16:
        fn = (lib.vr_update_bf16 if g_old.dtype == torch.bfloat16
              else lib.vr_update_bf16_f32old)
    else:
        fn = (lib.vr_update_f64 if x.dtype == torch.float64
              else lib.vr_update_f32)
    err = fn(x.data_ptr(), g.data_ptr(), g_old.data_ptr(), gbar.data_ptr(),
             gtilde.data_ptr(), x_out.data_ptr(), gtilde_out.data_ptr(),
             gbar_out.data_ptr(), x.numel(),
             eta, 1.0 / m, 1.0 - eta * decay, int(saga), kind, c1, c2,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"vr_update: launch failed: "
                           f"{lib.vr_update_error_string(err).decode()}")
    launches += 1
    return x_out, g, gtilde_out, gbar_out
