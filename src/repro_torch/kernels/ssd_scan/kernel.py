"""K4 wrapper: build, argument checks, launch plan, launch and launch count
of the hand-written CUDA kernel ``csrc/ssd_scan.cu``, the Mamba2 SSD chunk
scan.

Replaces the Pallas TPU kernel ``_ssd_kernel`` of
``src/repro/kernels/ssd_scan/kernel.py`` (``ssd_scan``), and its wrapper
``ops.py``. At Mamba2-130M's training shape (B 4, S 2048, H 24, P 64,
N 128, chunk 64) its bound on an H100 is bytes: 109.8 MB in and out, 32.8
us at 3.35 TB/s, against 8.90 GFLOP, 18.0 us at 495 TFLOP/s of TF32 (53.9
us for the three passes of 3xTF32; see the source's note).

The kernel runs the chunks in parallel: one block per (chunk, batch row,
group of heads, 64 columns of P), the products on the tensor cores in
3xTF32, and the state passed from chunk to chunk inside the one launch by
chunk-ordered look-back. :func:`launch_plan` sizes the grid, the head
groups and the scratch: a zeroed ticket and flag per (chunk, row, head,
P tile), and two slots of states per (row, head), allocated in every
call.

Two entries, as the reference has:

* :func:`ssd_scan` — the model layout (the port of ``ops.ssd_scan``):
  x (B, S, H, P), dt (B, S, H), A_log (H,), Bc / Cc (B, S, N) -> y
  (B, S, H, P) float32, from a zero state. It forms ``la = -exp(A_log) dt``
  and ``x dt`` in float32, as ``ops.py`` does; the kernel reads them in
  this layout and zero-fills the chunk past S itself, so nothing is
  transposed or padded in memory.
* :func:`ssd_scan_flat` — the kernel's flat signature: la (BH, S), x
  (BH, S, P), Bc / Cc (B, S, N) -> y (BH, S, P).

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/torch_ext/`` (``kernels/build.py``) and loaded with ctypes. It
takes float32 (every operand: the reference casts everything to
float32), chunks up to 64, state sizes up to 128, and N and P multiples
of 4. Dispatch is on the tensors' device: CUDA tensors launch the kernel
(or raise), CPU tensors run the plain version of ``ref.py``. There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ssd_scan import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
MAX_CHUNK = 64
MAX_STATE = 128
# most heads one block takes (they share the chunk's scores C B^T)
HEADS_PER_BLOCK = 6
P_TILE = 64                 # columns of P per block (kPT in the source)

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
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ssd_scan_launch.argtypes = ([ptr] * 7 + [i32] * 7 + [i64] * 6
                                        + [ptr])
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_supported(chunk: int, state: int, head: int) -> None:
    """Raise unless the kernel takes this chunk length, state size and
    head size (it loads rows of B, C and x 16 bytes at a time); the fused
    trainer calls it when it is built."""
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} is not in 1..{MAX_CHUNK}")
    if not 1 <= state <= MAX_STATE or state % 4:
        raise ValueError(f"ssd_scan: state size {state} is not a multiple "
                         f"of 4 in 1..{MAX_STATE}")
    if head % 4:
        raise ValueError(f"ssd_scan: head size {head} is not a multiple "
                         f"of 4")


def launch_plan(B: int, S: int, H: int, P: int, N: int,
                chunk: int) -> dict:
    """The kernel's grid and scratch: H split into the fewest groups of at
    most ``HEADS_PER_BLOCK`` heads, as even as they go (the last may be
    smaller); P in tiles of ``P_TILE``; one block per (chunk, row, head
    group, P tile). ``flags`` is the number of look-back flags (every
    chunk but the last publishes its state per (row, head, P tile)),
    after one ticket counter; ``state_floats`` the scratch of the states
    passed between chunks, which take turns in two slots."""
    chunks = -(-S // chunk)
    heads = -(-H // -(-H // HEADS_PER_BLOCK))
    groups = -(-H // heads)
    p_tiles = -(-P // P_TILE)
    return dict(chunks=chunks, heads_per_block=heads, head_groups=groups,
                p_tiles=p_tiles, blocks=chunks * B * groups * p_tiles,
                flags=(chunks - 1) * B * H * p_tiles,
                state_floats=min(chunks - 1, 2) * B * H * P * N)


def _check_device(*named):
    dev = named[0][1].device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, "
                             f"{named[0][0]} on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, got {dev}")
    return dev


def _launch(la, x, Bc, Cc, y, B, S, H, P, N, chunk, la_strides, x_strides):
    """One launch on CUDA tensors; ``*_strides`` are (batch, head, step)
    element strides of la and x (y is written in x's)."""
    global launches
    named = (("la", la), ("x", x), ("Bc", Bc), ("Cc", Cc))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: the kernel takes float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} must be contiguous and "
                             f"16-byte aligned")
    check_supported(chunk, N, P)
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"ssd_scan: x is on {x.device}, the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    if y.numel() == 0:
        return y
    lib = _load()
    plan = launch_plan(B, S, H, P, N, chunk)
    # the ticket and the flags start at zero in every call (a CUDA graph
    # replays the fill); the states need no fill
    sync = torch.zeros(1 + plan["flags"], dtype=torch.int32, device=x.device)
    states = torch.empty(plan["state_floats"], dtype=torch.float32,
                         device=x.device)
    err = lib.ssd_scan_launch(
        la.data_ptr(), x.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        y.data_ptr(), states.data_ptr(), sync.data_ptr(), B, S, H, P, N,
        chunk, plan["heads_per_block"], *la_strides, *x_strides,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan: launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()}")
    launches += 1
    return y


def ssd_scan_flat(la, x, Bc, Cc, *, chunk: int):
    """la (BH, S), x (BH, S, P), Bc / Cc (B, S, N) with row bh reading
    row bh // (BH // B) of Bc / Cc -> y (BH, S, P) float32."""
    if la.ndim != 2 or x.ndim != 3 or Bc.ndim != 3 or Cc.shape != Bc.shape:
        raise ValueError(f"ssd_scan: la must be (BH, S), x (BH, S, P) and "
                         f"Bc, Cc (B, S, N), got {tuple(la.shape)}, "
                         f"{tuple(x.shape)}, {tuple(Bc.shape)}, "
                         f"{tuple(Cc.shape)}")
    BH, S = la.shape
    B, P, N = Bc.shape[0], x.shape[2], Bc.shape[2]
    if x.shape[:2] != (BH, S) or Bc.shape[1] != S or BH % B:
        raise ValueError(f"ssd_scan: shapes do not agree: la "
                         f"{tuple(la.shape)}, x {tuple(x.shape)}, Bc "
                         f"{tuple(Bc.shape)}")
    dev = _check_device(("la", la), ("x", x), ("Bc", Bc), ("Cc", Cc))
    if dev.type == "cpu":
        return ref.ssd_scan_ref(la, x, Bc, Cc, chunk=chunk)
    H = BH // B
    y = torch.empty_like(x)
    return _launch(la, x, Bc, Cc, y, B, S, H, P, N, chunk,
                   (H * S, S, 1), (H * S * P, S * P, P))


def ssd_scan(x, dt, A_log, Bc, Cc, *, chunk: int = 64):
    """Model-layout entry: x (B, S, H, P), dt (B, S, H), A_log (H,), Bc /
    Cc (B, S, N) -> y (B, S, H, P) float32, from a zero initial state."""
    if x.ndim != 4 or dt.shape != x.shape[:3] or A_log.shape != x.shape[2:3] \
            or Bc.ndim != 3 or Cc.shape != Bc.shape \
            or Bc.shape[:2] != x.shape[:2]:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), dt (B, S, H), "
                         f"A_log (H,) and Bc, Cc (B, S, N), got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A_log.shape)}, {tuple(Bc.shape)}, "
                         f"{tuple(Cc.shape)}")
    dev = _check_device(("x", x), ("dt", dt), ("A_log", A_log), ("Bc", Bc),
                        ("Cc", Cc))
    B, S, H, P = x.shape
    f32 = torch.float32
    dt = dt.to(f32)
    la = -torch.exp(A_log.to(f32))[None, None, :] * dt      # (B, S, H)
    xdt = x.to(f32) * dt[..., None]                         # (B, S, H, P)
    Bc, Cc = Bc.to(f32).contiguous(), Cc.to(f32).contiguous()
    if dev.type == "cpu":
        y = ref.ssd_scan_ref(la.transpose(1, 2).reshape(B * H, S),
                             xdt.transpose(1, 2).reshape(B * H, S, P), Bc,
                             Cc, chunk=chunk)
        return y.reshape(B, H, S, P).transpose(1, 2)
    y = torch.empty_like(xdt)
    return _launch(la, xdt, Bc, Cc, y, B, S, H, P, Bc.shape[2], chunk,
                   (S * H, 1, H), (S * H * P, P, H * P))
