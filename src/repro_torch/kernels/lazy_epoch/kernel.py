"""The lazy epoch's wrapper: build, launch plan, argument checks, launch
and launch count of the hand-written CUDA kernel ``csrc/lazy_epoch.cu``,
which runs one lazy sparse CentralVR epoch (``prox/lazy.py``,
``sampling="sparse"``) in one launch.

It replaces no Pallas kernel: the reference runs the epoch as one jitted
``lax.scan``, ``_lazy_epoch`` (``src/repro/prox/lazy.py:215``); this is
its counterpart on the card, as ``vr_epoch`` is the dense epoch's. What
bounds it is the step's serial chain, not bytes (see the source's note):
a step group of threads runs the steps while a look-ahead group catches
the next row up, so the catch-up is off the chain, and entries of value
0 (``sparsify``'s padding) are skipped.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use, from
the package's own source, into ``build/torch_ext/`` (``kernels/build.py``,
``-fmad=false`` among its flags), and loaded with ctypes through its plain
C interface. It takes float64 values and int32 coordinates. Dispatch is
on the tensors' device: CUDA tensors launch the kernel (or raise), CPU
tensors run the plain version (``ref.lazy_epoch_ref``). There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.lazy_epoch import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "lazy_epoch.cu"

# loss kinds, as the kernel numbers them (the base of a "huber@0.5" kind)
LOSS_KINDS = {"logistic": 0, "ridge": 1, "huber": 2, "pseudo_huber": 3}
MAX_THREADS = 128         # a group's threads at most (the block: 256)
ENTRIES = (1, 2, 4, 8)    # entries a thread, as the kernel is built
MAX_WIDTH = MAX_THREADS * ENTRIES[-1]
# the timing probes: each step stops after this phase ("passes": no step,
# the two passes over d alone; "copies": the look-ahead's copies of the
# coming rows and their state; "load": and the membership of the last
# two rows); the epoch itself is FULL
PROBES = {"passes": 0, "copies": 1, "load": 2, "catch-up": 3,
          "reduction": 4}
FULL = 5

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
        ptr, i64, f64, i32 = (ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_double, ctypes.c_int)
        lib.lazy_epoch_f64.argtypes = ([i32] + [ptr] * 11 + [i64] * 4
                                       + [f64] * 2 + [i32] * 2 + [f64]
                                       + [i32] * 2 + [ptr])
        lib.lazy_epoch_f64.restype = i32
        lib.lazy_epoch_floor.argtypes = [ptr, i32, i64, ptr]
        lib.lazy_epoch_floor.restype = i32
        lib.lazy_epoch_error_string.argtypes = [i32]
        lib.lazy_epoch_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class Plan(NamedTuple):
    threads: int        # each group's threads (one block)
    entries: int        # entries of the row a thread


def launch_plan(width: int) -> Plan:
    """One block of 256 threads: a step group and a look-ahead group of
    ``threads`` each (the rest join only the passes over d). Up to width
    128 a thread per entry, rounded up to whole warps (one warp up to width
    32: its reduction needs no barrier). Wider rows: 2, 4 or 8 entries a
    thread over at most 128 threads, up to width 1024, the widest row the
    kernel takes."""
    if width < 1 or width > MAX_WIDTH:
        raise ValueError(f"lazy_epoch: row width {width} is out of the "
                         f"kernel's range [1, {MAX_WIDTH}]")
    need = _cdiv(width, MAX_THREADS)
    entries = next(e for e in ENTRIES if e >= need)
    return Plan(32 * _cdiv(_cdiv(width, entries), 32), entries)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _loss_code(kind: str):
    base, _, tail = kind.partition("@")
    if base not in LOSS_KINDS:
        raise ValueError(f"lazy_epoch: unknown problem kind {kind!r}")
    return LOSS_KINDS[base], float(tail) if tail else 1.0


def _check(idx, val, b, z, table, gbar, perm):
    named = (("idx", idx, torch.int32), ("val", val, torch.float64),
             ("b", b, torch.float64), ("z", z, torch.float64),
             ("table", table, torch.float64), ("gbar", gbar, torch.float64),
             ("perm", perm, torch.int64))
    for name, t, want in named:
        if t.dtype != want:
            raise TypeError(f"lazy_epoch: {name} is {t.dtype}, the kernel "
                            f"takes {want}")
        if t.device != z.device:
            raise ValueError(f"lazy_epoch: {name} is on {t.device}, z on "
                             f"{z.device}")
        if not t.is_contiguous():
            raise ValueError(f"lazy_epoch: {name} is not contiguous")
    if idx.dim() != 2 or 0 in idx.shape:
        raise ValueError(f"lazy_epoch: idx must be (n, width) with n, width "
                         f">= 1, got {tuple(idx.shape)}")
    n, width = idx.shape
    if z.dim() != 1 or z.numel() == 0:
        raise ValueError(f"lazy_epoch: z must be (d,) with d >= 1, got "
                         f"{tuple(z.shape)}")
    d = z.shape[0]
    for name, t, shape in (("val", val, (n, width)), ("b", b, (n,)),
                           ("table", table, (n,)), ("gbar", gbar, (d,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"lazy_epoch: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape} (idx is "
                             f"{tuple(idx.shape)}, z {tuple(z.shape)})")
    if perm.dim() != 1 or perm.shape[0] >= 2**31 - 1:
        raise ValueError(f"lazy_epoch: perm must be (T,) with T < 2**31 - 1,"
                         f" got {tuple(perm.shape)}")
    if max(n, d) >= 2**31 - 1:
        raise ValueError(f"lazy_epoch: n {n} and d {d} must be < 2**31 - 1")


def check_indices(idx, perm, d: int) -> None:
    """Every row index of ``perm`` in [0, n) and every coordinate of
    ``idx`` in [0, d): two syncs on CUDA tensors."""
    for name, t, high in (("perm", perm, idx.shape[0]), ("idx", idx, d)):
        if t.numel():
            lo, hi = (int(v) for v in torch.aminmax(t))
            if lo < 0 or hi >= high:
                raise ValueError(f"lazy_epoch: {name} holds indices in "
                                 f"[{lo}, {hi}], out of range [0, {high})")


def lazy_epoch(idx, val, b, kind: str, z, table, gbar, perm, *, eta: float,
               c: float, vr: bool):
    """One lazy epoch (see ``ref.lazy_epoch_ref`` for the arithmetic),
    one launch on CUDA tensors; returns (z, table, acc), new tensors (the
    inputs are not modified). ``idx`` (n, width) int32, distinct within
    each row; ``val`` (n, width), ``b`` and ``table`` (n,), ``z`` and
    ``gbar`` (d,) float64; ``perm`` (T,) int64. Raises on an index out of
    range, which costs two syncs a call."""
    _check(idx, val, b, z, table, gbar, perm)
    check_indices(idx, perm, z.shape[0])
    return _dispatch(idx, val, b, kind, z, table, gbar, perm, eta=eta, c=c,
                     vr=vr)


def lazy_epoch_in_range(idx, val, b, kind: str, z, table, gbar, perm, *,
                        eta: float, c: float, vr: bool):
    """:func:`lazy_epoch` for indices already known to be in range: every
    other check, and no sync. ``prox.lazy.run_sparse`` checks a run's
    draws once where they come in, and its coordinates come from
    ``sparsify``."""
    _check(idx, val, b, z, table, gbar, perm)
    return _dispatch(idx, val, b, kind, z, table, gbar, perm, eta=eta, c=c,
                     vr=vr)


def _dispatch(idx, val, b, kind, z, table, gbar, perm, *, eta, c, vr):
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    _loss_code(kind)
    if z.device.type == "cpu":
        return ref.lazy_epoch_ref(idx, val, b, kind, z, table, gbar, perm,
                                  eta=eta, c=c, vr=vr)
    if z.device.type != "cuda":
        raise ValueError(f"lazy_epoch runs on CUDA or CPU tensors, got "
                         f"{z.device}")
    if z.device.index != torch.cuda.current_device():
        raise ValueError(f"lazy_epoch: z is on {z.device}, the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    z_out, table_out, acc = (torch.empty_like(z), torch.empty_like(table),
                             torch.empty_like(z))
    last = torch.empty(z.shape, dtype=torch.int32, device=z.device)
    _launch(idx, val, b, kind, z, table, gbar, perm, z_out, table_out, acc,
            last, eta=eta, c=c, vr=vr)
    return z_out, table_out, acc


def _launch(idx, val, b, kind, z, table, gbar, perm, z_out, table_out, acc,
            last, *, eta: float, c: float, vr: bool):
    """One launch on CUDA operands that the wrappers have checked (their
    contract), writing z_out, table_out and acc (last is scratch). Only
    the wrappers above call it, and timing code, which launches back to
    back on buffers it owns."""
    global launches
    _call(FULL, idx, val, b, kind, z, table, gbar, perm, z_out, table_out,
          acc, last, eta=eta, c=c, vr=vr)
    launches += 1


def probe(phase: str, idx, val, b, kind, z, table, gbar, perm, z_out,
          table_out, acc, last, *, eta: float, c: float, vr: bool):
    """Launch the timing probe that ends every step after ``phase`` (a key
    of PROBES) on operands as :func:`_launch` takes them; its outputs are
    not an epoch's. Not a path's kernel: it is not counted. A probe
    writes no ``last``, so its catch-ups span from step 0: they bound the
    epoch's from above. Probes run where d fits the kernel's per-coordinate
    stamps in shared memory (every timed shape); elsewhere they raise."""
    _call(PROBES[phase], idx, val, b, kind, z, table, gbar, perm, z_out,
          table_out, acc, last, eta=eta, c=c, vr=vr)


def serial_floor(threads: int, T: int) -> torch.Tensor:
    """Launch the probe ``lazy_epoch_floor`` on the current CUDA device: T
    steps of the step's serial chain alone (shuffle tree, block barriers,
    the logistic residual, a store) in one block of ``threads``, for
    timing the floor per step. Not counted. Returns its output."""
    out = torch.empty(2 * threads, dtype=torch.float64, device="cuda")
    lib = _load()
    err = lib.lazy_epoch_floor(out.data_ptr(), threads, T,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lazy_epoch_floor: launch failed: "
                           f"{lib.lazy_epoch_error_string(err).decode()}")
    return out


def _call(stop, idx, val, b, kind, z, table, gbar, perm, z_out, table_out,
          acc, last, *, eta, c, vr):
    n, width = idx.shape
    plan = launch_plan(width)
    loss, delta = _loss_code(kind)
    lib = _load()
    err = lib.lazy_epoch_f64(
        stop, idx.data_ptr(), val.data_ptr(), b.data_ptr(), perm.data_ptr(),
        z.data_ptr(), table.data_ptr(), gbar.data_ptr(), z_out.data_ptr(),
        table_out.data_ptr(), acc.data_ptr(), last.data_ptr(), n, width,
        z.shape[0], perm.shape[0], float(eta), float(c), int(bool(vr)),
        loss, delta, plan.threads, plan.entries,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lazy_epoch: launch failed: "
                           f"{lib.lazy_epoch_error_string(err).decode()}")
