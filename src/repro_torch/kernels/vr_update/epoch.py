"""K1's epoch route: build, launch plan, argument checks, launch and
launch count of the hand-written CUDA kernel ``csrc/vr_epoch.cu``, which
runs a whole fused VR epoch of p workers in one launch.

It replaces, on the convex paths, the per-step loop of launches around
the Pallas TPU kernel ``_vr_update_kernel`` of
``src/repro/kernels/vr_update/kernel.py`` (``vr_update_flat``), which the
reference runs as one jitted ``lax.scan`` per epoch
(``src/repro/core/fused.py``). ``core/fused.py``'s ``centralvr_epoch``,
``saga_steps`` and ``svrg_steps`` are each one :func:`vr_epoch_in_range`
call (the drivers range-check a run's draws once). The per-step kernel
(``kernel.py``) stays for the LM steps.

What bounds it on an H100: its bytes are each visited row once (320 MB
an epoch at p 8, n = T = 5000, d 1000: 95.5 us at 3.35 TB/s), but a
worker's steps form a serial chain, one block barrier, a 5-level shuffle
tree and one float64 exp a step at least; at d 20 and 90 that chain sets
the pace (see the source's note). :func:`launch_plan` picks the threads
of a worker's block and where the state lives.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use, from
the package's own source, into ``build/torch_ext/`` (``kernels/build.py``,
the flags of ``kernel.py``, ``-fmad=false`` among them), and loaded with
ctypes through its plain C interface. It takes float64, the convex
path's dtype. Dispatch is on the tensors' device: CUDA tensors launch the
kernel (or raise), CPU tensors run the plain version
(``ref.vr_epoch_ref``, a loop over K1's plain version). There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.vr_update import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "vr_epoch.cu"

# loss kinds, as the kernel numbers them (the base of a "huber@0.5" kind)
LOSS_KINDS = {"logistic": 0, "ridge": 1, "huber": 2, "pseudo_huber": 3}
SMEM_BYTES = 232448         # shared memory a block may use on an H100
FIXED_BYTES = 512           # 2 x 32 warp partials
STAGES = 4                  # ring slots of rows in shared memory
MAX_REG_THREADS = 512       # threads of a block with the state in registers
ONE_COORD_MAX_D = 256       # up to here a thread owns one coordinate
COORDS = (1, 2, 4, 8)       # coordinates a thread, as the kernel is built

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
        lib.vr_epoch_f64.argtypes = ([i32] + [ptr] * 8 + [i64] * 4
                                     + [f64] * 3 + [i32] + [f64] * 2 + [i32]
                                     + [f64] + [i32] * 2 + [ptr])
        lib.vr_epoch_f64.restype = i32
        lib.vr_epoch_floor.argtypes = [ptr, i64, i32, i64, ptr]
        lib.vr_epoch_floor.restype = i32
        lib.vr_epoch_error_string.argtypes = [i32]
        lib.vr_epoch_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class Plan(NamedTuple):
    workers: int        # the grid: one block per worker
    threads: int        # a block's threads
    coords: int         # coordinates a thread (0: state in global memory)
    on_chip: bool       # x, gbar and acc in registers, rows in the ring
    smem_bytes: int     # dynamic shared memory of a block


def launch_plan(p: int, d: int) -> Plan:
    """One block per worker. Threads: up to d = 256 one coordinate a
    thread, rounded up to whole warps (one warp up to d = 32, where the
    step's reduction needs no block barrier): a thread's serial work
    costs more than the barrier of a few more warps (on an H100, d 90
    ran faster on 3 warps than on one warp of 4 coordinates a thread).
    Above, 256 threads up to d = 1024 and 512 up to 4096, since every
    warp lengthens the barrier and the sum of the warps' partials (d
    1000 ran no faster on 512 threads than on 256). Each thread keeps the
    state of its coordinates in registers, their count rounded up to one
    the kernel is built for (1, 2, 4, 8); rows come through a ring of 4
    slots in shared memory, each thread copying its own coordinates
    (``cp.async``). Above that capacity (d > 512 * 8 = 4096) the state
    stays in the output buffers in global memory and rows are read there,
    by 1024 threads."""
    if d <= ONE_COORD_MAX_D:
        threads = 32 * -(-d // 32)
    else:
        threads = 256 if d <= 1024 else MAX_REG_THREADS
    need = -(-d // threads)
    if need > COORDS[-1]:
        return Plan(p, 1024, 0, False, FIXED_BYTES)
    coords = next(c for c in COORDS if c >= need)
    return Plan(p, threads, coords, True, FIXED_BYTES + 8 * STAGES * d)


def _check(A, b, orders, x, table, gbar, lane, m, track=False):
    if lane not in ref.LANES:
        raise ValueError(f"vr_epoch: lane must be one of "
                         f"{sorted(ref.LANES)}, got {lane!r}")
    if track and lane != "centralvr":
        raise ValueError(f"vr_epoch: only the centralvr lane tracks its "
                         f"iterates, got lane {lane!r}")
    named = (("A", A), ("b", b), ("orders", orders), ("x", x),
             ("table", table), ("gbar", gbar))
    for name, t in named:
        want = torch.int64 if name == "orders" else torch.float64
        if t.dtype != want:
            raise TypeError(f"vr_epoch: {name} is {t.dtype}, the kernel "
                            f"takes {want}")
        if t.device != x.device:
            raise ValueError(f"vr_epoch: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"vr_epoch: {name} is not contiguous")
    if A.dim() != 3 or 0 in A.shape:
        raise ValueError(f"vr_epoch: A must be (p, n, d) with p, n, d >= 1, "
                         f"got {tuple(A.shape)}")
    p, n, d = A.shape
    T = orders.shape[-1] if orders.dim() == 2 else -1
    for name, t, shape in (("b", b, (p, n)), ("orders", orders, (p, T)),
                           ("x", x, (p, d)), ("table", table, (p, n)),
                           ("gbar", gbar, (p, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"vr_epoch: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape} (A is {tuple(A.shape)})")
    if m < 1:
        raise ValueError(f"vr_epoch: m must be >= 1, got {m}")


def check_orders(orders, n: int) -> None:
    """Every index in [0, n): one sync on a CUDA tensor."""
    if orders.numel():
        lo, hi = (int(v) for v in torch.aminmax(orders))
        if lo < 0 or hi >= n:
            raise ValueError(f"vr_epoch: orders hold indices in [{lo}, {hi}]"
                             f", out of range for a shard of {n} rows")


def _loss_code(kind: str):
    base, _, tail = kind.partition("@")
    if base not in LOSS_KINDS:
        raise ValueError(f"vr_epoch: unknown problem kind {kind!r}")
    return LOSS_KINDS[base], float(tail) if tail else 1.0


def vr_epoch(A, b, orders, x, table, gbar, *, lane: str, kind: str,
             eta: float, decay: float, m: int, prox=None,
             track: bool = False):
    """A fused VR epoch of p workers, one launch for all of them; returns
    (x', table', gbar', acc) — see ``ref.vr_epoch_ref`` for the arithmetic
    and the lanes. Every operand float64 (``orders`` int64) and contiguous,
    on one device: ``A`` (p, n, d), ``b`` (p, n), ``orders`` (p, T) with
    indices in [0, n), ``x`` and ``gbar`` (p, d), ``table`` (p, n), the
    snapshot residuals for ``lane="svrg"``. ``prox`` is an elementwise
    :class:`repro_torch.prox.operators.ProxSpec` or None; ``decay`` the
    l2 term's multiplier (x*(1 - eta*decay)); ``m`` the 1/m scale of acc
    (centralvr) and of gbar's update (saga). The inputs are not modified.
    ``track`` (centralvr lane only): a fifth output, the (p, T, d)
    iterates before each step, stored by the kernel's tracked
    instantiation in the same launch. Raises on an index out of range,
    which costs one sync a call."""
    _check(A, b, orders, x, table, gbar, lane, m, track)
    check_orders(orders, A.shape[1])
    return _dispatch(A, b, orders, x, table, gbar, lane=lane, kind=kind,
                     eta=eta, decay=decay, m=m, prox=prox, track=track)


def vr_epoch_in_range(A, b, orders, x, table, gbar, *, lane: str,
                      kind: str, eta: float, decay: float, m: int,
                      prox=None, track: bool = False):
    """:func:`vr_epoch` for ``orders`` already known to lie in [0, n): every
    other check, and no sync, so the host can run ahead of the card. The
    convex drivers check each run's draws once where they come in
    (``core/distributed._as_index``) and launch through this."""
    _check(A, b, orders, x, table, gbar, lane, m, track)
    return _dispatch(A, b, orders, x, table, gbar, lane=lane, kind=kind,
                     eta=eta, decay=decay, m=m, prox=prox, track=track)


def _dispatch(A, b, orders, x, table, gbar, *, lane, kind, eta, decay, m,
              prox, track):
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    _loss_code(kind)
    kw = dict(lane=lane, kind=kind, eta=eta, decay=decay, m=m, prox=prox)
    if x.device.type == "cpu":
        return ref.vr_epoch_ref(A, b, orders, x, table, gbar, track=track,
                                **kw)
    if x.device.type != "cuda":
        raise ValueError(f"vr_epoch runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"vr_epoch: x is on {x.device}, the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    x_out = x.clone()
    table_out = table if lane == "svrg" else table.clone()
    gbar_out = gbar.clone() if lane == "saga" else gbar
    acc = torch.empty_like(x) if lane == "centralvr" else None
    if not track:
        _launch(A, b, orders, x_out, table_out, gbar_out, acc, **kw)
        return x_out, table_out, gbar_out, acc
    traj = x.new_empty((x.shape[0], orders.shape[1], x.shape[1]))
    _launch(A, b, orders, x_out, table_out, gbar_out, acc, traj=traj, **kw)
    return x_out, table_out, gbar_out, acc, traj


def _launch(A, b, orders, x, table, gbar, acc, *, lane: str, kind: str,
            eta: float, decay: float, m: int, prox=None, traj=None):
    """One launch on CUDA operands that the wrappers have checked (their
    contract), updating x, table (centralvr, saga), gbar (saga) and acc
    (centralvr; None otherwise) in place, and filling ``traj`` (the
    centralvr lane's tracked instantiation) when it is given. Only the
    wrappers above call it, and timing code, which launches back to back
    on buffers it owns."""
    global launches
    p, n, d = A.shape
    plan = launch_plan(p, d)
    loss, delta = _loss_code(kind)
    prox_kind, c1, c2 = ref.epilogue_constants(prox, eta)
    lib = _load()
    err = lib.vr_epoch_f64(
        ref.LANES[lane], A.data_ptr(), b.data_ptr(), orders.data_ptr(),
        x.data_ptr(), table.data_ptr(), gbar.data_ptr(),
        acc.data_ptr() if acc is not None else None,
        traj.data_ptr() if traj is not None else None, p, n, d,
        orders.shape[1], eta, 1.0 / m, 1.0 - eta * decay, prox_kind, c1, c2,
        loss, delta, plan.threads, plan.coords,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"vr_epoch: launch failed: "
                           f"{lib.vr_epoch_error_string(err).decode()}")
    launches += 1


def serial_floor(workers: int, threads: int, T: int) -> torch.Tensor:
    """Launch the probe ``vr_epoch_floor`` on the current CUDA device: T
    steps of the epoch's serial chain alone (shuffle tree, barrier,
    partial sums, one float64 exp) in ``workers`` blocks of ``threads``,
    for timing the floor per step. Not a path's kernel: it is not
    counted. Returns its (workers,) output."""
    out = torch.empty(workers, dtype=torch.float64, device="cuda")
    lib = _load()
    err = lib.vr_epoch_floor(out.data_ptr(), workers, threads, T,
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"vr_epoch_floor: launch failed: "
                           f"{lib.vr_epoch_error_string(err).decode()}")
    return out
