"""Worker groups of the spmd backend — the port of
``repro/launch/mesh.py``'s ``make_worker_mesh``: one CentralVR worker
per process (rank) over ``torch.distributed``, where the reference puts
one worker on each device of a ``jax.sharding.Mesh``.

  * :func:`make_worker_mesh` — the rank's :class:`WorkerGroup` in the
    default process group (one initialised by :func:`spawn_workers`, or
    joined from ``torchrun``'s environment);
  * :func:`spawn_workers` — starts p ranks on this host, runs a function
    in each, returns every rank's result and re-raises a rank's failure;
  * :func:`pick_transport` — the rule that chooses the collectives'
    transport: NCCL when every rank has a card of its own, else gloo
    (NCCL refuses two ranks on one device), which on CUDA tensors goes
    through host memory (``core/spmd.py`` stages them in the open).

A rank's device is ``cuda:(local_rank % device_count)``, or the CPU when
the caller asks for it (the tests). The reference's 2-D data x model
meshes (``make_production_mesh``, ``make_mesh``, ``MeshConfig``) serve
its sharded train step and are not ported yet (ROADMAP.md queue 1, item
13 (rest)).
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

TRANSPORTS = ("auto", "nccl", "gloo")
# a collective that waits longer than this fails the rank (and the caller)
TIMEOUT_S = 600
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclass
class WorkerGroup:
    """One rank's view of the worker group: its rank and the world size,
    the process group, the rank's device and the collectives' transport.
    ``carried_bytes`` and ``collectives`` count what this rank's
    collectives carried (result-shape bytes, ``obs/comms.py``'s
    convention); ``core/spmd.py`` adds to them."""

    rank: int
    world: int
    group: Any
    device: torch.device
    transport: str
    carried_bytes: int = 0
    collectives: int = 0


def local_rank(rank: int) -> int:
    """The rank's index on its host: ``LOCAL_RANK`` under ``torchrun``,
    else the rank (every rank of :func:`spawn_workers` is on this host)."""
    return int(os.environ.get("LOCAL_RANK", rank))


def rank_device(rank: int, device=None) -> torch.device:
    """``cuda:(local_rank % device_count)``, or ``device`` when given
    (``"cpu"`` for the CPU tests). Raises without a card unless asked for
    the CPU: a rank never computes on the CPU by accident."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the spmd backend runs each rank on a CUDA device and found "
            "none; pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank(rank) % torch.cuda.device_count())


def pick_transport(transport: str, device: torch.device, world: int) -> str:
    """The collectives' transport for ``world`` ranks on ``device``'s kind.

    ``"auto"``: NCCL when every rank of this host has a card of its own,
    else gloo. ``"nccl"`` on shared cards or on the CPU raises (NCCL
    refuses two ranks on one device, and takes no CPU tensors);
    ``"gloo"`` is always valid."""
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}: expected one "
                         f"of {TRANSPORTS}")
    device = torch.device(device)
    if device.type != "cuda":
        if transport == "nccl":
            raise ValueError(
                f"transport='nccl' needs a CUDA device per rank; the ranks "
                f"run on {device.type}: use transport='gloo' or 'auto'")
        return "gloo"
    ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count()
    own = ranks_here <= cards
    if transport == "nccl" and not own:
        raise ValueError(
            f"transport='nccl' needs a card per rank: {ranks_here} ranks "
            f"share {cards} card(s), and NCCL refuses two ranks on one "
            "device; use transport='gloo' or 'auto'")
    if transport == "auto":
        return "nccl" if own else "gloo"
    return transport


def _init(rank: int, world: int, dev: torch.device, transport: str,
          **kw) -> None:
    """Initialise the default process group with the rule's transport;
    NCCL is told the rank's device (it would guess it from the rank)."""
    import torch.distributed as dist

    backend = pick_transport(transport, dev, world)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **kw)


def check_world(world: int, p: int) -> None:
    """The reference's ``spmd._check_mesh`` refusal."""
    if world != p:
        raise ValueError(
            f"mesh has {world} devices but the problem has {p} workers; "
            "the spmd backend places exactly one worker per mesh device")


def make_worker_mesh(p: int, *, transport: str = "auto",
                     device=None) -> WorkerGroup:
    """This rank's :class:`WorkerGroup` of p workers, one a rank.

    Uses the default process group: the one :func:`spawn_workers`
    initialises, or, under ``torchrun`` (its RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT in the environment), joins one with the
    transport :func:`pick_transport` chooses. Raises when there is none,
    when its world size is not p, and when its backend is not the
    transport the rule (or the caller) chooses — never a silent swap.
    Sets the rank's CUDA device as the current one."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if not all(k in os.environ for k in _TORCHRUN_ENV):
            raise RuntimeError(
                "make_worker_mesh: no torch.distributed process group is "
                "initialised. Start the ranks with "
                "repro_torch.launch.mesh.spawn_workers(p, fn, ...), or run "
                "the program under torchrun (torchrun --nproc-per-node p "
                "...), whose ranks make_worker_mesh joins")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        _init(rank, world, rank_device(rank, device), transport)
    rank, world = dist.get_rank(), dist.get_world_size()
    check_world(world, p)
    dev = rank_device(rank, device)
    want = pick_transport(transport, dev, world)
    have = dist.get_backend()
    if have != want:
        raise ValueError(
            f"the default process group runs {have!r}, but {world} ranks on "
            f"{dev.type} devices take {want!r} (transport={transport!r}: "
            "NCCL when every rank has a card of its own, else gloo)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return WorkerGroup(rank=rank, world=world, group=dist.group.WORLD,
                       device=dev, transport=have)


def worker_axes(group: WorkerGroup, vr_workers: str) -> Tuple[str, ...]:
    """Which axes carry CentralVR worker copies: the group's one worker
    axis for ``"data"`` (the paper's layout), none for ``"none"`` (plain
    data parallel) and ``"pod"`` (a 1-D group has no pod axis)."""
    if vr_workers == "data":
        return ("workers",)
    if vr_workers in ("none", "pod"):
        return ()
    raise ValueError(vr_workers)


def worker_count(group: WorkerGroup, vr_workers: str) -> int:
    return group.world if worker_axes(group, vr_workers) else 1


# ---------------------------------------------------------------------------
# Spawning p ranks on this host
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, tmp: str, transport: str, device,
               fn, args) -> None:
    """A spawned rank: join the group over the FileStore in ``tmp``, run
    ``fn(group, *args)``, write its result (``torch.save``) or its
    traceback into ``tmp``."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        # every rank is on this host: gloo talks over loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dev = rank_device(rank, device)
        _init(rank, world, dev, transport,
              store=dist.FileStore(os.path.join(tmp, "store"), world))
        group = make_worker_mesh(world, transport=transport, device=dev)
        out = fn(group, *args)
        torch.save(out, os.path.join(tmp, f"result.{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error.{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn_workers(p: int, fn, *args, transport: str = "auto",
                  device=None, timeout: Optional[float] = None) -> list:
    """Start p ranks on this host, each running ``fn(group, *args)`` with
    its :class:`WorkerGroup`; return their results in rank order.

    The ranks are processes of the ``spawn`` start method (CUDA cannot
    fork), joined over a ``FileStore`` in a temporary directory, with the
    transport of :func:`pick_transport`. ``fn`` and ``args`` are pickled,
    so ``fn`` is a module-level function. Each result travels back by
    ``torch.save`` and is loaded onto the CPU. When a rank fails, the
    other ranks are stopped and its traceback is raised here; so is a
    run longer than ``timeout`` seconds."""
    import multiprocessing

    if p < 1:
        raise ValueError(f"spawn_workers: need p >= 1, got {p}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, p, tmp, transport, device, fn, args),
                             daemon=True) for r in range(p)]
        for proc in procs:
            proc.start()
        t0 = time.monotonic()
        failed = None
        try:
            while any(proc.is_alive() for proc in procs):
                failed = next((r for r, proc in enumerate(procs)
                               if proc.exitcode not in (None, 0)), None)
                if failed is not None:
                    break
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise TimeoutError(f"spawn_workers: the {p} ranks ran "
                                       f"past {timeout} s")
                time.sleep(0.02)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.terminate()
            for proc in procs:
                proc.join()
        if failed is None:
            failed = next((r for r, proc in enumerate(procs)
                           if proc.exitcode != 0), None)
        if failed is not None:
            err = os.path.join(tmp, f"error.{failed}.txt")
            why = (open(err).read() if os.path.exists(err)
                   else f"exit code {procs[failed].exitcode}")
            raise RuntimeError(f"spawn_workers: rank {failed} of {p} "
                               f"failed:\n{why}")
        return [torch.load(os.path.join(tmp, f"result.{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(p)]
