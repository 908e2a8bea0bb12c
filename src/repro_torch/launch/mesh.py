"""Process meshes of the port — the port of ``repro/launch/mesh.py``:
one rank per position of a mesh over ``torch.distributed``, where the
reference puts one device at each position of a ``jax.sharding.Mesh``.

  * :func:`make_worker_mesh` — the rank's :class:`WorkerGroup` in the
    default process group (one initialised by :func:`spawn_workers`, or
    joined from ``torchrun``'s environment): the 1-D worker mesh of the
    spmd backend;
  * :func:`make_mesh`, :func:`make_production_mesh`,
    :func:`make_test_mesh` — the 2-D (data, model) and 3-D (pod, data,
    model) meshes of the sharded train step (:class:`ProcessMesh`): the
    rank's coordinates, and one :class:`WorkerGroup` per axis (its row
    and its column) and over (pod, data);
  * :func:`stand_in_mesh` — one rank's view of a mesh of any shape on
    ``torch.device("meta")``, with groups that record their collectives
    instead of communicating (``core/spmd.py``): the dry run's mesh,
    which needs no world;
  * :func:`spawn_workers` — starts p ranks on this host, runs a function
    in each, returns every rank's result and re-raises a rank's failure;
  * :func:`pick_transport` — the rule that chooses the collectives'
    transport: NCCL when every rank has a card of its own, else gloo
    (NCCL refuses two ranks on one device), which on CUDA tensors goes
    through host memory (``core/spmd.py`` stages them in the open).

A rank's device is ``cuda:(local_rank % device_count)``, or the CPU when
the caller asks for it (the tests).
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

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
    convention); ``core/spmd.py`` adds to them. A stand-in group
    (``transport="record"``, :func:`stand_in_mesh`) also logs each
    collective in ``log`` as ``(kind, shape, dtype, bytes)``."""

    rank: int
    world: int
    group: Any
    device: torch.device
    transport: str
    carried_bytes: int = 0
    collectives: int = 0
    log: list = field(default_factory=list)


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


# ---------------------------------------------------------------------------
# The 2-D and 3-D meshes of the sharded train step
# ---------------------------------------------------------------------------

# the axes whose every combination a mesh builds a group for: each axis
# alone, and (pod, data), the worker axes of vr_workers="data" on a pod mesh
_GROUP_AXES = (("pod", "data"),)


@dataclass
class ProcessMesh:
    """One rank's view of a mesh of ranks: the axis names and sizes, the
    rank's coordinates (row-major over the axes, as ``jax.make_mesh``
    lays devices out), its device, the transport, and one
    :class:`WorkerGroup` per axis and per combination the train step
    reduces over (``groups``, keyed by a tuple of axis names in mesh
    order). A group of size 1 has no process group and its collectives
    do nothing."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    world: int
    coords: Tuple[int, ...]
    device: torch.device
    transport: str
    groups: Dict[Tuple[str, ...], WorkerGroup]

    @property
    def size(self) -> int:
        return self.world

    def axes(self, names) -> Tuple[str, ...]:
        """``names`` (an axis, or axes) that the mesh has, in mesh order."""
        if isinstance(names, str):
            names = (names,)
        return tuple(a for a in self.axis_names if a in names)

    def group(self, names) -> WorkerGroup:
        """The rank's group over the axes ``names`` (those of them that the
        mesh has; none gives a group of one)."""
        key = self.axes(names)
        if not key:
            return self.groups[()]
        return self.groups[key]

    def index(self, names) -> int:
        """The rank's row-major index over the axes ``names``."""
        i = 0
        for a in self.axes(names):
            k = self.axis_names.index(a)
            i = i * self.shape[k] + self.coords[k]
        return i

    def count(self, names) -> int:
        n = 1
        for a in self.axes(names):
            n *= self.shape[self.axis_names.index(a)]
        return n

    @property
    def carried_bytes(self) -> int:
        return sum(g.carried_bytes for g in self.groups.values())

    @property
    def collectives(self) -> int:
        return sum(g.collectives for g in self.groups.values())


def unravel(q: int, shape) -> Tuple[int, ...]:
    """The coordinates of rank ``q`` on a mesh of ``shape`` (row-major)."""
    coords = []
    for s in reversed(tuple(shape)):
        coords.append(q % s)
        q //= s
    return tuple(reversed(coords))


def _world_size() -> int:
    """The world of the default process group, or of ``torchrun``'s
    environment, else 1."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def _build_mesh(shape, axis_names, *, transport: str = "auto",
                device=None) -> ProcessMesh:
    """This rank's :class:`ProcessMesh` of ``shape`` over the default
    process group (joined from ``torchrun``'s environment when there is
    none yet). A world of one needs no process group."""
    import itertools

    import torch.distributed as dist

    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ "
                         "in length")
    n = 1
    for s in shape:
        n *= s
    world = _world_size()
    if world != n:
        raise ValueError(
            f"a mesh of shape {dict(zip(axis_names, shape))} needs {n} "
            f"ranks, one at each position; this world has {world}")
    if world == 1:
        rank = 0
        dev = torch.device(device) if device is not None else None
        if dev is None:
            from repro_torch.kernels import resolve_device
            dev = resolve_device(None, "repro_torch.launch.mesh")
        have = pick_transport(transport, dev, 1)
    else:
        if not dist.is_initialized():
            make_worker_mesh(world, transport=transport, device=device)
        rank = dist.get_rank()
        dev = rank_device(rank, device)
        have = dist.get_backend()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    coords = unravel(rank, shape)

    def solo():
        return WorkerGroup(rank=0, world=1, group=None, device=dev,
                           transport=have)

    keys = _group_keys(axis_names)
    groups = {(): solo()}
    # every axis at once: the whole world, in rank order
    groups[axis_names] = (solo() if world == 1 else WorkerGroup(
        rank=rank, world=world, group=dist.group.WORLD, device=dev,
        transport=have))
    for key in keys:
        if key in groups:
            continue
        dims = [axis_names.index(a) for a in key]
        size = 1
        for d in dims:
            size *= shape[d]
        if size == 1:
            groups[key] = solo()
            continue
        others = [range(s) if i not in dims else [None]
                  for i, s in enumerate(shape)]
        # every rank creates every group, in the same order
        for fixed in itertools.product(*others):
            members = []
            for inner in itertools.product(*(range(shape[d]) for d in dims)):
                c = list(fixed)
                for d, v in zip(dims, inner):
                    c[d] = v
                q = 0
                for i, s in enumerate(shape):
                    q = q * s + c[i]
                members.append(q)
            pg = dist.new_group(members)
            if rank in members:
                groups[key] = WorkerGroup(rank=members.index(rank),
                                          world=size, group=pg, device=dev,
                                          transport=have)
    return ProcessMesh(axis_names=axis_names, shape=shape, rank=rank,
                       world=world, coords=coords, device=dev,
                       transport=have, groups=groups)


def _group_keys(axis_names) -> list:
    """The keys of the groups a mesh over ``axis_names`` holds besides
    ``()`` and the whole world: each axis alone, and each combination of
    ``_GROUP_AXES`` whose axes it has."""
    return [(a,) for a in axis_names] + [
        k for k in _GROUP_AXES if all(a in axis_names for a in k)]


def stand_in_mesh(shape, axis_names, rank: int = 0) -> ProcessMesh:
    """Rank ``rank``'s :class:`ProcessMesh` of ``shape`` on
    ``torch.device("meta")``, without a world: every group that
    :func:`_build_mesh` makes, of the same size and with the rank's place
    in it, but of ``transport="record"``, so that ``core/spmd.py``'s
    collectives count and log what they would carry and communicate
    nothing. The production shapes (16, 16) and (2, 16, 16) come without
    256 or 512 ranks; the tensors of a program run on it are meta
    tensors (``launch/dryrun.py``)."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ "
                         "in length")
    world = 1
    for s in shape:
        world *= s
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not on a mesh of {world} ranks")
    dev = torch.device("meta")
    coords = unravel(rank, shape)

    def group(dims):
        size, i = 1, 0
        for d in dims:
            size *= shape[d]
            i = i * shape[d] + coords[d]
        return WorkerGroup(rank=i, world=size, group=None, device=dev,
                           transport="record")

    groups = {(): group(())}
    groups[axis_names] = group(range(len(shape)))
    for key in _group_keys(axis_names):
        if key not in groups:
            groups[key] = group([axis_names.index(a) for a in key])
    return ProcessMesh(axis_names=axis_names, shape=shape, rank=rank,
                       world=world, coords=coords, device=dev,
                       transport="record", groups=groups)


def make_production_mesh(*, multi_pod: bool = False, transport: str = "auto",
                         device=None) -> ProcessMesh:
    """The target deployment: (data 16, model 16) = 256 ranks, one a
    card; two pods add a leading 'pod' axis = 512. Raises on any other
    world, naming the one it needs — never a smaller mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = _world_size()
    if world != need:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}): the production "
            f"mesh {dict(zip(axes, shape))} needs a world of {need} ranks, "
            f"one a card; this world has {world} (ROADMAP.md, queue 3: the "
            "production meshes have not run)")
    return _build_mesh(shape, axes, transport=transport, device=device)


def make_mesh(cfg, *, transport: str = "auto", device=None) -> ProcessMesh:
    """The mesh of a ``config.MeshConfig``."""
    return _build_mesh(cfg.shape, cfg.axis_names, transport=transport,
                       device=device)


def make_test_mesh(devices: Optional[int] = None, model_axis: int = 2, *,
                   transport: str = "auto", device=None) -> ProcessMesh:
    """Small (data, model) mesh over the world's ranks: ``model_axis``
    wide when it divides a world above one rank, else (n, 1); a world of
    one rank is the (1, 1) mesh on the rank's device."""
    world = _world_size()
    n = devices or world
    if n != world:
        raise ValueError(f"make_test_mesh(devices={devices}): this world "
                         f"has {world} ranks")
    model = model_axis if n % model_axis == 0 and n > 1 else 1
    return _build_mesh((n // model, model), ("data", "model"),
                       transport=transport, device=device)


def mesh_axis_sizes(mesh) -> dict:
    if isinstance(mesh, ProcessMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return {"workers": mesh.world}


def worker_axes(mesh, vr_workers: str) -> Tuple[str, ...]:
    """Which axes carry CentralVR worker copies.

    On a :class:`ProcessMesh`: 'data' — one worker per data-axis group
    (params replicated along these axes), 'pod' included when present;
    'pod' — workers across pods, FSDP inside; 'none' — plain
    data-parallel. On a 1-D :class:`WorkerGroup`: its one worker axis for
    'data', none for 'none' and 'pod' (a 1-D group has no pod axis)."""
    if not isinstance(mesh, ProcessMesh):
        if vr_workers == "data":
            return ("workers",)
        if vr_workers in ("none", "pod"):
            return ()
        raise ValueError(vr_workers)
    names = mesh.axis_names
    if vr_workers == "none":
        return ()
    if vr_workers == "pod":
        return ("pod",) if "pod" in names else ()
    if vr_workers == "data":
        return tuple(a for a in ("pod", "data") if a in names)
    raise ValueError(vr_workers)


def worker_count(mesh, vr_workers: str) -> int:
    if not isinstance(mesh, ProcessMesh):
        return mesh.world if worker_axes(mesh, vr_workers) else 1
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in worker_axes(mesh, vr_workers):
        n *= sizes[a]
    return max(n, 1)


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
