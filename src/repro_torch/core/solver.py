"""Unified solver API: ``RunSpec`` -> ``solve`` -> ``RunResult`` — the port
of ``repro/core/solver.py``.

  * :class:`RunSpec` — a frozen description of one run with ALL of the
    reference's cross-field validation, so an invalid combination fails
    before any torch work with the reference's error text.
  * ``FAMILY`` — the capability record of every algorithm of the
    reference's registry (what RunSpec validates against); ``REGISTRY``
    — the same eleven algorithms with their drivers.
  * :class:`RunResult` — the uniform return, with the device it ran on
    and the kernel launches it made.
  * :func:`solve` — runs a spec on the CUDA device, or on the CPU when the
    caller asks for it; ``backend="spmd"`` on this rank's device of a
    worker group (``core/spmd.py``, ``launch/mesh.py``);
    ``topology="process"`` on this process's share of a process fleet
    (``core/procmesh.py``, ``launch/distributed.py``); ``elastic=True``
    under a membership plan (``core/elastic.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["RunSpec", "RunResult", "AlgoCaps", "Algorithm", "FAMILY",
           "REGISTRY", "algorithms", "runner", "solve"]


# ---------------------------------------------------------------------------
# Capability records + registry
# ---------------------------------------------------------------------------

class AlgoCaps(NamedTuple):
    """What an algorithm supports — the validation contract
    :class:`RunSpec` enforces at construction."""

    distributed: bool          # runs on a ShardedProblem (p workers)?
    spmd_ok: bool              # has a backend="spmd" program?
    is_async: bool             # event-scheduled (vs bulk-synchronous)?
    accepts_fetch: bool = False   # fetch="instant"|"stale" discipline?
    accepts_speeds: bool = False  # heterogeneous-speed event schedule?
    accepts_tau: bool = False     # local-step count (inner loop length)?
    accepts_fused: bool = False   # fused vr_epoch kernel hot path?
    accepts_prox: bool = False    # composite objectives (prox= axis)?
    snapshots: Tuple[str, ...] = ()   # supported snapshot= anchors


def _vr(**kw) -> AlgoCaps:
    return AlgoCaps(accepts_fused=True, accepts_prox=True, **kw)


# the reference's algorithm family, in registration (paper) order
FAMILY: dict[str, AlgoCaps] = {
    "centralvr": _vr(distributed=False, spmd_ok=True, is_async=False,
                     snapshots=("last",)),
    "centralvr_sync": _vr(distributed=True, spmd_ok=True, is_async=False,
                          snapshots=("last",)),
    "centralvr_async": _vr(distributed=True, spmd_ok=True, is_async=True,
                           accepts_speeds=True, snapshots=("last",)),
    "dsvrg": _vr(distributed=True, spmd_ok=True, is_async=False,
                 accepts_tau=True, snapshots=("last", "avg", "rand")),
    "dsaga": _vr(distributed=True, spmd_ok=True, is_async=True,
                 accepts_fetch=True, accepts_speeds=True, accepts_tau=True,
                 snapshots=("last",)),
    "sgd": AlgoCaps(distributed=False, spmd_ok=False, is_async=False),
    "svrg": _vr(distributed=False, spmd_ok=False, is_async=False,
                accepts_tau=True, snapshots=("last", "avg", "rand")),
    "saga": _vr(distributed=False, spmd_ok=False, is_async=False,
                snapshots=("last",)),
    "dist_sgd": AlgoCaps(distributed=True, spmd_ok=True, is_async=False,
                         accepts_tau=True),
    "easgd": AlgoCaps(distributed=True, spmd_ok=True, is_async=False,
                      accepts_tau=True),
    "ps_svrg": AlgoCaps(distributed=True, spmd_ok=True, is_async=False),
}


class Algorithm(NamedTuple):
    name: str
    module: str                # dotted module of the public run_* driver
    func: str                  # driver attribute within ``module``
    caps: AlgoCaps
    call: Callable             # (spec, problem, eta, orders, group) ->
                               #   (state, x, rels, grad_evals | None)
    doc: str


REGISTRY: dict[str, Algorithm] = {}


def register(name: str, module: str, func: str, call: Callable,
             doc: str) -> None:
    if name in REGISTRY:
        raise ValueError(f"algorithm {name!r} already registered")
    REGISTRY[name] = Algorithm(name, module, func, FAMILY[name], call, doc)


def algorithms() -> Tuple[str, ...]:
    """Registered algorithm names, in registration (paper) order."""
    return tuple(REGISTRY)


def runner(name: str) -> Callable:
    """Resolve a registry entry to its public ``run_*`` driver."""
    entry = REGISTRY[name]
    return getattr(importlib.import_module(entry.module), entry.func)


# ---------------------------------------------------------------------------
# RunSpec — declarative, frozen, validated at construction
# ---------------------------------------------------------------------------

_SAMPLINGS = ("permutation", "uniform", "sparse")
_DECAY_ALGOS = ("sgd", "dist_sgd", "easgd")
_SNAPSHOTS = ("last", "avg", "rand")


@dataclass(frozen=True)
class RunSpec:
    """One solver run, as data; the fields of ``repro.RunSpec``.

      algo          algorithm name (see ``FAMILY``; ``REGISTRY`` runs)
      p             worker count (1 for single-worker algorithms)
      eta           step size; None -> ``convex.auto_eta`` on the (merged)
                    problem at solve time
      rounds        communication rounds (epochs for Algorithm 1)
      backend       "vmap" (workers as a batch dimension on one device);
                    "spmd" (one worker per process over torch.distributed,
                    ``core/spmd.py``)
      fetch         "instant" | "stale" (D-SAGA); None -> "instant"
      speeds        per-worker relative speeds of the asynchronous event
                    schedule (centralvr_async, dsaga); None -> round-robin
      tau           local-step count (dsvrg, dsaga, svrg's inner loop,
                    dist_sgd, easgd); None -> the algorithm's default
      decay         step-size decay (sgd, dist_sgd, easgd)
      snapshot      SVRG anchor: "last" | "avg" | "rand" (svrg, dsvrg)
      seed          seed of the ``torch.Generator`` that draws data and
                    the run's draws when :func:`solve` is given none
      metric_every  keep every k-th round's rel-grad-norm (plus the final
                    round) in ``RunResult.rels``
      sampling      "permutation" | "uniform" | "sparse" (Algorithm 1
                    only; "sparse" runs the lazy sparse driver,
                    ``prox/lazy.py``, one ``lazy_epoch`` launch an epoch)
      prox          composite objective, ``"l1:0.01"`` etc.
                    (``repro_torch.prox.operators``); stored normalized
      fused         the vr_epoch kernel path: False (unfused body), True
                    (the kernel on a CUDA device, its plain version on the
                    CPU), or "auto" (the kernel on a Hopper card only)
      topology      "local", or "process": this process's share of a
                    process fleet (``core/procmesh.py``; centralvr_sync
                    and centralvr_async, unfused)
      elastic       centralvr_async under a membership plan
                    (``core/elastic.py``; with topology="process" the
                    membership comes from heartbeats)
    """

    algo: str
    p: int = 1
    eta: Optional[float] = None
    rounds: int = 10
    backend: str = "vmap"
    fetch: Optional[str] = None
    speeds: Optional[Tuple[float, ...]] = None
    tau: Optional[int] = None
    seed: int = 0
    metric_every: int = 1
    sampling: str = "permutation"
    decay: float = 0.0
    fused: Any = False
    topology: str = "local"
    elastic: bool = False
    prox: Optional[str] = None
    snapshot: Optional[str] = None

    def __post_init__(self):
        if self.algo not in FAMILY:
            raise ValueError(
                f"RunSpec.algo: unknown algorithm {self.algo!r}; registry "
                f"has {', '.join(FAMILY)}")
        caps = FAMILY[self.algo]
        _set = lambda k, v: object.__setattr__(self, k, v)  # noqa: E731

        # normalize scalar fields so asdict() round-trips exactly
        _set("p", int(self.p))
        _set("rounds", int(self.rounds))
        _set("seed", int(self.seed))
        _set("metric_every", int(self.metric_every))
        if self.eta is not None:
            _set("eta", float(self.eta))
        if self.tau is not None:
            _set("tau", int(self.tau))
        _set("decay", float(self.decay))

        if self.p < 1:
            raise ValueError(f"RunSpec.p: need at least 1 worker, got "
                             f"{self.p}")
        if not caps.distributed and self.p != 1:
            raise ValueError(
                f"RunSpec.p: algorithm {self.algo!r} is single-worker; "
                f"got p={self.p} (use the distributed variants for p>1)")
        if self.rounds < 1:
            raise ValueError(f"RunSpec.rounds: need >= 1, got {self.rounds}")
        if self.metric_every < 1:
            raise ValueError(
                f"RunSpec.metric_every: need >= 1, got {self.metric_every}")
        if self.eta is not None and not self.eta > 0.0:
            raise ValueError(f"RunSpec.eta: need > 0, got {self.eta}")
        if self.tau is not None and self.tau < 1:
            raise ValueError(f"RunSpec.tau: need >= 1, got {self.tau}")

        # fetch discipline (resolved BEFORE the backend check: whether an
        # spmd program exists for D-SAGA depends on the discipline)
        if self.fetch is not None and not caps.accepts_fetch:
            raise ValueError(
                f"RunSpec.fetch: algorithm {self.algo!r} has a single "
                "fetch discipline; only D-SAGA exposes fetch=")
        if caps.accepts_fetch:
            if self.fetch is None:
                _set("fetch",
                     "stale" if self.backend == "spmd" else "instant")
            if self.fetch not in ("instant", "stale"):
                raise ValueError(
                    f"RunSpec.fetch: unknown fetch {self.fetch!r}: "
                    "expected 'instant' or 'stale'")

        # backend — reuse check_backend so the error contracts ("unknown
        # backend", "event-serial") stay the single spelling everywhere
        from repro_torch.core.distributed import check_backend
        try:
            check_backend(self.backend)
        except ValueError as e:
            raise ValueError(f"RunSpec.backend: {e}") from None
        if self.backend == "spmd":
            if not caps.spmd_ok:
                raise NotImplementedError(
                    f"RunSpec.backend: algorithm {self.algo!r} has no SPMD "
                    "program (single-device driver); use backend='vmap'")
            if caps.accepts_fetch and self.fetch == "instant":
                try:
                    check_backend(
                        "spmd", spmd_ok=False,
                        algo=f"{self.algo} with fetch='instant'")
                except NotImplementedError as e:
                    raise NotImplementedError(
                        f"RunSpec.backend: {e}") from None

        # speeds — async event schedules only
        if self.speeds is not None:
            if not caps.accepts_speeds:
                raise ValueError(
                    f"RunSpec.speeds: algorithm {self.algo!r} is "
                    "synchronous — per-worker speeds only weight the "
                    "asynchronous event schedules (centralvr_async, dsaga)")
            speeds = tuple(float(s) for s in self.speeds)
            if len(speeds) != self.p:
                raise ValueError(
                    f"RunSpec.speeds: need one entry per worker "
                    f"(p={self.p}), got {len(speeds)}")
            if any(s <= 0.0 for s in speeds):
                raise ValueError("RunSpec.speeds: speeds must be > 0, got "
                                 f"{speeds}")
            _set("speeds", speeds)

        if self.tau is not None and not caps.accepts_tau:
            raise ValueError(
                f"RunSpec.tau: algorithm {self.algo!r} has no local-step "
                "count (its inner loop is a full epoch)")
        if self.sampling not in _SAMPLINGS:
            raise ValueError(
                f"RunSpec.sampling: unknown sampling {self.sampling!r}: "
                f"expected one of {_SAMPLINGS}")
        if self.sampling != "permutation" and self.algo != "centralvr":
            raise ValueError(
                "RunSpec.sampling: only 'centralvr' (Algorithm 1) exposes "
                "the sampling mode")

        # composite objective (prox=) — parse eagerly so a bad operator
        # string fails here, pre-JAX, naming the field
        if self.prox is not None:
            from repro_torch.prox import operators as proxops
            if not caps.accepts_prox:
                raise ValueError(
                    f"RunSpec.prox: algorithm {self.algo!r} has no VR "
                    "update site to compose a prox into; only the VR "
                    "family (centralvr, centralvr_sync, centralvr_async, "
                    "dsvrg, dsaga, svrg, saga) exposes prox=")
            try:
                _set("prox", proxops.canonical(self.prox))
            except ValueError as e:
                raise ValueError(f"RunSpec.prox: {e}") from None
            if self.fused is True and not proxops.is_elementwise(self.prox):
                raise ValueError(
                    f"RunSpec.fused: prox "
                    f"{proxops.parse(self.prox).name!r} couples "
                    "coordinates, but the fused vr_update epilogue is "
                    "elementwise; use fused=False (or 'auto', which falls "
                    "back to the unfused oracle)")

        # snapshot anchor strategy — capability-gated per algorithm
        if self.snapshot is not None:
            if self.snapshot not in _SNAPSHOTS:
                raise ValueError(
                    f"RunSpec.snapshot: unknown snapshot "
                    f"{self.snapshot!r}: expected one of {_SNAPSHOTS}")
            if not caps.snapshots:
                raise ValueError(
                    f"RunSpec.snapshot: algorithm {self.algo!r} has no VR "
                    "anchor to re-snapshot; only the VR family exposes "
                    "snapshot=")
            if self.snapshot not in caps.snapshots:
                raise ValueError(
                    f"RunSpec.snapshot: algorithm {self.algo!r} supports "
                    f"snapshot in {caps.snapshots}, got {self.snapshot!r} "
                    "(the table-based algorithms maintain their anchor "
                    "incrementally — 'last' only)")
            if self.fused and self.snapshot != "last":
                raise ValueError(
                    "RunSpec.fused: the fused SVRG kernel path anchors at "
                    f"the last iterate; snapshot={self.snapshot!r} "
                    "requires fused=False")

        # sparse lazy driver (Algorithm 1 only; sampling rule above)
        if self.sampling == "sparse":
            if self.backend != "vmap":
                raise ValueError(
                    "RunSpec.backend: sampling='sparse' is the lazy "
                    "host-CSR driver (prox/lazy.py); it has no spmd "
                    "program — use backend='vmap'")
            if self.fused:
                raise ValueError(
                    "RunSpec.fused: sampling='sparse' already skips the "
                    "dense update (lazy catch-up); fused= does not apply")
            if self.prox is not None:
                from repro_torch.prox import operators as proxops
                if proxops.parse(self.prox).name != "l1":
                    raise ValueError(
                        "RunSpec.prox: the lazy sparse driver composes "
                        "skipped steps in closed form only for the "
                        "separable soft-threshold; sampling='sparse' "
                        f"supports prox='l1:...', got {self.prox!r}")
        if self.decay != 0.0 and self.algo not in _DECAY_ALGOS:
            raise ValueError(
                f"RunSpec.decay: step-size decay only applies to "
                f"{_DECAY_ALGOS}, not {self.algo!r}")
        if self.fused is None:
            _set("fused", False)
        if self.fused not in (True, False, "auto"):
            raise ValueError(
                f"RunSpec.fused: expected True, False or 'auto', got "
                f"{self.fused!r}")
        if self.fused and not caps.accepts_fused:
            raise ValueError(
                f"RunSpec.fused: algorithm {self.algo!r} has no VR inner "
                "loop to fuse; only the VR family (centralvr, "
                "centralvr_sync, centralvr_async, dsvrg, dsaga, svrg, "
                "saga) exposes fused=")

        # multi-host topology + elasticity (DESIGN.md §Multi-host &
        # elasticity) — validated before any JAX work, like everything
        # else here, so a bad launch fails in the parent, not the fleet
        if self.topology not in ("local", "process"):
            raise ValueError(
                f"RunSpec.topology: unknown topology {self.topology!r}: "
                "expected 'local' or 'process'")
        _set("elastic", bool(self.elastic))
        if self.topology == "process":
            if self.algo not in ("centralvr_sync", "centralvr_async"):
                raise ValueError(
                    f"RunSpec.topology: algorithm {self.algo!r} has no "
                    "process-mesh program; topology='process' supports "
                    "centralvr_sync and centralvr_async")
            if self.backend != "vmap":
                raise ValueError(
                    "RunSpec.backend: topology='process' runs each "
                    "process's workers as local jitted programs; set "
                    "backend='vmap' (the per-process spmd tier is the "
                    "accelerator path, DESIGN.md §Multi-host & elasticity)")
            if self.fused:
                raise ValueError(
                    "RunSpec.fused: the process-mesh engines pin "
                    "bit-exactness against the unfused event-serial "
                    "reference; fused= is not supported under "
                    "topology='process'")
            if self.prox is not None:
                raise ValueError(
                    "RunSpec.prox: the process-mesh engines run the "
                    "smooth objective only; prox= is not supported under "
                    "topology='process'")
        if self.elastic and self.algo != "centralvr_async":
            raise ValueError(
                f"RunSpec.elastic: only centralvr_async has wave "
                f"boundaries to repartition at; got algo={self.algo!r}")
        if self.elastic and self.prox is not None:
            raise ValueError(
                "RunSpec.prox: the elastic event-serial reference runs "
                "the smooth objective only; prox= is not supported with "
                "elastic=True")


# ---------------------------------------------------------------------------
# RunResult — the uniform return
# ---------------------------------------------------------------------------

@dataclass
class RunResult:
    """What every algorithm returns through :func:`solve`.

    ``spec`` is the *resolved* spec (eta filled in). ``wall_s`` is the
    wall clock of the driver call up to its last result on the host.
    ``launches`` counts the hand-written kernel launches the call made,
    by kernel: ``vr_epoch`` one per fused epoch or inner loop,
    ``lazy_epoch`` one per epoch of the sparse driver (the init epoch
    included), ``vr_update`` (K1's per-step route, the LM's) none (0 on
    the unfused body and on the CPU); under ``backend="spmd"`` this
    rank's. ``device`` names where it ran. ``comms`` is the analytical
    bytes-per-collective model of the run (``obs/comms.py``) at the run's
    element size; under ``backend="spmd"`` also what this rank's
    collectives carried, ``carried_bytes`` (result-shape bytes) in
    ``collectives`` calls. ``staleness`` is the fetch-staleness and
    wave-utilization record of the asynchronous algorithms' event schedule
    (``obs/staleness.py``; None for the bulk-synchronous ones). Under
    ``backend="spmd"`` ``x`` and ``rels`` are replicated and ``state``
    holds this rank's shard of the tables. ``transitions`` are the
    membership changes of an elastic run that took effect (None for a
    run that is not elastic).
    """

    spec: RunSpec
    rels: np.ndarray           # recorded rel-grad-norm trajectory
    x: np.ndarray              # final iterate (d,)
    state: Any                 # the driver's full final state
    wall_s: float
    launches: dict
    device: str
    grad_evals: Optional[np.ndarray] = None
    comms: Optional[dict] = None
    staleness: Optional[dict] = None
    transitions: Optional[list] = None   # elastic membership changes

    @property
    def final_rel(self) -> float:
        return float(self.rels[-1])

    def provenance(self, tail: int = 8) -> dict:
        """JSON-able record of exactly what configuration produced this
        result. The row shape is golden (``obs/schema.py:
        PROVENANCE_KEYS``); extend both together."""
        from repro_torch.obs.recorder import SCHEMA_VERSION

        rels = np.asarray(self.rels, dtype=float)
        return {
            "spec": dataclasses.asdict(self.spec),
            "final_rel": float(rels[-1]) if rels.size else None,
            "rels_tail": [float(v) for v in rels[-tail:]],
            "rounds_recorded": int(rels.size),
            "wall_s": float(self.wall_s),
            "launches": dict(self.launches),
            "device": self.device,
            "comms": dict(self.comms) if self.comms else None,
            "staleness": dict(self.staleness) if self.staleness else None,
            "schema_v": SCHEMA_VERSION,
        }


# ---------------------------------------------------------------------------
# solve
# ---------------------------------------------------------------------------

def _coerce_problem(spec: RunSpec, problem, device: torch.device,
                    place: bool = True):
    """Match the data topology to the algorithm — shard a flat Problem for
    the distributed algorithms, merge a ShardedProblem for the
    single-worker ones, or draw either from a ConvexConfig (a
    ``torch.Generator`` seeded with ``cfg.seed``, on ``device``) — and
    place it on ``device`` (``place=False``: leave a given problem where
    it is; the spmd runners copy only their rank's shard)."""
    from repro_torch.config import ConvexConfig
    from repro_torch.core import convex, distributed

    caps = FAMILY[spec.algo]
    if isinstance(problem, ConvexConfig):
        gen = torch.Generator(device=device).manual_seed(problem.seed)
        if caps.distributed:
            if problem.workers not in (1, spec.p):
                raise ValueError(
                    f"RunSpec.p: spec says p={spec.p} but the ConvexConfig "
                    f"sets workers={problem.workers}; make them agree (or "
                    "leave cfg.workers at its default)")
            cfg = dataclasses.replace(problem, workers=spec.p)
            return distributed.make_distributed(gen, cfg)
        if problem.workers > 1:
            return distributed.make_distributed(gen, problem).merged()
        return convex.make_problem(gen, problem)
    if place and isinstance(problem, (convex.Problem,
                                      distributed.ShardedProblem)):
        problem = problem._replace(A=problem.A.to(device),
                                   b=problem.b.to(device))
    if isinstance(problem, distributed.ShardedProblem):
        if not caps.distributed:
            return problem.merged()
        if problem.p != spec.p:
            raise ValueError(
                f"RunSpec.p: spec says p={spec.p} but the ShardedProblem "
                f"has p={problem.p}")
        return problem
    if isinstance(problem, convex.Problem):
        if caps.distributed:
            return distributed.shard_problem(problem, spec.p)
        return problem
    raise TypeError(
        f"solve() takes a ConvexConfig, Problem, or ShardedProblem; got "
        f"{type(problem).__name__}")


def solve(spec: RunSpec, problem, *, device=None, orders=None,
          group=None, membership=None) -> RunResult:
    """Run ``spec`` against ``problem`` (a ``ConvexConfig``, ``Problem``, or
    ``ShardedProblem``) and return the uniform :class:`RunResult`.

    ``device``: None runs on the current CUDA device and raises when
    there is none — never a silent fall back to the CPU; ``"cpu"`` (or
    any torch device) runs there. ``eta=None`` resolves to
    ``convex.auto_eta`` on the merged problem.

    ``backend="spmd"``: every rank of ``group`` (a
    ``launch.mesh.WorkerGroup`` of ``spec.p`` ranks; default the default
    process group's, ``launch.mesh.make_worker_mesh``) calls ``solve``
    with the same arguments and runs its own worker on its own device
    (Algorithm 1 in a group of one rank). A ``ConvexConfig`` is drawn on
    that device, as the vmap run draws it; a given problem stays where it
    is and each rank copies its own shard.

    ``orders``: the run's draws, as the driver takes them; None draws
    them from a ``torch.Generator`` seeded with ``spec.seed`` on the
    device. ``repro_torch.convert`` replays the reference's draws in
    these layouts (n samples; p workers of ns; R = ``spec.rounds``).
    Every index is checked once to lie in its range, and a fused run of
    the three algorithms with an init epoch refuses init orders that are
    not permutations:

      centralvr        (init (n,), per-epoch (R, n)): permutations (also
                       for ``sampling="sparse"``), or uniform indices
                       with ``sampling="uniform"``
      centralvr_sync   (init (p, ns), per-round (R, p, ns)) permutations
      centralvr_async  (init (p, ns), per-event (R*p, ns)) permutations,
                       event rows in schedule order
      dsvrg            (indices (R, p, tau), anchors (R,) in [0, tau) for
                       ``snapshot="rand"``, else None); tau default 2*ns
      dsaga            indices (R*p, tau), event rows in schedule order;
                       tau default 100
      sgd              per-epoch permutations (R, n)
      svrg             (indices (R, tau), anchors (R,) in [0, tau) for
                       ``snapshot="rand"``, else None); tau default n
      saga             indices (R, n)
      dist_sgd         indices (R, p, tau); tau default ns
      easgd            indices (R, p, max(ns // tau, 1), tau); tau
                       default 16
      ps_svrg          indices (R, 2*ns, p): one per worker per server
                       step

    ``elastic=True`` (centralvr_async) under ``topology="local"`` runs
    the event-serial elastic engine (``core/elastic.py``) under the
    ``membership=`` plan (a ``core.elastic.PlannedMembership``; None keeps
    the full fleet); its orders are ``(init (p, ns), {start round:
    per-event permutations})``, one entry per shape segment.
    ``topology="process"`` runs this process's share of the fleet
    installed by ``launch.distributed`` (``core/procmesh.py``; its
    launcher passes each process ``launch.mesh.rank_device``).
    """
    from repro_torch.core import convex, distributed, runtime
    from repro_torch.kernels import launch_counts, resolve_device
    from repro_torch.obs import comms as obs_comms
    from repro_torch.obs import recorder as obs_recorder
    from repro_torch.obs import staleness as obs_staleness

    entry = REGISTRY[spec.algo]
    if membership is not None and not (spec.elastic
                                       and spec.topology == "local"):
        raise ValueError(
            "solve(membership=...) is the deterministic dropout plan of a "
            "LOCAL elastic run; it needs spec.elastic=True and "
            "spec.topology='local' (process topology discovers membership "
            "through heartbeats)")
    spmd_run = spec.backend == "spmd"
    if spmd_run:
        from repro_torch.core import spmd
        group = spmd._check_group(group, spec.p)
        if device is not None and torch.device(device) != group.device:
            raise ValueError(f"solve: device={device!r}, but this rank of "
                             f"the worker group runs on {group.device}")
        device = group.device
    else:
        if group is not None:
            raise ValueError("solve: group= is the worker group of "
                             "backend='spmd'; this spec runs backend="
                             f"{spec.backend!r}")
        device = resolve_device(device, "repro_torch.solve")
    with obs_recorder.span("solve/build", algo=spec.algo,
                           backend=spec.backend):
        problem = _coerce_problem(spec, problem, device, place=not spmd_run)
        eta = spec.eta
        if eta is None:
            merged = (problem.merged()
                      if isinstance(problem, distributed.ShardedProblem)
                      else problem)
            eta = convex.auto_eta(merged)

    launches0 = launch_counts()
    carried0 = (group.carried_bytes, group.collectives) if spmd_run else None
    t0 = time.perf_counter()
    transitions = None
    if spec.topology == "process":
        from repro_torch.core import procmesh
        state, x, rels, transitions = procmesh.solve_process(
            spec, problem, eta, orders)
        grad_evals = None
    elif spec.elastic:
        from repro_torch.core import elastic
        eres = elastic.run_async_elastic(
            problem, eta=eta, rounds=spec.rounds, seed=spec.seed,
            orders=orders, membership=membership, speeds=spec.speeds,
            fused=spec.fused)
        state, x, rels = eres.state, eres.state.x_c, eres.rels
        transitions, grad_evals = eres.transitions, None
    else:
        state, x, rels, grad_evals = entry.call(spec, problem, eta, orders,
                                                group)
    rels = rels.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = {k: counts[k] - launches0[k]
                for k in ("vr_update", "vr_epoch", "lazy_epoch")}

    if spec.metric_every > 1 and rels.size:
        idx = np.arange(spec.metric_every - 1, rels.size, spec.metric_every)
        idx = np.unique(np.append(idx, rels.size - 1))
        rels = rels[idx]
        if grad_evals is not None:
            grad_evals = grad_evals[idx]
    resolved = dataclasses.replace(spec, eta=float(eta))
    comms = obs_comms.comms_model(spec.algo, p=spec.p, d=int(x.shape[-1]),
                                  rounds=spec.rounds,
                                  bytes_per_el=x.element_size())
    if spmd_run:
        comms["carried_bytes"] = group.carried_bytes - carried0[0]
        comms["collectives"] = group.collectives - carried0[1]
    staleness = None
    if entry.caps.is_async:
        staleness = obs_staleness.staleness_stats(
            runtime.event_schedule(spec.p, spec.rounds, spec.speeds), spec.p)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    res = RunResult(spec=resolved, rels=rels, x=x.cpu().numpy(),
                    state=state, wall_s=wall, launches=launches,
                    device=name, grad_evals=grad_evals, comms=comms,
                    staleness=staleness, transitions=transitions)
    rec = obs_recorder.active()
    if rec is not None:
        rec.event("launches", **launches)
        rec.event("provenance", **res.provenance())
    return res


# ---------------------------------------------------------------------------
# Registry entries — each maps the spec onto one driver's keyword surface
# and normalizes its return to (state, final iterate, rels, grad_evals)
# ---------------------------------------------------------------------------

def _call_centralvr(spec, prob, eta, orders, group):
    from repro_torch.core import centralvr
    st, rels, evals = centralvr.run(prob, eta=eta, epochs=spec.rounds,
                                    orders=orders, seed=spec.seed,
                                    sampling=spec.sampling, fused=spec.fused,
                                    prox=spec.prox,
                                    backend=spec.backend, group=group)
    return st, st.x, rels, evals


def _call_sync(spec, sp, eta, orders, group):
    from repro_torch.core import distributed
    st, rels = distributed.run_sync(sp, eta=eta, rounds=spec.rounds,
                                    orders=orders, seed=spec.seed,
                                    fused=spec.fused, prox=spec.prox,
                                    backend=spec.backend, group=group)
    return st, st.x, rels, None


def _call_async(spec, sp, eta, orders, group):
    from repro_torch.core import distributed
    st, rels = distributed.run_async(sp, eta=eta, rounds=spec.rounds,
                                     orders=orders, seed=spec.seed,
                                     speeds=spec.speeds, fused=spec.fused,
                                     prox=spec.prox,
                                     backend=spec.backend, group=group)
    return st, st.x_c, rels, None


def _call_dsvrg(spec, sp, eta, orders, group):
    from repro_torch.core import distributed
    x, rels = distributed.run_dsvrg(sp, eta=eta, rounds=spec.rounds,
                                    tau=spec.tau or 0, orders=orders,
                                    seed=spec.seed, fused=spec.fused,
                                    prox=spec.prox,
                                    snapshot=spec.snapshot or "last",
                                    backend=spec.backend, group=group)
    return x, x, rels, None


def _call_dsaga(spec, sp, eta, orders, group):
    from repro_torch.core import distributed
    st, rels = distributed.run_dsaga(sp, eta=eta, rounds=spec.rounds,
                                     tau=spec.tau or 100, fetch=spec.fetch,
                                     speeds=spec.speeds, orders=orders,
                                     seed=spec.seed, fused=spec.fused,
                                     prox=spec.prox,
                                     backend=spec.backend, group=group)
    return st, st.x_c, rels, None


def _call_sgd(spec, prob, eta, orders, group):
    from repro_torch.core import baselines
    x, rels = baselines.run_sgd(prob, eta=eta, epochs=spec.rounds,
                                orders=orders, seed=spec.seed,
                                decay=spec.decay)
    return x, x, rels, None


def _call_svrg(spec, prob, eta, orders, group):
    from repro_torch.core import baselines
    x, rels = baselines.run_svrg(prob, eta=eta, epochs=spec.rounds,
                                 inner=spec.tau or 0, orders=orders,
                                 seed=spec.seed, fused=spec.fused,
                                 prox=spec.prox,
                                 snapshot=spec.snapshot or "last")
    return x, x, rels, None


def _call_saga(spec, prob, eta, orders, group):
    from repro_torch.core import baselines
    x, rels = baselines.run_saga(prob, eta=eta, epochs=spec.rounds,
                                 orders=orders, seed=spec.seed,
                                 fused=spec.fused, prox=spec.prox)
    return x, x, rels, None


def _call_dist_sgd(spec, sp, eta, orders, group):
    from repro_torch.core import baselines
    x, rels = baselines.run_dist_sgd(sp, eta=eta, rounds=spec.rounds,
                                     tau=spec.tau or 0, decay=spec.decay,
                                     orders=orders, seed=spec.seed,
                                     backend=spec.backend, group=group)
    return x, x, rels, None


def _call_easgd(spec, sp, eta, orders, group):
    from repro_torch.core import baselines
    xc, rels = baselines.run_easgd(sp, eta=eta, rounds=spec.rounds,
                                   tau=spec.tau or 16, decay=spec.decay,
                                   orders=orders, seed=spec.seed,
                                   backend=spec.backend, group=group)
    return xc, xc, rels, None


def _call_ps_svrg(spec, sp, eta, orders, group):
    from repro_torch.core import baselines
    x, rels = baselines.run_ps_svrg(sp, eta=eta, rounds=spec.rounds,
                                    orders=orders, seed=spec.seed,
                                    backend=spec.backend, group=group)
    return x, x, rels, None


_CORE = "repro_torch.core."
register("centralvr", _CORE + "centralvr", "run", _call_centralvr,
         "CentralVR, single worker (Algorithm 1)")
register("centralvr_sync", _CORE + "distributed", "run_sync", _call_sync,
         "CentralVR-Sync (Algorithm 2)")
register("centralvr_async", _CORE + "distributed", "run_async", _call_async,
         "CentralVR-Async (Algorithm 3), deterministic event schedule")
register("dsvrg", _CORE + "distributed", "run_dsvrg", _call_dsvrg,
         "Distributed SVRG (Algorithm 4)")
register("dsaga", _CORE + "distributed", "run_dsaga", _call_dsaga,
         "Distributed SAGA (Algorithm 5)")
register("sgd", _CORE + "baselines", "run_sgd", _call_sgd,
         "plain SGD, permutation sampling (Fig. 1 baseline)")
register("svrg", _CORE + "baselines", "run_svrg", _call_svrg,
         "SVRG [17]; tau = inner-loop length (default n)")
register("saga", _CORE + "baselines", "run_saga", _call_saga,
         "SAGA [12] (Fig. 1 baseline)")
register("dist_sgd", _CORE + "baselines", "run_dist_sgd", _call_dist_sgd,
         "distributed SGD with periodic averaging")
register("easgd", _CORE + "baselines", "run_easgd", _call_easgd,
         "elastic averaging SGD [36]")
register("ps_svrg", _CORE + "baselines", "run_ps_svrg", _call_ps_svrg,
         "parameter-server SVRG [29]")
