"""Two-tier launcher of the process fleet — the port of
``repro/launch/distributed.py``.

Launcher mode (default): pick a free port for the data plane's store,
spawn ``--nprocs`` child processes of THIS module (each with
``--process-id`` and ``--coordinator`` appended), babysit them under a
hard timeout, and optionally ``--verify`` the fleet's trajectory against
the single-process event-serial run computed in the parent:

    python -m repro_torch.launch.distributed --nprocs 2 --workers 4 \\
        --algo centralvr_async --rounds 6 --x64 --verify --device cpu

Worker mode (``--process-id >= 0``, started by the launcher): join the
store (process 0 hosts its server, ``torch.distributed.TCPStore``; no
process group is initialised), install the process context, and route
the run through ``repro_torch.solve`` with ``topology="process"`` on
``launch.mesh.rank_device`` of the process (``--device`` overrides it,
``cpu`` for the tests). Process 0 writes the results JSON (rels and the
elastic membership transitions); with ``--obs BASE`` each process records
its telemetry to ``BASE-p<i>.jsonl`` (``repro_torch.obs``), the arbiter's
``elastic/heartbeat`` spans and a dropped process's ``fault_exit`` event
among it.

Elastic lanes inject a deterministic fault (``--drop-process`` /
``--drop-round`` / ``--drop-mode exit|stall``); ``--verify`` replays the
transitions process 0 OBSERVED as a ``PlannedMembership`` through the
event-serial elastic engine, so heartbeat detection, repartition, resync
and the trajectory after the drop all have to agree with it. The port's
convex path runs in float64 whatever the flags; ``--x64`` selects the
exact tolerances (0 for the asynchronous algorithm, 1e-12 for the
synchronous one), without it the reference's float32 tolerance.

Workers leave through ``os._exit`` after flushing results and telemetry;
process 0 first waits for every peer's finish flag, since the store's
server dies with it.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

_CTX: Optional["ProcessContext"] = None


@dataclasses.dataclass
class ProcessContext:
    """This process's slice of the world, installed by
    :func:`init_process` and consumed by ``procmesh.solve_process``."""

    comm: object                 # procmesh.ProcComm
    hb_timeout: float = 10.0
    fault: Optional[object] = None   # procmesh.Fault


def context() -> Optional[ProcessContext]:
    return _CTX


def init_process(coordinator: str, num_processes: int, process_id: int, *,
                 prefix: str = "run", hb_timeout: float = 10.0,
                 fault=None) -> ProcessContext:
    """Join the fleet's store at ``coordinator`` (``host:port``; process
    0 serves it) and install the process context. Returns once every
    process has joined (a barrier of ``ready`` flags), as the reference's
    ``jax.distributed.initialize`` does."""
    global _CTX
    import torch.distributed as dist

    from repro_torch.core import procmesh

    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(
        host, int(port), num_processes, process_id == 0,
        timeout=datetime.timedelta(seconds=procmesh.DATA_TIMEOUT_S),
        wait_for_workers=False)
    comm = procmesh.ProcComm(procmesh.StoreKV(store), process_id,
                             num_processes, prefix)
    comm.put_flag(f"ready/{process_id}", {"pid": process_id})
    for q in range(num_processes):
        comm.get_flag(f"ready/{q}", timeout_s=procmesh.DATA_TIMEOUT_S)
    _CTX = ProcessContext(comm=comm, hb_timeout=hb_timeout, fault=fault)
    return _CTX


def set_local_context(nprocs: int = 1, pid: int = 0, *, prefix: str = "run",
                      hb_timeout: float = 10.0, fault=None) -> ProcessContext:
    """Install a LocalKV-backed context (single-process tests of the
    ``topology='process'`` dispatch — no store, no other process)."""
    global _CTX
    from repro_torch.core import procmesh

    comm = procmesh.ProcComm(procmesh.LocalKV(), pid, nprocs, prefix)
    _CTX = ProcessContext(comm=comm, hb_timeout=hb_timeout, fault=fault)
    return _CTX


def clear_context() -> None:
    global _CTX
    _CTX = None


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.distributed",
        description="multi-process elastic launcher of the port")
    ap.add_argument("--nprocs", type=int, default=2,
                    help="world size (launcher mode)")
    ap.add_argument("--workers", type=int, default=4,
                    help="p: CentralVR workers, split over the processes")
    ap.add_argument("--algo", default="centralvr_async",
                    choices=("centralvr_sync", "centralvr_async"))
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--problem", default="logistic",
                    choices=("logistic", "ridge"))
    ap.add_argument("--n", type=int, default=12,
                    help="samples per worker (total = n * workers)")
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--eta", type=float, default=0.0,
                    help="step size; 0 = auto_eta on the merged problem")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speeds", default="",
                    help="comma-separated per-worker speeds (async)")
    ap.add_argument("--x64", action="store_true",
                    help="the exact verify tolerances (the port's convex "
                         "path is float64 either way)")
    ap.add_argument("--verify", action="store_true",
                    help="launcher: compare the fleet trajectory against "
                         "the in-parent single-process run")
    ap.add_argument("--tol", type=float, default=-1.0,
                    help="verify tolerance; -1 = auto (0.0 for x64 async, "
                         "1e-12 x64 sync, 3e-4 otherwise)")
    ap.add_argument("--json", default="",
                    help="results JSON path (written by process 0)")
    ap.add_argument("--obs", default="",
                    help="telemetry base path; each process writes "
                         "<base>-p<i>.jsonl")
    ap.add_argument("--logdir", default="",
                    help="child stdout/stderr directory (default: temp)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="launcher hard timeout in seconds")
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--drop-process", type=int, default=-1,
                    help="inject a fault: this process drops at a wave "
                         "boundary (requires --elastic; never 0)")
    ap.add_argument("--drop-round", type=int, default=2)
    ap.add_argument("--drop-mode", default="exit", choices=("exit", "stall"))
    ap.add_argument("--rejoin-after", type=int, default=2,
                    help="stall mode: boundaries to sit out before "
                         "rejoining")
    ap.add_argument("--hb-timeout", type=float, default=10.0,
                    help="heartbeat wait per peer at each wave boundary")
    ap.add_argument("--run-prefix", default="run0",
                    help="KV key namespace for this run")
    ap.add_argument("--device", default=None,
                    help="torch device of every process and of --verify; "
                         "default each process's CUDA device "
                         "(launch.mesh.rank_device)")
    # internal (appended by the launcher when spawning workers)
    ap.add_argument("--process-id", type=int, default=-1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.speeds:
        args.speeds = tuple(float(s) for s in args.speeds.split(","))
    else:
        args.speeds = None
    return args


def _build_spec(args, topology="process"):
    from repro_torch.core import solver

    return solver.RunSpec(
        algo=args.algo, p=args.workers, rounds=args.rounds,
        eta=args.eta or None, seed=args.seed, speeds=args.speeds,
        topology=topology, elastic=args.elastic)


def _build_cfg(args):
    from repro_torch.config import ConvexConfig

    return ConvexConfig(problem=args.problem, n=args.n, d=args.d,
                        seed=args.seed)


def _fault_from(args):
    if args.drop_process < 0:
        return None
    from repro_torch.core import procmesh

    return procmesh.Fault(process=args.drop_process, round_=args.drop_round,
                          mode=args.drop_mode,
                          rejoin_after=args.rejoin_after)


# ---------------------------------------------------------------------------
# Worker mode
# ---------------------------------------------------------------------------

def run_worker(args) -> int:
    import torch

    from repro_torch.launch import mesh
    from repro_torch.obs import recorder as obs_recorder

    torch.set_num_threads(1)
    fault = _fault_from(args)
    device = mesh.rank_device(args.process_id, args.device)
    init_process(args.coordinator, args.nprocs, args.process_id,
                 prefix=args.run_prefix, hb_timeout=args.hb_timeout,
                 fault=fault)
    if args.obs:
        obs_recorder.enable(f"{args.obs}-p{args.process_id}.jsonl")
    from repro_torch.core import procmesh, solver

    spec = _build_spec(args)
    payload = {"process": args.process_id, "nprocs": args.nprocs,
               "device": str(device), "spec": dataclasses.asdict(spec)}
    code = 0
    try:
        res = solver.solve(spec, _build_cfg(args), device=device)
        payload.update(
            rels=[float(v) for v in res.rels],
            transitions=res.transitions or [],
            final_rel=res.final_rel, wall_s=res.wall_s, dropped=False)
    except procmesh.WorkerDropped as e:
        rec = obs_recorder.active()
        if rec is not None:
            rec.event("fault_exit", process=args.process_id,
                      round=e.round_)
        payload.update(rels=[float(v) for v in e.rels], transitions=[],
                       dropped=True, dropped_round=e.round_)
    except Exception as e:     # noqa: BLE001 — report, then hard-exit
        payload.update(error=f"{type(e).__name__}: {e}")
        import traceback
        traceback.print_exc()
        code = 1
    if args.json and args.process_id == 0:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
    obs_recorder.disable()       # flush + close the telemetry record
    sys.stdout.flush()
    sys.stderr.flush()
    # Completion handshake: process 0 serves the store, so it must
    # outlive every peer — exiting early would take the server down under
    # a survivor still reading it. Every process (dropped ones included)
    # publishes a finish flag as its last act; process 0 drains them
    # before exiting.
    ctx = context()
    if ctx is not None:
        try:
            ctx.comm.put_flag(f"fin/{ctx.comm.pid}", {"code": code})
        except Exception:        # noqa: BLE001 — exiting anyway
            pass
        if ctx.comm.pid == 0:
            for peer in range(1, ctx.comm.nprocs):
                try:
                    ctx.comm.get_flag(f"fin/{peer}", timeout_s=60.0)
                except Exception:  # noqa: BLE001 — peer crashed hard;
                    pass           # the launcher reports its exit code
            time.sleep(0.25)     # let peers clear their final exit path
    os._exit(code)


# ---------------------------------------------------------------------------
# Launcher mode
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_argv(args, pid: int, coordinator: str, json_path: str):
    argv = [sys.executable, "-m", "repro_torch.launch.distributed",
            "--nprocs", str(args.nprocs), "--workers", str(args.workers),
            "--algo", args.algo, "--rounds", str(args.rounds),
            "--problem", args.problem, "--n", str(args.n),
            "--d", str(args.d), "--eta", str(args.eta),
            "--seed", str(args.seed), "--hb-timeout", str(args.hb_timeout),
            "--run-prefix", args.run_prefix,
            "--process-id", str(pid), "--coordinator", coordinator,
            "--json", json_path]
    if args.speeds:
        argv += ["--speeds", ",".join(str(s) for s in args.speeds)]
    if args.x64:
        argv += ["--x64"]
    if args.obs:
        argv += ["--obs", args.obs]
    if args.device:
        argv += ["--device", args.device]
    if args.elastic:
        argv += ["--elastic"]
        if args.drop_process >= 0:
            argv += ["--drop-process", str(args.drop_process),
                     "--drop-round", str(args.drop_round),
                     "--drop-mode", args.drop_mode,
                     "--rejoin-after", str(args.rejoin_after)]
    return argv


def _tail(path: str, lines: int = 25) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-lines:])
    except OSError:
        return "<no log>"


def _auto_tol(args) -> float:
    if args.tol >= 0:
        return args.tol
    if not args.x64:
        return 3e-4
    # the async wave algebra is bit-exact; the sync engine's per-block
    # epochs may differ from the all-worker call by reduction order
    return 0.0 if args.algo == "centralvr_async" else 1e-12


def _verify(args, results: dict) -> int:
    """In-parent single-process event-serial run vs the fleet's
    trajectory."""
    import numpy as np

    from repro_torch.core import elastic as elasticmod
    from repro_torch.core import solver

    tol = _auto_tol(args)
    membership = None
    if args.elastic:
        membership = elasticmod.PlannedMembership(
            args.workers,
            {t["round"]: t["live"] for t in results["transitions"]})
    t0 = time.perf_counter()
    res = solver.solve(_build_spec(args, "local"), _build_cfg(args),
                       membership=membership, device=args.device)
    got = np.asarray(results["rels"], dtype=float)
    want = np.asarray(res.rels, dtype=float)
    if got.shape != want.shape:
        print(f"VERIFY FAIL: fleet recorded {got.shape} rels, reference "
              f"has {want.shape}")
        return 1
    diff = float(np.abs(got - want).max())
    ok = diff <= tol
    print(f"verify: max|fleet - reference| = {diff:.3e} "
          f"(tol {tol:.1e}) -> {'OK' if ok else 'FAIL'}; the event-serial "
          f"run on {res.device} took {time.perf_counter() - t0:.3f} s")
    if args.elastic:
        print(f"verify: replayed membership transitions: "
              f"{results['transitions']}")
    return 0 if ok else 1


def run_launcher(args) -> int:
    if args.elastic and args.drop_process == 0:
        print("--drop-process 0 is invalid: process 0 co-hosts the "
              "coordination service", file=sys.stderr)
        return 2
    logdir = args.logdir or tempfile.mkdtemp(prefix="repro-torch-fleet-")
    os.makedirs(logdir, exist_ok=True)
    json_path = args.json or os.path.join(logdir, "results.json")
    coordinator = f"127.0.0.1:{_free_port()}"
    print(f"launching {args.nprocs} processes (store {coordinator}, "
          f"logs in {logdir})")
    t0 = time.perf_counter()
    procs, logs = [], []
    try:
        for pid in range(args.nprocs):
            with open(os.path.join(logdir, f"proc{pid}.log"), "w") as log:
                logs.append(log.name)
                procs.append(subprocess.Popen(
                    _child_argv(args, pid, coordinator, json_path),
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + args.timeout
        codes = [None] * args.nprocs
        while any(c is None for c in codes):
            if time.monotonic() > deadline:
                print(f"TIMEOUT after {args.timeout:.0f}s", file=sys.stderr)
                for pid, log in enumerate(logs):
                    print(f"--- proc{pid} tail ---\n{_tail(log)}",
                          file=sys.stderr)
                return 124
            for pid, p in enumerate(procs):
                if codes[pid] is None:
                    codes[pid] = p.poll()
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(codes):
        print(f"worker exit codes: {codes}", file=sys.stderr)
        for pid, log in enumerate(logs):
            if codes[pid]:
                print(f"--- proc{pid} tail ---\n{_tail(log)}",
                      file=sys.stderr)
        return 1
    with open(json_path) as f:
        results = json.load(f)
    if "error" in results:
        print(f"process 0 reported: {results['error']}", file=sys.stderr)
        print(_tail(logs[0]), file=sys.stderr)
        return 1
    print(f"fleet ok: final_rel={results.get('final_rel'):.3e} "
          f"transitions={results.get('transitions')} on "
          f"{results.get('device')}; processes' wall {wall:.3f} s, "
          f"process 0's solve {results.get('wall_s'):.3f} s")
    if args.verify:
        return _verify(args, results)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.process_id >= 0:
        return run_worker(args)       # never returns (os._exit)
    return run_launcher(args)


if __name__ == "__main__":
    # `python -m` executes this file as __main__, a SEPARATE module
    # instance from the `repro_torch.launch.distributed` the engines import
    # for context() — run the canonical instance so they share _CTX
    from repro_torch.launch import distributed as _canonical
    sys.exit(_canonical.main())
