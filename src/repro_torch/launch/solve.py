"""Run any registry algorithm — or a sweep over the whole registry —
through the port's solver API; the port of ``repro/launch/solve.py``.

    python -m repro_torch.launch.solve --list
    python -m repro_torch.launch.solve --algo centralvr_sync --quick
    python -m repro_torch.launch.solve --algo dsaga --fetch stale --tau 50
    python -m repro_torch.launch.solve --algo centralvr_async \
        --backend spmd --workers 4 --speeds 1,1,2,4
    python -m repro_torch.launch.solve --sweep --quick --json sweep.json

Every run is one ``repro_torch.solve(RunSpec(...), ConvexConfig(...))``
call; the printed row and the optional ``--json`` dump are
``RunResult.provenance()`` records. The flags are the reference's, plus
``--device``: the runs go to the CUDA device unless it names another
(``--device cpu``), and fail without a card.

``--backend spmd`` runs one worker per process over ``torch.distributed``
(``core/spmd.py``): ``--workers`` ranks started here by
``launch.mesh.spawn_workers``, or, under ``torchrun``, the ranks it
started. Algorithm 1 runs on rank 0 in a group of its own; during a
sweep, algorithms without an spmd program fall back to vmap on rank 0
with a note, as in the reference. Rank 0 prints, writes ``--json`` and
writes the ``--obs`` record. ``--profile DIR`` writes a Chrome trace of
``torch.profiler`` (CPU activity, and CUDA activity on a card) per
process under DIR.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Unified solver CLI: one RunSpec per run.")
    ap.add_argument("--algo", default="",
                    help="registry algorithm name (see --list)")
    ap.add_argument("--sweep", action="store_true",
                    help="run every registry algorithm")
    ap.add_argument("--list", action="store_true",
                    help="print the registry (caps + doc) and exit")
    ap.add_argument("--problem",
                    choices=("logistic", "ridge", "huber", "pseudo_huber"),
                    default="logistic")
    ap.add_argument("--outlier-frac", type=float, default=0.0,
                    help="label corruption rate (robust-loss experiments)")
    ap.add_argument("--huber-delta", type=float, default=1.0,
                    help="Huber/pseudo-Huber transition scale")
    ap.add_argument("--n", type=int, default=0,
                    help="samples per worker (0 -> 1000, or 64 in --quick)")
    ap.add_argument("--d", type=int, default=0,
                    help="feature dim (0 -> 50, or 8 in --quick)")
    ap.add_argument("--workers", "-p", type=int, default=0,
                    help="worker count for distributed algos "
                         "(0 -> 4, or 2 in --quick)")
    ap.add_argument("--rounds", type=int, default=0,
                    help="communication rounds / epochs "
                         "(0 -> 10, or 3 in --quick)")
    ap.add_argument("--eta", type=float, default=0.0,
                    help="step size (0 -> auto from the smoothness const)")
    ap.add_argument("--backend", choices=("vmap", "spmd"), default="vmap")
    ap.add_argument("--fetch", choices=("instant", "stale"), default="",
                    help="D-SAGA fetch discipline")
    ap.add_argument("--speeds", default="",
                    help="comma list of per-worker relative speeds "
                         "(async algos)")
    ap.add_argument("--tau", type=int, default=0,
                    help="local steps per event/round where supported")
    ap.add_argument("--prox", default="",
                    help="composite objective: prox spec 'name[:p1[:p2]]' "
                         "(l1:lam1, elasticnet:lam1:lam2, box:lo:hi, "
                         "group_l2:lam1:size); VR algorithms only")
    ap.add_argument("--lam2", type=float, default=0.0,
                    help="elastic-net quadratic weight: upgrades --prox "
                         "l1:lam1 to elasticnet:lam1:lam2")
    ap.add_argument("--snapshot", choices=("last", "avg", "rand"),
                    default="",
                    help="VR anchor strategy (svrg/dsvrg take avg/rand)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metric-every", type=int, default=1)
    ap.add_argument("--quick", action="store_true",
                    help="tiny CI-smoke sizes")
    ap.add_argument("--json", default="",
                    help="write RunResult.provenance() rows to this path")
    ap.add_argument("--obs", default="", metavar="PATH",
                    help="record structured run telemetry (spans, streamed "
                         "metrics, comms/staleness) to this JSONL file; "
                         "render with `python -m repro_torch.launch.obs "
                         "report`")
    ap.add_argument("--stream-every", type=int, default=1,
                    help="streamed per-round metric cadence (with --obs)")
    ap.add_argument("--profile", default="", metavar="DIR",
                    help="write a torch.profiler Chrome trace of the runs "
                         "per process into this directory")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA device (each "
                         "rank's under --backend spmd)")
    from repro_torch.launch.compile_cache import add_compile_cache_arg
    add_compile_cache_arg(ap)
    return ap.parse_args(argv)


def build_spec(args, name, workers, rounds):
    """One RunSpec from the flag surface, honoring the algorithm's
    capability record (flags an algorithm doesn't take are only an error
    when the user set them explicitly for a single --algo run)."""
    from repro_torch.core import solver

    caps = solver.REGISTRY[name].caps
    backend = args.backend
    note = ""
    if backend == "spmd" and not caps.spmd_ok:
        if not args.sweep:
            # let RunSpec raise its field-named error
            return solver.RunSpec(algo=name, backend=backend), ""
        backend, note = "vmap", " (no spmd program: ran vmap)"
    kw = dict(algo=name, p=workers if caps.distributed else 1,
              rounds=rounds, backend=backend, seed=args.seed,
              metric_every=args.metric_every)
    if args.eta:
        kw["eta"] = args.eta
    # a flag the algorithm doesn't take is dropped during a sweep but kept
    # for a single --algo run, so RunSpec surfaces the capability mismatch
    # instead of silently ignoring what the user asked for
    if args.tau and (caps.accepts_tau or not args.sweep):
        kw["tau"] = args.tau
    if args.fetch and (caps.accepts_fetch or not args.sweep):
        kw["fetch"] = args.fetch
    if args.speeds and (caps.accepts_speeds or not args.sweep):
        kw["speeds"] = tuple(float(s) for s in args.speeds.split(","))
    prox = resolve_prox(args)
    if prox and (caps.accepts_prox or not args.sweep):
        kw["prox"] = prox
    elif prox:
        note += " (no prox support: ran smooth)"
    if args.snapshot and (args.snapshot in caps.snapshots or not args.sweep):
        kw["snapshot"] = args.snapshot
    elif args.snapshot and args.snapshot != "last":
        note += f" (no {args.snapshot!r} snapshot: ran 'last')"
    return solver.RunSpec(**kw), note


def resolve_prox(args) -> str:
    """--prox [+ --lam2] -> a prox spec string. ``--lam2`` is sugar for
    the elastic-net quadratic: it upgrades ``--prox l1:lam1`` to
    ``elasticnet:lam1:lam2`` (and overrides an explicit elasticnet lam2)."""
    from repro_torch.prox import operators as proxops

    if not args.prox:
        if args.lam2:
            raise SystemExit("--lam2 needs --prox l1:... or elasticnet:... "
                             "(it sets the elastic-net quadratic weight)")
        return ""
    ps = proxops.parse(args.prox)
    if args.lam2:
        if ps.name == "l1":
            ps = proxops.parse(f"elasticnet:{ps.params[0]:g}:{args.lam2:g}")
        elif ps.name == "elasticnet":
            ps = proxops.parse(
                f"elasticnet:{ps.params[0]:g}:{args.lam2:g}")
        else:
            raise SystemExit(f"--lam2 does not apply to prox {ps.name!r}")
    return proxops.canonical(ps)


def print_list() -> None:
    """The registry, one algorithm a line, with its capability flags."""
    from repro_torch.core import solver

    for name, e in solver.REGISTRY.items():
        c = e.caps
        flags = [k for k, v in
                 (("distributed", c.distributed), ("spmd", c.spmd_ok),
                  ("async", c.is_async), ("fetch", c.accepts_fetch),
                  ("speeds", c.accepts_speeds), ("tau", c.accepts_tau),
                  ("prox", c.accepts_prox),
                  ("snapshot=" + "|".join(c.snapshots),
                   len(c.snapshots) > 1))
                 if v]
        print(f"{name:16s} [{', '.join(flags)}] {e.doc}")


@contextlib.contextmanager
def profiling(directory: str, device, rank: int):
    """``torch.profiler`` over the block when ``directory`` is given (CPU
    activity, plus CUDA on a card); its Chrome trace goes to
    ``directory/trace-rank<rank>-<pid>.json``. The launchers'
    ``--profile``."""
    if not directory:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace-rank{rank}-{os.getpid()}.json")
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
    if rank == 0:
        print(f"wrote profiler trace to {directory}")


def run_specs(group, args, specs, cfg, device=None) -> list:
    """Solve every (spec, note) of ``specs`` on this process (a rank of
    ``group`` under ``--backend spmd``, else ``device``); returns the
    provenance rows (rank 0's under spmd, [] elsewhere)."""
    from repro_torch import obs
    from repro_torch.core import solver
    from repro_torch.launch.compile_cache import enable_compile_cache

    enable_compile_cache(args.compile_cache)
    lead = group is None or group.rank == 0
    solo = None
    if group is not None:
        device = group.device
        if any(s.backend == "spmd" and s.p == 1 for s, _ in specs):
            # Algorithm 1's spmd program runs in a group of one rank
            import torch.distributed as dist
            sub = dist.new_group([0])
            solo = dataclasses.replace(group, world=1, group=sub)
    if args.obs and lead:
        obs.enable(args.obs, stream_every=args.stream_every)
    rows = []
    try:
        with profiling(args.profile, device,
                       0 if group is None else group.rank):
            for spec, note in specs:
                if group is None:
                    res = solver.solve(spec, cfg, device=device)
                elif spec.backend == "spmd" and spec.p == group.world:
                    res = solver.solve(spec, cfg, group=group)
                elif not lead:
                    continue
                elif spec.backend == "spmd":
                    res = solver.solve(spec, cfg, group=solo)
                else:
                    res = solver.solve(spec, cfg, device=device)
                if not lead:
                    continue
                rows.append(res.provenance())
                print(f"{spec.algo:16s} backend={spec.backend:4s} "
                      f"p={spec.p} rounds={spec.rounds} "
                      f"eta={res.spec.eta:.3g} "
                      f"final rel-grad-norm {res.final_rel:.3e} "
                      f"[{res.wall_s:.2f}s]{note}", flush=True)
    finally:
        if args.obs and lead:
            obs.disable()
            print(f"wrote telemetry to {args.obs}")
    if args.json and lead:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {len(rows)} provenance rows to {args.json}")
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.list:
        print_list()
        return 0
    if not args.sweep and not args.algo:
        print("need --algo NAME, --sweep, or --list")
        return 2

    from repro_torch.config import ConvexConfig
    from repro_torch.core import solver

    n = args.n or (64 if args.quick else 1000)
    d = args.d or (8 if args.quick else 50)
    workers = args.workers or (2 if args.quick else 4)
    rounds = args.rounds or (3 if args.quick else 10)
    cfg = ConvexConfig(problem=args.problem, n=n, d=d, seed=args.seed,
                       outlier_frac=args.outlier_frac,
                       huber_delta=args.huber_delta)
    names = list(solver.REGISTRY) if args.sweep else [args.algo]
    # every spec is validated here, before a rank starts
    specs = [build_spec(args, name, workers, rounds) for name in names]

    if args.backend != "spmd":
        from repro_torch.kernels import resolve_device
        run_specs(None, args, specs, cfg,
                  device=resolve_device(args.device,
                                        "repro_torch.launch.solve"))
        return 0
    from repro_torch.launch import mesh
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        run_specs(mesh.make_worker_mesh(workers, device=args.device), args,
                  specs, cfg)
    else:
        mesh.spawn_workers(workers, run_specs, args, specs, cfg,
                           device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
