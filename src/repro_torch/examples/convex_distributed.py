"""The paper's distributed experiment (§6.2), end to end — the port of the
reference's ``examples/convex_distributed.py``: CentralVR-Sync / -Async
vs D-SVRG / D-SAGA / EASGD on weak-scaled toy data, with the
rounds-to-tolerance linear-scaling readout.

    python -m repro_torch.examples.convex_distributed [--workers 8]

Every row is one declarative ``repro_torch.solve(RunSpec(...))`` call.
The VR algorithms take the kernel path where it is compiled
(``fused="auto"``: one ``vr_epoch`` launch a local epoch on an H100).
``--backend spmd`` runs every driver with one worker per rank: the ranks
are processes that ``launch.mesh.spawn_workers`` starts on this host,
one group of p ranks for the table and one for each width of the
weak-scaling readout; each rank draws the problem on its device from the
same seed, and rank 0's results are printed (the asynchronous rows run
their event schedule as concurrency waves, D-SAGA under the stale-fetch
discipline the waves require).
"""
import argparse

import numpy as np
import torch

TOL = 1e-3


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--n-per-worker", type=int, default=1000)
    ap.add_argument("--d", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--backend", choices=("vmap", "spmd"), default="vmap")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def _problem(args, p: int, device):
    from repro_torch.config import ConvexConfig
    from repro_torch.core import convex, distributed
    cfg = ConvexConfig(problem="logistic", n=args.n_per_worker, d=args.d,
                       workers=p)
    sp = distributed.make_distributed(
        torch.Generator(device).manual_seed(0), cfg)
    return sp, convex.auto_eta(sp.merged(), 0.4)


def table_specs(args, eta: float) -> dict:
    """The table's rows: name -> RunSpec keywords."""
    p = args.workers
    common = dict(p=p, eta=eta, rounds=args.rounds, backend=args.backend,
                  seed=1)
    vr = dict(common, fused="auto")
    return {
        "CentralVR-Sync": dict(vr, algo="centralvr_sync"),
        "CentralVR-Async": dict(vr, algo="centralvr_async"),
        "CentralVR-Async (4x speed spread)": dict(
            vr, algo="centralvr_async",
            speeds=tuple(1 + 3 * i / max(p - 1, 1) for i in range(p))),
        "Distributed-SVRG": dict(vr, algo="dsvrg"),
        # spmd implies the stale-fetch discipline
        "Distributed-SAGA": dict(vr, algo="dsaga",
                                 tau=args.n_per_worker // 2, eta=eta / 2),
        "EASGD": dict(common, algo="easgd"),
        "dist-SGD": dict(common, algo="dist_sgd"),
    }


def run_rows(args, p: int, device, table: bool, group=None) -> dict:
    """The rows of one worker count: the table's (``table``) and the
    weak-scaling run, each (final rel, rels, wall seconds)."""
    from repro_torch import RunSpec, solve
    sp, eta = _problem(args, p, device)
    rows = {}
    specs = table_specs(args, eta) if table else {}
    specs[f"weak p={p}"] = dict(algo="centralvr_sync", p=p, eta=eta,
                                rounds=args.rounds, backend=args.backend,
                                seed=1, fused="auto")
    for name, kw in specs.items():
        res = solve(RunSpec(**kw), sp, device=None if group else device,
                    group=group)
        rows[name] = (res.final_rel, np.asarray(res.rels), res.wall_s)
    return rows


def _rank(group, args, table):
    return run_rows(args, group.world, group.device, table, group=group)


def main(argv=None):
    args = parse_args(argv)
    from repro_torch.kernels import resolve_device
    p, be = args.workers, args.backend
    widths = list(dict.fromkeys((2, 4, p)))
    device = resolve_device(args.device,
                            "repro_torch.examples.convex_distributed")
    rows = {}
    for pw in widths:
        if be == "spmd":
            from repro_torch.launch.mesh import spawn_workers
            rows.update(spawn_workers(pw, _rank, args, pw == p,
                                      device=args.device)[0])
        else:
            rows.update(run_rows(args, pw, device, pw == p))
    print(f"p={p} workers, |Omega_s|={args.n_per_worker}, "
          f"d={args.d}, {args.rounds} communication rounds, "
          f"backend={be}, device={device}\n")
    for name, (final, _, wall) in rows.items():
        if not name.startswith("weak"):
            print(f"{name:35s} final rel-grad-norm {final:.2e} [{wall:.2f}s]")

    # weak scaling: rounds to the tolerance as p grows (the linear-scaling
    # claim)
    print(f"\nweak scaling (rounds to rel-grad-norm < {TOL:g}):")
    weak = {}
    for pw in widths:
        rels = rows[f"weak p={pw}"][1]
        hit = np.nonzero(rels < TOL)[0]
        weak[pw] = int(hit[0]) + 1 if hit.size else None
        r = weak[pw] if hit.size else f">{args.rounds}"
        print(f"  p={pw:3d} (total data {pw * args.n_per_worker}): "
              f"{r} rounds")
    return dict(rows={k: (v[0], v[2]) for k, v in rows.items()},
                weak=weak)


if __name__ == "__main__":
    main()
