"""Training launcher of the port:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --reduced --steps 8 --vr centralvr --vr-table-size 2 \
        --num-workers 2 --device cpu

Runs ``train/loop.py``'s epoch loop (W stacked workers on one device).
``--device`` defaults to the current CUDA device and fails without one.
The reference's per-step host runtime, its spmd backend and its
production meshes are not ported yet and raise, naming their ROADMAP.md
item.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-smoke reduced variant")
    ap.add_argument("--steps", type=int, default=48,
                    help="must be a multiple of M*K")
    ap.add_argument("--epochs", type=int, default=0,
                    help="communication epochs (overrides --steps)")
    ap.add_argument("--runtime", default="scan", choices=["scan", "host"],
                    help="epoch runtime vs per-step reference loop (not "
                         "ported)")
    ap.add_argument("--backend", default="vmap", choices=["vmap", "spmd"],
                    help="stacked workers on one device vs one worker per "
                         "device (not ported)")
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--vr", default="centralvr",
                    choices=["none", "centralvr", "svrg", "saga"])
    ap.add_argument("--vr-table-size", type=int, default=8)
    ap.add_argument("--local-epoch", type=int, default=1)
    ap.add_argument("--mesh", default="test", choices=["test", "production",
                                                       "production-multipod"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA device")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.runtime == "host":
        raise SystemExit("--runtime host (train/host_loop.py) is not ported "
                         "yet (ROADMAP.md queue 1, item 13)")
    if args.backend == "spmd":
        raise SystemExit("--backend spmd is not ported yet (ROADMAP.md "
                         "queue 1, item 9)")
    if args.mesh != "test":
        raise SystemExit(f"--mesh {args.mesh} is not ported yet (ROADMAP.md "
                         "queue 1, item 9)")
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.train import loop

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        microbatch=args.microbatch, learning_rate=args.lr,
        optimizer=args.optimizer, vr=args.vr,
        vr_table_size=args.vr_table_size, local_epoch=args.local_epoch,
        seed=args.seed)
    res = loop.run_training(
        cfg, tcfg, epochs=args.epochs or None,
        steps=None if args.epochs else args.steps,
        workers=args.num_workers, device=args.device)
    print(f"done: {res.steps} steps in {res.wall_time:.1f}s; "
          f"final train loss {res.losses[-1]:.4f}; "
          f"eval loss {res.final_eval_loss:.4f}")


if __name__ == "__main__":
    main()
