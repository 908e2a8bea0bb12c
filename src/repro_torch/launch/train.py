"""Training launcher of the port:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --reduced --steps 8 --vr centralvr --vr-table-size 2 \
        --num-workers 2 --device cpu

Runs ``train/loop.py``'s epoch loop: W stacked workers on one device,
or with ``--backend spmd`` one worker per process over
``torch.distributed`` — W ranks started here by
``launch.mesh.spawn_workers``, or, under ``torchrun``, the ranks it
started:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch mamba2-130m --reduced --num-workers 2 --backend spmd

``--device`` defaults to each rank's CUDA device and fails without one.
``--checkpoint PATH`` saves the state at the end (and every
``--checkpoint-every`` epochs); ``--resume`` continues from its latest
save (``train/loop.py``).
``--obs PATH`` records the run's telemetry (``repro_torch.obs``; rank 0
under spmd), ``--profile DIR`` writes a ``torch.profiler`` Chrome trace
per process, and ``--compile-cache DIR`` builds the kernels in DIR. The
reference's per-step host runtime and its production meshes are not
ported yet and raise, naming their ROADMAP.md item.
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
                         "process (torch.distributed)")
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
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="epochs between saves to --checkpoint")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --checkpoint's latest save")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs", default="", metavar="PATH",
                    help="record structured run telemetry (epoch spans + "
                         "structured epoch rows) to this JSONL file")
    ap.add_argument("--profile", default="", metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                         "per process into this directory")
    from repro_torch.launch.compile_cache import add_compile_cache_arg
    add_compile_cache_arg(ap)
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA device")
    return ap.parse_args(argv)


def _train(group, args):
    """One run of the epoch loop (in a rank of ``group`` under spmd);
    returns what ``main`` prints."""
    from repro_torch import obs
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.kernels import resolve_device
    from repro_torch.launch.compile_cache import enable_compile_cache
    from repro_torch.launch.solve import profiling
    from repro_torch.train import loop

    enable_compile_cache(args.compile_cache)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        microbatch=args.microbatch, learning_rate=args.lr,
        optimizer=args.optimizer, vr=args.vr,
        vr_table_size=args.vr_table_size, local_epoch=args.local_epoch,
        seed=args.seed)
    lead = group is None or group.rank == 0
    device = (group.device if group is not None
              else resolve_device(args.device, "repro_torch.launch.train"))
    if args.obs and lead:
        obs.enable(args.obs)
    try:
        with profiling(args.profile, device,
                       0 if group is None else group.rank):
            res = loop.run_training(
                cfg, tcfg, epochs=args.epochs or None,
                steps=None if args.epochs else args.steps,
                workers=args.num_workers, backend=args.backend,
                device=None if group is not None else device, group=group,
                checkpoint_path=args.checkpoint or None,
                checkpoint_every=args.checkpoint_every, resume=args.resume,
                log_fn=print if lead else (lambda _: None))
    finally:
        if args.obs and lead:
            obs.disable()
            print(f"wrote telemetry to {args.obs}")
    return dict(steps=res.steps, wall_time=res.wall_time,
                loss=res.losses[-1], eval_loss=res.final_eval_loss)


def main(argv=None):
    args = parse_args(argv)
    if args.runtime == "host":
        raise SystemExit("--runtime host (train/host_loop.py) is not ported "
                         "yet (ROADMAP.md queue 1, item 13)")
    if args.mesh != "test":
        raise SystemExit(f"--mesh {args.mesh} is not ported yet (ROADMAP.md "
                         "queue 1, item 13 (rest))")
    if args.backend == "spmd":
        import os

        from repro_torch.launch import mesh
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            group = mesh.make_worker_mesh(args.num_workers,
                                          device=args.device)
            out = _train(group, args)
            if group.rank:
                return
        else:
            out = mesh.spawn_workers(args.num_workers, _train, args,
                                     device=args.device)[0]
    else:
        out = _train(None, args)
    print(f"done: {out['steps']} steps in {out['wall_time']:.1f}s; "
          f"final train loss {out['loss']:.4f}; "
          f"eval loss {out['eval_loss']:.4f}")


if __name__ == "__main__":
    main()
