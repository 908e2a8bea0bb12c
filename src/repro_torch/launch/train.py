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

``--runtime host`` runs the per-step loop (``train/host_loop.py``) on a
process mesh, any step count: ``--mesh test`` is the (1, 1) mesh of one
process, or under ``torchrun`` the (world / 2, 2) (data, model) mesh of
its ranks; ``--mesh production|production-multipod`` needs 256 or 512
ranks. ``--workers none|data|pod`` puts CentralVR workers on the mesh's
axes, and ``--dp-replicated`` keeps a whole model copy per data group
(no FSDP):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-7b --reduced --runtime host --steps 5 --mesh test \
        --workers data --dp-replicated --vr-table-size 2 --seq-len 16 \
        --global-batch 8 --microbatch 2 --optimizer sgd --device cpu

``--device`` defaults to each rank's CUDA device and fails without one.
``--checkpoint PATH`` saves the state at the end (and every
``--checkpoint-every`` epochs); ``--resume`` continues from its latest
save (``train/loop.py``).
``--obs PATH`` records the run's telemetry (``repro_torch.obs``; rank 0
under spmd), ``--profile DIR`` writes a ``torch.profiler`` Chrome trace
per process, and ``--compile-cache DIR`` builds the kernels in DIR.
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
                    help="epoch runtime vs per-step reference loop")
    ap.add_argument("--backend", default="vmap", choices=["vmap", "spmd"],
                    help="stacked workers on one device vs one worker per "
                         "process (torch.distributed)")
    ap.add_argument("--num-workers", type=int, default=1,
                    help="CentralVR worker count for the scan runtime")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--vr", default="centralvr",
                    choices=["none", "centralvr", "svrg", "saga"])
    ap.add_argument("--vr-table-size", type=int, default=8)
    ap.add_argument("--local-epoch", type=int, default=1)
    ap.add_argument("--workers", default="none",
                    choices=["none", "data", "pod"],
                    help="host runtime: which mesh axes carry worker copies")
    ap.add_argument("--dp-replicated", action="store_true")
    ap.add_argument("--mesh", default="test", choices=["test", "production",
                                                       "production-multipod"])
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="scan runtime: epochs; host runtime: steps")
    ap.add_argument("--resume", action="store_true",
                    help="scan runtime: continue from --checkpoint")
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


def _mesh(args):
    """The host runtime's mesh of ``--mesh`` over this process's world."""
    from repro_torch.launch import mesh as meshlib
    if args.mesh == "production":
        return meshlib.make_production_mesh(device=args.device)
    if args.mesh == "production-multipod":
        return meshlib.make_production_mesh(multi_pod=True,
                                            device=args.device)
    return meshlib.make_test_mesh(device=args.device)


def _train(group, args):
    """One run of the epoch loop (in a rank of ``group`` under spmd), or
    with ``--runtime host`` of the per-step loop on this rank's mesh;
    returns what ``main`` prints, or None on a rank that prints
    nothing."""
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
        dp_replicated=args.dp_replicated, seed=args.seed)
    mesh = None
    if args.runtime == "host":
        try:
            mesh = _mesh(args)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        group = None
    lead = (group is None or group.rank == 0) and (mesh is None
                                                   or mesh.rank == 0)
    device = (group.device if group is not None
              else mesh.device if mesh is not None
              else resolve_device(args.device, "repro_torch.launch.train"))
    if args.obs and lead:
        obs.enable(args.obs)
    try:
        with profiling(args.profile, device,
                       mesh.rank if mesh is not None
                       else 0 if group is None else group.rank):
            if mesh is not None:
                from repro_torch.train import host_loop
                try:
                    res = host_loop.run_training(
                        cfg, tcfg, steps=args.steps, mesh=mesh,
                        vr_workers=args.workers,
                        workers=(args.num_workers if args.num_workers > 1
                                 else None),
                        checkpoint_path=args.checkpoint or None,
                        checkpoint_every=args.checkpoint_every,
                        log_fn=print if lead else (lambda _: None))
                except (ValueError, NotImplementedError) as e:
                    raise SystemExit(str(e)) from None
            else:
                res = loop.run_training(
                    cfg, tcfg, epochs=args.epochs or None,
                    steps=None if args.epochs else args.steps,
                    workers=args.num_workers, backend=args.backend,
                    device=None if group is not None else device,
                    group=group, checkpoint_path=args.checkpoint or None,
                    checkpoint_every=args.checkpoint_every,
                    resume=args.resume,
                    log_fn=print if lead else (lambda _: None))
    finally:
        if args.obs and lead:
            obs.disable()
            print(f"wrote telemetry to {args.obs}")
    if not lead:
        return None
    return dict(steps=res.steps, wall_time=res.wall_time,
                loss=res.losses[-1], eval_loss=res.final_eval_loss)


def main(argv=None):
    args = parse_args(argv)
    if args.runtime == "host":
        if args.backend != "vmap":
            raise SystemExit("--runtime host is vmap-only; the spmd "
                             "backend lives in the epoch-scan runtime")
        if args.resume:
            raise SystemExit("--resume is an epoch-scan-runtime feature "
                             "(the host reference loop restarts from step "
                             "0 and would overwrite the checkpoint)")
        out = _train(None, args)
        if out is None:
            return
    elif args.mesh != "test" or args.workers != "none":
        raise SystemExit(
            "--mesh production*/--workers data|pod drive the mesh-"
            "derived worker layout of the per-step reference loop; "
            "pass --runtime host for them (the scan runtime takes "
            "--num-workers and --backend instead)")
    elif args.backend == "spmd":
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
