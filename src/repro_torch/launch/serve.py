"""Serving launcher of the port: a thin client of ``repro_torch.serve``,
the port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --reduced --requests 8 --prompt-len 32 --max-new 16 --width 4 \
        --pattern burst --device cpu

Attention-family architectures run on the continuous-batching engine
(paged KV cache + chunked prefill, serve/engine.py); recurrent stacks
(ssm / rec) and frontends fall back to the legacy static-batch host loop
(serve/legacy.py). ``--path legacy`` forces the old path. ``--device``
defaults to the current CUDA device and fails without one. ``--obs PATH``
records the run's telemetry (rank 0's under ``--tp``); ``--compile-cache
DIR`` builds the kernels in DIR. ``--tp N`` shards the engine's decode
over N tensor-parallel ranks: the ranks of a ``torchrun`` world, on its
(world / N, N) test mesh, or N ranks spawned on this host (gloo where
they share a card), rank 0 printing the report.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--vary-new", action="store_true",
                    help="cycle max_new over {1,3/4,1/2,1/4}x so lanes "
                         "retire at different steps")
    ap.add_argument("--pattern", default="burst",
                    choices=("burst", "uniform", "poisson"))
    ap.add_argument("--gap", type=int, default=4,
                    help="mean decode-steps between arrivals")
    ap.add_argument("--width", type=int, default=4,
                    help="decode batch lanes (engine) / static batch "
                         "size (legacy)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--kv-cache", default="paged",
                    choices=("paged", "dense"))
    ap.add_argument("--chunk-buckets", default="16,64,128",
                    help="comma-separated prefill chunk sizes")
    ap.add_argument("--path", default="auto",
                    choices=("auto", "engine", "legacy"))
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree for engine decode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs", default="", metavar="PATH",
                    help="record telemetry (admit/prefill/decode/retire "
                         "spans + report) to this JSONL file")
    from repro_torch.launch.compile_cache import add_compile_cache_arg
    add_compile_cache_arg(ap)
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA device")
    return ap.parse_args(argv)


def _path(args, cfg):
    """The path the run takes: the engine, or the legacy loop for the
    archs the engine does not serve (``--path auto``)."""
    from repro_torch.serve import check_arch
    if args.path != "auto":
        return args.path
    try:
        check_arch(cfg)
        return "engine"
    except ValueError as e:
        print(f"engine unavailable ({e}); using legacy host loop")
        return "legacy"


def _rank_main(group, args):
    """A rank spawned for ``--tp``: serve on the test mesh of the world."""
    return _serve(args, "engine", lead=group.rank == 0)


def _serve(args, path, lead=True):
    """Serve the trace in this process (on the (data, model) test mesh of
    the world with ``--tp`` above 1 on the engine); the lead rank records
    telemetry. Returns the report."""
    from repro_torch.launch.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache(args.compile_cache)

    import torch

    from repro_torch import obs
    from repro_torch.config import get_arch
    from repro_torch.kernels import resolve_device
    from repro_torch.models import model
    from repro_torch.serve import ServeEngine, run_host_loop, synthetic_trace

    mesh = None
    if path == "engine" and args.tp > 1:
        from repro_torch.launch import mesh as meshlib
        world = meshlib._world_size()
        if world % args.tp:
            raise SystemExit(
                f"--tp {args.tp} needs a world of a multiple of {args.tp} "
                f"ranks, {args.tp} a replica; this world has {world} (run "
                f"under torchrun --nproc-per-node {args.tp}, or without "
                "torchrun to spawn the ranks)")
        mesh = meshlib.make_test_mesh(model_axis=args.tp, device=args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device, "repro_torch.launch.serve")
    if args.obs and lead:
        obs.enable(args.obs)
    if cache_dir and lead:
        print(f"compile cache: {cache_dir}")

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    trace = synthetic_trace(args.requests, pattern=args.pattern,
                            prompt_len=args.prompt_len,
                            max_new=args.max_new, gap=args.gap,
                            vary_new=args.vary_new, seed=args.seed)

    # on a mesh each rank draws its shards from the seed itself
    params = None if mesh is not None else model.init_params(
        cfg, torch.Generator(device).manual_seed(args.seed), device=device)
    if path == "legacy":
        rep = run_host_loop(cfg, trace, params=params, width=args.width,
                            device=device)
    else:
        max_len = args.prompt_len + args.max_new
        eng = ServeEngine(
            cfg, params, width=args.width, block_size=args.block_size,
            max_seq_len=max_len, kv_cache=args.kv_cache,
            chunk_buckets=tuple(int(c) for c in
                                args.chunk_buckets.split(",")),
            mesh=mesh, seed=args.seed, device=device)
        eng.warmup()
        rep = eng.run(trace)
    if args.obs and lead:
        obs.disable()
    return rep


def _report(args, path, rep):
    s = rep.summary()
    cold = sum(rep.compile_s.values())
    tp = f" tp {args.tp}" if path == "engine" and args.tp > 1 else ""
    print(f"[{path}{tp}] {s['requests']} requests, {s['steps']} steps: "
          f"prefill {s['prefill_tokens']} tok @ {s['prefill_tok_s']:.1f} "
          f"tok/s; decode {s['decode_tokens']} tok @ "
          f"{s['decode_tok_s']:.1f} tok/s; latency p50 "
          f"{s['latency_p50_s'] * 1e3:.1f}ms p95 "
          f"{s['latency_p95_s'] * 1e3:.1f}ms; first calls {cold:.2f}s")
    print("sample token ids:", rep.results[0].tokens[:16])
    if args.obs:
        print(f"wrote telemetry to {args.obs}")


def main(argv=None):
    """Serve the trace and print the report; returns it. ``--tp N`` above
    1 on the engine: under ``torchrun`` every rank runs this and joins
    the (world / N, N) test mesh, and rank 0 prints; else N ranks are
    spawned here (``launch.mesh.spawn_workers``) and this process prints
    rank 0's report. The legacy loop ignores ``--tp``, as the
    reference's does."""
    args = parse_args(argv)
    from repro_torch.config import get_arch
    from repro_torch.launch import mesh as meshlib

    cfg = get_arch(args.arch)
    path = _path(args, cfg.reduced() if args.reduced else cfg)
    if path == "engine" and args.tp > 1 and meshlib._world_size() == 1:
        from repro_torch.kernels import resolve_device
        # no card and no --device cpu: raise here, before any rank starts
        resolve_device(args.device, "repro_torch.launch.serve")
        rep = meshlib.spawn_workers(args.tp, _rank_main, args,
                                    device=args.device)[0]
    else:
        rep = _serve(args, path, lead=_rank() == 0)
        if _rank() != 0:
            return rep
    _report(args, path, rep)
    return rep


def _rank() -> int:
    """This process's rank in the world (0 without one)."""
    import os

    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


if __name__ == "__main__":
    main()
