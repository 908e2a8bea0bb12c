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
records the run's telemetry; ``--compile-cache DIR`` builds the kernels
in DIR. ``--tp`` above 1 (tensor-parallel decode) is not ported yet and
exits naming its ROADMAP.md item.
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
                    help="tensor-parallel degree for engine decode (not "
                         "ported: only 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs", default="", metavar="PATH",
                    help="record telemetry (admit/prefill/decode/retire "
                         "spans + report) to this JSONL file")
    from repro_torch.launch.compile_cache import add_compile_cache_arg
    add_compile_cache_arg(ap)
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA device")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.tp > 1:
        raise SystemExit(f"--tp {args.tp}: tensor-parallel decode is not "
                         "ported yet (ROADMAP.md queue 1, item 14 (TP))")
    from repro_torch.launch.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache(args.compile_cache)

    import torch

    from repro_torch import obs
    from repro_torch.config import get_arch
    from repro_torch.kernels import resolve_device
    from repro_torch.models import model
    from repro_torch.serve import (ServeEngine, check_arch, run_host_loop,
                                   synthetic_trace)

    device = resolve_device(args.device, "repro_torch.launch.serve")
    if args.obs:
        obs.enable(args.obs)
    if cache_dir:
        print(f"compile cache: {cache_dir}")

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    path = args.path
    if path == "auto":
        try:
            check_arch(cfg)
            path = "engine"
        except ValueError as e:
            print(f"engine unavailable ({e}); using legacy host loop")
            path = "legacy"

    params = model.init_params(
        cfg, torch.Generator(device).manual_seed(args.seed), device=device)
    trace = synthetic_trace(args.requests, pattern=args.pattern,
                            prompt_len=args.prompt_len,
                            max_new=args.max_new, gap=args.gap,
                            vary_new=args.vary_new, seed=args.seed)

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
            seed=args.seed, device=device)
        eng.warmup()
        rep = eng.run(trace)

    s = rep.summary()
    cold = sum(rep.compile_s.values())
    print(f"[{path}] {s['requests']} requests, {s['steps']} steps: "
          f"prefill {s['prefill_tokens']} tok @ {s['prefill_tok_s']:.1f} "
          f"tok/s; decode {s['decode_tokens']} tok @ "
          f"{s['decode_tok_s']:.1f} tok/s; latency p50 "
          f"{s['latency_p50_s'] * 1e3:.1f}ms p95 "
          f"{s['latency_p95_s'] * 1e3:.1f}ms; first calls {cold:.2f}s")
    print("sample token ids:", rep.results[0].tokens[:16])
    if args.obs:
        obs.disable()
        print(f"wrote telemetry to {args.obs}")
    return rep


if __name__ == "__main__":
    main()
