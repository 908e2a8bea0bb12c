"""Batched serving example, a thin client of the ``repro_torch.serve``
runtime — the port of the reference's ``examples/serve_batched.py``:
attention-family architectures run on the continuous-batching engine
(paged KV cache + chunked prefill), while attention-free / hybrid stacks
(SSM, RG-LRU) fall back to the legacy static-batch host loop — both the
engine and the dispatch seam in one script.

    python -m repro_torch.examples.serve_batched [--device cpu]
"""
import argparse

import torch

from repro_torch.config import get_arch
from repro_torch.kernels import resolve_device
from repro_torch.models import model
from repro_torch.serve import (ServeEngine, check_arch, run_host_loop,
                               synthetic_trace)

ARCHS = ("qwen2-7b", "mamba2-130m", "recurrentgemma-2b")


def serve(arch: str, device, requests=6, prompt=32, gen=16, width=4):
    cfg = get_arch(arch).reduced()
    params = model.init_params(cfg, torch.Generator(device).manual_seed(0),
                               device=device)
    trace = synthetic_trace(requests, pattern="uniform", prompt_len=prompt,
                            max_new=gen, gap=2, vary_new=True)
    try:
        check_arch(cfg)
        eng = ServeEngine(cfg, params, width=width,
                          max_seq_len=prompt + gen, chunk_buckets=(prompt,),
                          device=device)
        eng.warmup()
        rep, path = eng.run(trace), "engine"
    except ValueError:
        rep, path = run_host_loop(cfg, trace, params=params, width=width,
                                  device=device), "legacy"
    s = rep.summary()
    print(f"{arch:22s} [{cfg.family:6s}] {path:6s} {s['requests']} reqs, "
          f"decode {s['decode_tok_s']:7.1f} tok/s, p95 "
          f"{s['latency_p95_s'] * 1e3:6.1f}ms "
          f"-> {rep.results[0].tokens[:8]}")
    return dict(path=path, summary=s,
                tokens=[r.tokens for r in rep.results])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "repro_torch.examples.serve_batched")
    return {arch: serve(arch, device) for arch in ARCHS}


if __name__ == "__main__":
    main()
