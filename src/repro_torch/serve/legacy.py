"""The pre-engine serving path: static batching + per-token host loop —
the port of ``repro/serve/legacy.py``.

Kept as the fallback for architectures the engine does not serve (ssm /
rec caches, frontend embeds) and as the engine's old-path twin.

Semantics (the reference's): requests are grouped in arrival order into
static batches of ``width``; each group prefills by S per-token
``model.decode_step`` calls against a dense, fully allocated cache, then
decodes in lockstep to the group's largest max_new (lanes that finish
early ride along as padding — the cost continuous batching removes). The
first step is the warmup: its time is reported as ``compile_s["decode"]``
(the first call's time; nothing is compiled) and kept out of throughput.

The params are cast to the compute dtype once, as the engine casts them
(bit-identical to the reference's cast inside every step). The greedy
ids stay on the device between steps; a group's ids reach the host once
its prefill and once its decode are done.
"""
from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.config import ModelConfig
from repro_torch.kernels import resolve_device
from repro_torch.models import model
from repro_torch.serve import runtime
from repro_torch.serve.engine import RequestResult, ServeReport, _sync
from repro_torch.serve.trace import Request, prompt_tokens


def run_host_loop(cfg: ModelConfig, reqs: Sequence[Request], *, params=None,
                  width: int = 4, seed: int = 0, device=None) -> ServeReport:
    """Serve ``reqs`` with the legacy path on ``device`` (the current CUDA
    device by default; raises without one); returns the engine's
    ServeReport shape so runs are directly comparable."""
    prompt_lens = {r.prompt_len for r in reqs}
    if len(prompt_lens) != 1:
        raise ValueError("legacy host loop batches lockstep: all requests "
                         f"must share one prompt_len, got {prompt_lens}")
    device = resolve_device(device, "repro_torch.serve.run_host_loop")
    if params is None:
        params = model.init_params(
            cfg, torch.Generator(device).manual_seed(seed), device=device)
    params = runtime.cast_params(params, cfg, device)

    @torch.no_grad()
    def step(tok, cache, pos):
        return model.decode_step(params, cfg, tok, cache, pos)

    ordered = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    results = {r.rid: RequestResult(rid=r.rid, prompt_len=r.prompt_len,
                                    max_new=r.max_new,
                                    arrival_step=r.arrival,
                                    t_seen=time.time())
               for r in reqs}
    rep = ServeReport(results=[])
    compile_s: Dict[str, float] = {}
    wall0 = time.perf_counter()
    cold = True
    with obs.span("serve/legacy_run", requests=len(reqs), width=width):
        for g0 in range(0, len(ordered), width):
            group = ordered[g0:g0 + width]
            B, S = len(group), group[0].prompt_len
            gmax = max(r.max_new for r in group)
            prompts = torch.from_numpy(np.stack(
                [prompt_tokens(r, cfg.vocab_size) for r in group]).astype(
                np.int64)).to(device)
            # ONE cache per group; the first step below doubles as warmup
            cache = model.init_cache(cfg, B, S + gmax, device=device)
            t_start = 0
            if cold:
                t0 = time.perf_counter()
                logits, cache = step(prompts[:, :1], cache, 0)
                _sync(logits)
                compile_s["decode"] = time.perf_counter() - t0
                cold = False
                t_start = 1
            with obs.span("serve/legacy_prefill", batch=B, tokens=B * S):
                t0 = time.perf_counter()
                for t in range(t_start, S):
                    logits, cache = step(prompts[:, t:t + 1], cache, t)
                cur = logits.argmax(-1)
                _sync(cur)
                rep.prefill_s += time.perf_counter() - t0
            rep.prefill_tokens += B * (S - t_start)
            rep.steps += S
            now = time.time()
            gen = [cur]
            for r in group:
                results[r.rid].t_first = now
            with obs.span("serve/legacy_decode", batch=B, steps=gmax - 1):
                t0 = time.perf_counter()
                for g in range(1, gmax):
                    logits, cache = step(cur[:, None], cache, S + g - 1)
                    cur = logits.argmax(-1)
                    gen.append(cur)
                ids = torch.stack(gen, 1).cpu().numpy()
                rep.decode_s += time.perf_counter() - t0
            rep.steps += gmax - 1
            rep.decode_tokens += sum(r.max_new - 1 for r in group)
            now = time.time()
            for i, r in enumerate(group):
                res = results[r.rid]
                res.tokens = [int(x) for x in ids[i, :r.max_new]]
                res.t_finish = now
                res.finish_step = rep.steps
            del cache
    rep.wall_s = time.perf_counter() - wall0
    rep.compile_s = compile_s
    rep.results = [results[r.rid] for r in sorted(reqs, key=lambda q: q.rid)]
    rec = obs.active()
    if rec:
        rec.event("serve_report", path="legacy", **rep.summary())
    return rep
