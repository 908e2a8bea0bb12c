"""Serving runtime of the port — the port of ``repro.serve``: paged KV
cache, chunked prefill, continuous batching, and the legacy loop.

Layering:
  * ``cache``   — block-pool geometry + host-side allocator;
  * ``trace``   — deterministic synthetic request traces;
  * ``runtime`` — the two programs (batched decode_step, bucketed
                  prefill_chunk) over paged / dense / ring layer caches;
  * ``engine``  — the continuous-batching scheduler (ServeEngine);
  * ``legacy``  — the static-batch per-token host loop, the fallback for
                  the non-attention archs and the engine's twin.

Tensor-parallel decode is not ported yet (ROADMAP.md queue 1, item 14
(TP)).
"""
from repro_torch.serve.cache import BlockAllocator, Geometry
from repro_torch.serve.engine import (RequestResult, ServeEngine,
                                      ServeReport, serve_trace)
from repro_torch.serve.legacy import run_host_loop
from repro_torch.serve.runtime import SERVE_KINDS, check_arch
from repro_torch.serve.trace import (ARRIVAL_PATTERNS, Request,
                                     prompt_tokens, synthetic_trace)

__all__ = [
    "ARRIVAL_PATTERNS", "BlockAllocator", "Geometry", "Request",
    "RequestResult", "SERVE_KINDS", "ServeEngine", "ServeReport",
    "check_arch", "prompt_tokens", "run_host_loop", "serve_trace",
    "synthetic_trace",
]
