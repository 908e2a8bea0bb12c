"""Deterministic synthetic request traces for serving benchmarks/tests —
the port's copy of ``repro/serve/trace.py``: numpy ``RandomState`` draws,
so its requests and prompts are the reference's bit for bit.

The continuous-batching scheduler is clocked by the DECODE-STEP counter,
not wall time: a request with ``arrival = a`` becomes visible once the
engine has executed ``a`` decode steps.  That makes every benchmark row
and equivalence test exactly reproducible — same trace, same admission
order, same token streams — while still exercising real churn (lanes
retiring and admitting mid-flight).

Arrival patterns:
  * ``burst``   — everything arrives at step 0 (queueing-dominated);
  * ``uniform`` — one request every ``gap`` steps (steady state);
  * ``poisson`` — exponential inter-arrivals from a seeded RandomState
                  with mean ``gap`` (bursty but reproducible).

Prompt token ids are derived per-request from (seed, rid), independent of
trace order, so sequential and batched servings of the same request see
identical prompts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

ARRIVAL_PATTERNS = ("burst", "uniform", "poisson")


@dataclass(frozen=True)
class Request:
    rid: int
    arrival: int            # decode-step clock at which it becomes visible
    prompt_len: int
    max_new: int            # greedy tokens to generate (>= 1)
    seed: int = 0

    def __post_init__(self):
        if self.prompt_len < 1 or self.max_new < 1:
            raise ValueError(f"request {self.rid}: prompt_len and max_new "
                             "must be >= 1")

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new


def prompt_tokens(req: Request, vocab: int) -> np.ndarray:
    """(prompt_len,) int32, a pure function of (seed, rid)."""
    rs = np.random.RandomState((req.seed * 1_000_003 + req.rid) % (2 ** 31))
    return rs.randint(0, vocab, size=req.prompt_len).astype(np.int32)


def synthetic_trace(n: int, *, pattern: str = "burst", prompt_len: int = 32,
                    max_new: int = 16, gap: int = 4, vary_new: bool = False,
                    prompt_lens: Optional[Sequence[int]] = None,
                    seed: int = 0) -> List[Request]:
    """n requests with deterministic arrivals.  ``vary_new`` cycles max_new
    over {max_new, 3/4, 1/2, 1/4 of it} so lanes retire at different steps
    (the case continuous batching wins on); ``prompt_lens`` overrides the
    uniform prompt length per request (cycled)."""
    if pattern not in ARRIVAL_PATTERNS:
        raise ValueError(f"pattern {pattern!r} not in {ARRIVAL_PATTERNS}")
    rs = np.random.RandomState(seed % (2 ** 31) + 17)
    arrivals: List[int] = []
    t = 0.0
    for i in range(n):
        if pattern == "burst":
            arrivals.append(0)
        elif pattern == "uniform":
            arrivals.append(i * gap)
        else:
            arrivals.append(int(t))
            t += rs.exponential(scale=max(gap, 1))
    news = [max(1, max_new * f // 4) for f in (4, 3, 2, 1)]
    out = []
    for i, a in enumerate(arrivals):
        pl = prompt_lens[i % len(prompt_lens)] if prompt_lens else prompt_len
        mn = news[i % 4] if vary_new else max_new
        out.append(Request(rid=i, arrival=a, prompt_len=int(pl),
                           max_new=int(mn), seed=seed))
    return out
