"""Configuration of the convex problems (paper §6): the port's copy of
``repro.config.ConvexConfig``, field for field."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ConvexConfig:
    problem: str = "logistic"        # "logistic" | "ridge" | "huber" | ...
    n: int = 5000                    # samples (per worker in distributed runs)
    d: int = 20
    lam: float = 1e-4                # l2 regularizer (paper value)
    outlier_frac: float = 0.0        # label corruption rate (robust runs)
    huber_delta: float = 1.0         # Huber/pseudo-Huber transition scale
    learning_rate: float = 0.1
    epochs: int = 30
    seed: int = 0
    # distributed
    workers: int = 1
    method: str = "centralvr"        # core/ algorithm id
    tau: int = 0                     # communication period (0 -> one local epoch)
    async_mode: bool = False
