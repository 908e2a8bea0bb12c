"""Epoch-driven training loop of the port — ``repro/train/loop.py``.

Drives whole communication epochs (M*K steps each) through
``step.make_epoch_runner`` (unfused, as the reference's loop does), then
evaluates the held-out loss on the worker-averaged params. Checkpoints
and resume are not ported yet (ROADMAP.md queue 1, item 11).

With a recorder active (``repro_torch.obs``) the loop records, as the
reference's does: the first epoch through ``obs.staged_call``
(``train/epoch/execute``, with its device time and kernel launches),
every later epoch as a ``train/epoch`` span up to a sync, a
``train_epoch`` event per logged epoch, the ``train/eval`` span and a
``train_done`` event. Under the spmd backend only rank 0 records.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data import synthetic
from repro_torch.models import model as modellib
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import stage as obs_stage
from repro_torch.train import step as tstep


@dataclass
class LoopResult:
    losses: List[float] = field(default_factory=list)
    steps: int = 0
    epochs: int = 0
    wall_time: float = 0.0
    final_eval_loss: Optional[float] = None
    state: Any = None


def run_training(cfg: ModelConfig, tcfg: TrainConfig, *,
                 epochs: Optional[int] = None, steps: Optional[int] = None,
                 workers: int = 1, backend: str = "vmap",
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0, resume: bool = False,
                 log_every: int = 1,
                 log_fn: Callable[[str], None] = print, device=None,
                 params=None, tokens=None, eval_tokens=None,
                 group=None) -> LoopResult:
    """Train for whole communication epochs; ``steps`` may be given
    instead of ``epochs`` but must be a multiple of M*K.

    ``device``: None is the current CUDA device (raises without one).
    ``params``, ``tokens`` and ``eval_tokens`` replace the seeded initial
    params, the epoch's token block and the held-out batch (agreement
    tests pass the reference's); by default all three come from
    ``tcfg.seed``. ``backend="spmd"``: every rank of ``group`` (default
    the default process group's) calls this; each steps its own worker
    (``step.place_train_state``) and evaluates the averaged params.
    """
    if checkpoint_path or checkpoint_every or resume:
        raise NotImplementedError(
            "checkpoints and resume are not ported yet (ROADMAP.md queue 1, "
            "item 11)")
    E = tcfg.vr_table_size * tcfg.local_epoch
    if epochs is None:
        if steps is None:
            raise ValueError("pass epochs= or steps=")
        if steps % E:
            raise ValueError(
                f"steps={steps} is not a multiple of the communication "
                f"epoch M*K={E}; the epoch runtime drives whole epochs")
        epochs = steps // E
    run_epoch, meta = tstep.make_epoch_runner(cfg, tcfg, workers,
                                              backend=backend, device=device,
                                              tokens=tokens, group=group)
    W = meta["workers"]
    state = tstep.init_train_state(cfg, tcfg, W, params=params,
                                   device=meta["device"])
    if backend == "spmd" and W > 1:
        state = tstep.place_train_state(state, meta["group"])

    lead = backend != "spmd" or meta["group"].rank == 0
    rec = obs_recorder.active() if lead else None
    device = meta["device"]
    result = LoopResult()
    t0 = time.time()
    epoch_losses = []
    for e in range(epochs):
        if rec is None:
            state, losses = run_epoch(state)
        elif e == 0:
            state, losses = obs_stage.staged_call(
                run_epoch, state, _label="train/epoch", _device=device,
                _group=meta.get("group"))
        else:
            # synced inside the span, so its duration is the epoch's work
            with rec.span("train/epoch", epoch=e):
                state, losses = run_epoch(state)
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
        epoch_losses.append(losses)
        if log_every and (e % log_every == 0 or e == epochs - 1):
            loss = float(losses[-1])
            if rec is not None:
                rec.event("train_epoch", epoch=e, step=(e + 1) * E,
                          loss=loss, workers=W)
            log_fn(f"epoch {e:4d}  step {(e + 1) * E:6d}  "
                   f"loss {loss:.4f}")
    result.losses = [float(l) for l in torch.cat(epoch_losses).cpu()]
    result.steps = epochs * E
    result.epochs = epochs
    result.wall_time = time.time() - t0
    result.state = state

    # held-out eval on the worker-averaged params (at an epoch boundary the
    # copies coincide, so the average is every worker's iterate)
    if eval_tokens is None:
        eval_tokens = synthetic.eval_batch(cfg, tcfg.seed,
                                           batch=meta["microbatch"],
                                           seq=tcfg.seq_len)
    if not isinstance(eval_tokens, torch.Tensor):
        eval_tokens = torch.from_numpy(np.asarray(eval_tokens))
    ev = eval_tokens.to(state.params.device, torch.int64)
    with (rec.span("train/eval") if rec is not None
          else contextlib.nullcontext()):
        flat = tstep.eval_params(state.params, state.params.shape[0])
        with torch.no_grad():
            result.final_eval_loss = float(modellib.loss_fn(
                state.layout.views(flat), cfg, {"tokens": ev},
                remat="none"))
    if rec is not None:
        rec.event("train_done", epochs=epochs, steps=epochs * E,
                  eval_loss=result.final_eval_loss,
                  wall_s=result.wall_time)
    return result
