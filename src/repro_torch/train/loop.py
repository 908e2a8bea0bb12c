"""Epoch-driven training loop of the port — ``repro/train/loop.py``.

Drives whole communication epochs (M*K steps each) through
``step.make_epoch_runner`` (unfused unless the caller asks, as the
reference's loop runs it), then evaluates the held-out loss on the
worker-averaged params. ``checkpoint_path`` saves the state at epoch
boundaries (``checkpoint_every`` epochs, and at the end) and ``resume``
restarts from the latest save.

The checkpoint is the port's own flat layout, not the reference's tree:
the (W, N) params, the optimiser state, the VR state (each table row,
gbar, gtilde, svrg's snapshot and the row index), the step and svrg's
snapshot gradient, through ``checkpoint.checkpoint`` (bfloat16 as its
bits). The float32 gradient accumulator is scratch that every step
overwrites before it reads it; the manifest names it under ``scratch``
and it is not saved. Resuming writes into the fresh state's buffers, so
the views the model holds stay valid.

With a recorder active (``repro_torch.obs``) the loop records, as the
reference's does: the first epoch through ``obs.staged_call``
(``train/epoch/execute``, with its device time and kernel launches),
every later epoch as a ``train/epoch`` span up to a sync, a
``train_epoch`` event per logged epoch, a ``train/checkpoint`` span per
save (and ``train/restore`` for a resume), the ``train/eval`` span and a
``train_done`` event. Under the spmd backend only rank 0 records.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
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


def state_tree(state: tstep.TrainState) -> dict:
    """What the next epoch reads, as a checkpoint tree of the state's own
    tensors: params, optimiser state, VR state, step and svrg's snapshot
    gradient (``grad``, the accumulator, is scratch)."""
    vr = state.vr_state
    if vr is not None:
        vr = {"table": list(vr.table), "gbar": vr.gbar, "gtilde": vr.gtilde,
              "snapshot": vr.snapshot, "idx": vr.idx}
    return {"params": state.params, "opt_state": state.opt_state,
            "vr_state": vr, "step": state.step, "grad_snap": state.grad_snap}


def save_state(path: str, state: tstep.TrainState) -> int:
    """Save ``state`` at ``path`` (copied to the host before this
    returns); returns the bytes written."""
    return ckpt.save(path, state_tree(state), step=state.step,
                     extra={"layout": "repro_torch.train flat (W, N)",
                            "scratch": ["grad"]})


def restore_state(path: str, state: tstep.TrainState) -> tstep.TrainState:
    """Overwrite ``state``'s buffers (params, optimiser and VR state,
    ``grad_snap``) with the save at ``path`` in place, and take its step
    and row index; returns ``state``."""
    tree = ckpt.restore_into(path, state_tree(state))
    state.opt_state, state.step = tree["opt_state"], tree["step"]
    if state.vr_state is not None:
        state.vr_state.idx = tree["vr_state"]["idx"]
    return state


def run_training(cfg: ModelConfig, tcfg: TrainConfig, *,
                 epochs: Optional[int] = None, steps: Optional[int] = None,
                 workers: int = 1, backend: str = "vmap",
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0, resume: bool = False,
                 log_every: int = 1,
                 log_fn: Callable[[str], None] = print, device=None,
                 params=None, tokens=None, eval_tokens=None,
                 group=None, fused=False) -> LoopResult:
    """Train for whole communication epochs; ``steps`` may be given
    instead of ``epochs`` but must be a multiple of M*K.

    ``device``: None is the current CUDA device (raises without one).
    ``params``, ``tokens`` and ``eval_tokens`` replace the seeded initial
    params, the epoch's token block and the held-out batch (agreement
    tests pass the reference's); by default all three come from
    ``tcfg.seed``. ``backend="spmd"``: every rank of ``group`` (default
    the default process group's) calls this; each steps its own worker
    (``step.place_train_state``) and evaluates the averaged params.

    Cadences count EPOCHS. ``checkpoint_path`` saves the state every
    ``checkpoint_every`` epochs and at the end (each save replaces the
    last); ``resume=True`` restarts from its latest epoch-boundary save.
    ``result.losses`` holds the per-step losses of the epochs THIS call
    ran (after the resume point, if any). ``fused``: as
    ``step.make_epoch_runner`` takes it (the kernels' path).
    """
    if checkpoint_path and backend == "spmd" and workers > 1:
        raise ValueError(
            "checkpoint_path: the spmd backend holds one worker's VR state "
            "per rank, and this loop saves the stacked state of one "
            "process; checkpoint a backend='vmap' run")
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
                                              tokens=tokens, group=group,
                                              fused=fused)
    W = meta["workers"]
    state = tstep.init_train_state(cfg, tcfg, W, params=params,
                                   device=meta["device"])
    start_epoch = 0
    if resume and checkpoint_path:
        saved = ckpt.latest_step(checkpoint_path)
        if saved is not None:
            if saved % E:
                raise ValueError(
                    f"checkpoint at step {saved} is not an epoch boundary "
                    f"(M*K={E}); it was not written by the epoch loop")
            start_epoch = saved // E
            if start_epoch >= epochs:
                raise ValueError(
                    f"checkpoint is already at epoch {start_epoch} "
                    f"(step {saved}); nothing left of the requested "
                    f"{epochs} epoch(s) to train — raise epochs/steps "
                    "(continuing would relabel the checkpoint with an "
                    "earlier step)")
            with obs_recorder.span("train/restore", step=saved):
                restore_state(checkpoint_path, state)
    if backend == "spmd" and W > 1:
        state = tstep.place_train_state(state, meta["group"])

    lead = backend != "spmd" or meta["group"].rank == 0
    rec = obs_recorder.active() if lead else None
    device = meta["device"]
    result = LoopResult()
    t0 = time.time()
    epoch_losses = []
    saved_at = None
    for e in range(start_epoch, epochs):
        if rec is None:
            state, losses = run_epoch(state)
        elif e == start_epoch:
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
        if log_every and ((e - start_epoch) % log_every == 0
                          or e == epochs - 1):
            loss = float(losses[-1])
            if rec is not None:
                rec.event("train_epoch", epoch=e, step=(e + 1) * E,
                          loss=loss, workers=W)
            log_fn(f"epoch {e:4d}  step {(e + 1) * E:6d}  "
                   f"loss {loss:.4f}")
        if checkpoint_path and checkpoint_every and \
                (e + 1) % checkpoint_every == 0:
            with obs_recorder.span("train/checkpoint", epoch=e):
                save_state(checkpoint_path, state)
            saved_at = state.step
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
    if checkpoint_path and saved_at != state.step:
        with obs_recorder.span("train/checkpoint", epoch=epochs - 1):
            save_state(checkpoint_path, state)
    return result
