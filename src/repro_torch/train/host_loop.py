"""Host-driven per-step training loop — the port of
``repro/train/host_loop.py``: one ``make_train_step`` step dispatched per
iteration from a Python loop, with every batch built on the host.

It takes any step count (the epoch loop, ``train/loop.py``, drives whole
epochs only), and it runs on any process mesh (``launch/mesh.py``): the
(1, 1) test mesh of one rank, or the 2-D (data, model) and 3-D (pod,
data, model) meshes whose ranks each hold their shards of the state
(``train/step.py``). Every rank of the mesh calls it with the same
arguments.

The loop keeps each step's loss on the device and fetches them once at
the end (a log line fetches its step's). The held-out eval runs on the
worker-averaged params. A checkpoint gathers a sharded state to rank 0,
which writes it in the epoch loop's flat layout (``loop.save_state``).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data import synthetic
from repro_torch.train import step as tstep
from repro_torch.train.loop import LoopResult, save_state


def _epoch_batch_host(cfg, seed, step, *, workers, accum, microbatch, seq,
                      table_size):
    """One step's tokens (W, A, mb, S), built on the host one
    ``microbatch_tokens`` call per (worker, accum) pair: the block
    ``synthetic.epoch_tokens`` holds at the step's table row."""
    idx = step % table_size
    return torch.stack([
        torch.stack([synthetic.microbatch_tokens(cfg, seed, w,
                                                 idx * accum + a,
                                                 microbatch, seq)
                     for a in range(accum)])
        for w in range(workers)])


def _gathered_state(state, pl):
    """The full state on the CPU from every rank's shards (every rank
    calls this): the epoch loop's (W, N) layout."""
    full = lambda t: None if t is None else pl.gather_full(t)  # noqa: E731
    vr = state.vr_state
    if vr is not None:
        vr = type(vr)(table=[full(t) for t in vr.table], gbar=full(vr.gbar),
                      gtilde=full(vr.gtilde), snapshot=full(vr.snapshot),
                      idx=vr.idx)
    opt = state.opt_state
    if isinstance(opt, torch.Tensor):
        opt = full(opt)
    elif isinstance(opt, tuple) and hasattr(opt, "_fields"):
        opt = type(opt)(*(full(v) if isinstance(v, torch.Tensor) else v
                          for v in opt))
    return tstep.TrainState(full(state.params), opt, vr, state.step, None,
                            full(state.grad_snap), pl.layout.full
                            if pl.sharded else state.layout)


def _save(path, state, pl):
    full = _gathered_state(state, pl)
    if pl.mesh.rank == 0:
        save_state(path, full)


def run_training(cfg: ModelConfig, tcfg: TrainConfig, *, steps: int,
                 mesh=None, vr_workers: str = "none",
                 workers: Optional[int] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 log_every: int = 10,
                 log_fn: Callable[[str], None] = print, device=None,
                 fused=False, params=None, tokens=None,
                 eval_tokens=None) -> LoopResult:
    """Per-step training loop for ``steps`` steps (any count).

    ``mesh`` defaults to ``launch.mesh.make_test_mesh(device=device)``;
    ``workers`` simulates W stacked worker copies on the rank's device
    (default: the mesh-derived count). ``fused`` as
    ``step.make_train_step`` takes it. ``params``, ``tokens`` and
    ``eval_tokens`` replace the seeded initial params (a full tree), the
    epoch's token block (W, M*K, A, mb, S) — step s takes its column
    s % (M*K), as the epoch runner does — and the held-out batch; by
    default all three come from ``tcfg.seed``. ``checkpoint_path`` saves
    every ``checkpoint_every`` steps and at the end."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import model as modellib

    if mesh is None:
        mesh = meshlib.make_test_mesh(device=device)
    train_step, meta = tstep.make_train_step(cfg, tcfg, mesh, vr_workers,
                                             workers=workers, fused=fused,
                                             device=device)
    W, pl = meta["workers"], meta["placement"]
    accum, mb = meta["accum"], meta["microbatch"]
    E = meta["comm_every"]
    state = tstep.init_train_state(
        cfg, tcfg, W, params=params, device=mesh.device,
        **({} if workers is not None else dict(mesh=mesh,
                                               vr_workers=vr_workers)))
    if tokens is not None and not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))

    def batch_for(s):
        if tokens is not None:
            toks = tokens[:, s % E]
        else:
            toks = _epoch_batch_host(cfg, tcfg.seed, s, workers=W,
                                     accum=accum, microbatch=mb,
                                     seq=tcfg.seq_len,
                                     table_size=tcfg.vr_table_size)
        return toks[0] if W == 1 else toks

    result = LoopResult()
    t0 = time.time()
    device_losses = []
    for s in range(steps):
        state, metrics = train_step(state, batch_for(s))
        device_losses.append(metrics["loss"].detach())
        if log_every and (s % log_every == 0 or s == steps - 1):
            log_fn(f"step {s:5d}  loss {float(metrics['loss']):.4f}")
        if checkpoint_path and checkpoint_every and \
                (s + 1) % checkpoint_every == 0:
            _save(checkpoint_path, state, pl)
    result.losses = [float(x) for x in torch.stack(device_losses).cpu()]
    result.steps = steps
    result.wall_time = time.time() - t0
    result.state = state

    # held-out eval on the worker-AVERAGED params: mid-epoch the workers
    # have diverged, worker 0 alone is not the algorithm's iterate
    if eval_tokens is None:
        eval_tokens = synthetic.eval_batch(cfg, tcfg.seed, batch=mb,
                                           seq=tcfg.seq_len)
    if not isinstance(eval_tokens, torch.Tensor):
        eval_tokens = torch.from_numpy(np.asarray(eval_tokens))
    ev = eval_tokens.to(mesh.device, torch.int64)
    if pl.local_workers > 1:
        flat = tstep.eval_params(state.params, pl.local_workers)
    else:
        flat = pl.worker_mean_(state.params.clone())[0]
    with torch.no_grad(), pl.scope(cfg, split_rows=False):
        result.final_eval_loss = float(modellib.loss_fn(
            state.layout.views(flat), cfg, {"tokens": ev}, remat="none"))
    if checkpoint_path:
        _save(checkpoint_path, state, pl)
    return result
