"""The LM epoch runner of the port — ``repro/train/step.py``'s
``make_epoch_runner`` with ``backend="vmap"`` and its helpers.

The CentralVR worker model: W worker copies of the model, each taking
local steps on its own shard of the finite sum, and at the end of every
communication epoch (M*K steps) the central average of the params and of
the anchor gbar (Algorithm 2, lines 16-18).

State is flat. One run allocates, once: params (W, N) in param_dtype, the
VR table (M rows of (W, N)), gbar and gtilde (W, N) in the same dtype,
and the float32 gradient accumulator (W, N). The model sees views of a
worker's row (``models.model.ParamLayout``), so no param-sized copy
flattens or unflattens anything. The workers' local steps run one after
another, which is exact: workers do not interact between exchanges. The
reference vmaps them; the port makes W the leading dimension of every
buffer, so the fused VR step (``vr_wrapper.apply``) is one K1 launch for
all workers.

``backend="spmd"``: one worker per process over ``torch.distributed``
(``launch/mesh.py``), as the reference's ``_epoch_runner_spmd``: each
rank holds its worker's flat params, VR state and optimiser state as
(1, N) buffers (``place_train_state``), and at the epoch boundary the
params, gbar and the losses are averaged across the ranks by all-reduce
(``core/spmd.py``'s collectives).

With ``fused`` on, each worker's forward and backward run under
``models.kernel_ctx`` (K2 RMSNorm, K3 flash attention for ``attn`` and
``local`` blocks, K4 SSD scan, relaunched by the ``remat="block"``
recompute), and with SGD the VR correction and update are one K1 launch
per step. The loss is the model's: next-token cross-entropy plus the
MoE load-balance loss, on the text tokens alone (the reference's runner
passes no frontend embeddings either).

``make_serve_step`` is the reference's serving pair: one lockstep decode
step and the prefill's last-position logits.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data import synthetic
from repro_torch.models import kernel_ctx, model
from repro_torch.optim import optimizers, vr_wrapper


@dataclass
class TrainState:
    """Flat training state of W workers; the runner updates it in place."""
    params: torch.Tensor            # (W, N), param_dtype
    opt_state: Any
    vr_state: Optional[vr_wrapper.VRState]
    step: int
    grad: torch.Tensor              # (W, N) float32 gradient accumulator
    grad_snap: Optional[torch.Tensor]   # (W, N), svrg's snapshot gradient
    layout: model.ParamLayout

    def param_tree(self, worker: int = 0):
        """Worker ``worker``'s params as a tree of views."""
        return self.layout.views(self.params[worker])


def batch_geometry(tcfg: TrainConfig, W: int):
    """(accum, microbatch) for W workers. An uneven split is a config
    error and raises."""
    if tcfg.microbatch:
        denom = W * tcfg.microbatch
        if tcfg.global_batch % denom:
            raise ValueError(
                f"global_batch={tcfg.global_batch} is not divisible by "
                f"workers*microbatch = {W}*{tcfg.microbatch} = {denom}; "
                "every worker must process the same number of whole "
                "microbatches per step")
        return tcfg.global_batch // denom, tcfg.microbatch
    if tcfg.global_batch % W:
        raise ValueError(
            f"global_batch={tcfg.global_batch} is not divisible by "
            f"workers={W}")
    return 1, max(tcfg.global_batch // W, 1)


def worker_average(buf: torch.Tensor) -> torch.Tensor:
    """Algorithm 2 lines 16-18: the central average over the leading worker
    axis, written back to every worker's row (in place)."""
    return buf.copy_(buf.mean(0, keepdim=True).expand_as(buf))


def group_average_(buf: torch.Tensor, group) -> torch.Tensor:
    """``worker_average`` across the ranks of ``group``: the all-reduce
    mean of each rank's (1, N) buffer, in place. A bfloat16 buffer is
    summed in float32 and rounded once, as ``mean`` rounds."""
    from repro_torch.core import spmd
    if buf.dtype in (torch.float32, torch.float64):
        return spmd.psum_(buf, group).div_(group.world)
    return buf.copy_(spmd.psum_(buf.float(), group).div_(group.world))


def eval_params(params: torch.Tensor, W: int) -> torch.Tensor:
    """The flat (N,) params for held-out eval: the central average of the
    W worker copies (between exchanges they have diverged)."""
    if W <= 1:
        return params[0]
    return params.mean(0).to(params.dtype)


def _local_grads(params_row, layout, cfg: ModelConfig, tcfg: TrainConfig,
                 tokens, out):
    """tokens: (A, mb, S). The gradient averaged over the A microbatches is
    written into ``out`` (N,) float32; returns the mean loss.

    Gradients are taken against a compute-dtype (bf16) copy of the
    params, made once per step, not per microbatch; each microbatch's
    gradient is accumulated into float32 as g/A."""
    A = tokens.shape[0]
    params_c = params_row.to(getattr(torch, cfg.dtype))
    leaves = [v.detach().requires_grad_()
              for v in layout.leaf_views(params_c)]
    tree = layout.unflatten(leaves)
    outs = layout.leaf_views(out)
    loss_acc = torch.zeros((), dtype=torch.float32, device=out.device)
    for a in range(A):
        loss = model.loss_fn(tree, cfg, {"tokens": tokens[a]},
                             remat=tcfg.remat)
        # a leaf the loss does not reach (the frontend stub's
        # frontend_proj: the runner feeds no frontend embeddings) has
        # gradient 0
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        for j, seg in enumerate(outs):
            if grads[j] is None:
                if a == 0:
                    seg.zero_()
            elif a == 0:
                seg.copy_(grads[j]).div_(A)
            else:
                seg.add_(grads[j].to(torch.float32) / A)
            grads[j] = None
        loss_acc = loss_acc + loss.detach() / A
    return loss_acc


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, W: int, *,
                     generator: Optional[torch.Generator] = None,
                     params=None, device=None) -> TrainState:
    """Fresh state of W identical workers: the params come from ``params``
    (a tree in the port's layout, e.g. ``convert.lm_params_from_jax``) or
    are drawn from ``generator`` (default: seeded with ``tcfg.seed`` on
    ``device``)."""
    from repro_torch.kernels import resolve_device
    device = resolve_device(device, "repro_torch.train")
    layout = model.ParamLayout(cfg)
    flat = torch.empty((W, layout.n), dtype=getattr(torch, cfg.param_dtype),
                       device=device)
    if params is not None:
        layout.load_(flat[0], params)
    else:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(tcfg.seed)
        layout.init_(flat[0], generator)
    flat[1:] = flat[0]
    opt = optimizers.make(tcfg.optimizer, tcfg.learning_rate,
                          tcfg.weight_decay)
    vr = (vr_wrapper.init_vr(tcfg.vr, flat, tcfg.vr_table_size)
          if tcfg.vr != "none" else None)
    grad = torch.empty(flat.shape, dtype=torch.float32, device=device)
    snap = torch.empty_like(grad) if tcfg.vr == "svrg" else None
    return TrainState(flat, opt.init(flat), vr, 0, grad, snap, layout)


def place_train_state(state: TrainState, group) -> TrainState:
    """This rank's slice of a W-stacked ``TrainState``, copied onto its
    device (the reference's ``place_train_state``): every (W, ...) buffer
    of params, optimiser state, VR state and accumulators becomes the
    rank's (1, ...) row."""
    r = group.rank
    W = state.params.shape[0]
    if W != group.world:
        raise ValueError(f"place_train_state: the state holds {W} workers "
                         f"but the group has {group.world} ranks")

    def put(t):
        if isinstance(t, torch.Tensor):
            return t[r:r + 1].to(group.device, copy=True)
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(put(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(put(v) for v in t)
        return t

    vr = state.vr_state
    if vr is not None:
        vr = vr_wrapper.VRState(table=put(vr.table), gbar=put(vr.gbar),
                                gtilde=put(vr.gtilde),
                                snapshot=put(vr.snapshot), idx=vr.idx)
    return TrainState(put(state.params), put(state.opt_state), vr,
                      state.step, put(state.grad), put(state.grad_snap),
                      state.layout)


def _check_kernel_shapes(cfg: ModelConfig):
    """Refuse, when the runner is built, a model whose shapes a kernel of
    the fused path does not take on the card (the forward would raise in
    its first step)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    kinds = set(cfg.layer_kinds())
    if kinds & {"attn", "local"} and cfg.attn_logit_softcap is None:
        fa_kernel.check_supported(cfg.head_dim, getattr(torch, cfg.dtype))
    if "ssm" in kinds:
        ssd_kernel.check_supported(cfg.ssm_chunk, cfg.ssm_state,
                                   cfg.ssm_head_dim)


def make_epoch_runner(cfg: ModelConfig, tcfg: TrainConfig, W: int, *,
                      backend: str = "vmap", fused=False, device=None,
                      tokens=None, group=None):
    """One whole communication epoch (M*K steps) per call:
    ``run_epoch(state) -> (state, (M*K,) losses)``, with the Algorithm-2
    worker average at the epoch boundary. ``state`` is updated in place
    and returned; ``state.step`` must be a multiple of M*K.

    ``backend="vmap"``: the W workers on one device (their buffers
    stacked). ``"spmd"``: one worker per rank of ``group`` (a
    ``launch.mesh.WorkerGroup`` of W ranks; default the default process
    group's), each rank calling this with the same arguments and running
    its worker on its device with state of (1, N) buffers
    (``place_train_state``); at the epoch boundary the params, gbar and
    the losses are averaged across the ranks. W = 1 is the vmap runner on
    the rank's device, as in the reference. ``meta["group"]`` is the
    group.

    ``fused``: False | True | "auto", as in ``repro_torch.solve``. True
    runs the kernels: on CUDA tensors the hand-written kernels, or an
    error; on CPU tensors their plain versions. "auto" fuses only on a
    Hopper card. The fused VR step bakes a plain SGD update: forcing it
    with a stateful optimizer is an error, while "auto" then fuses only
    the model forward.

    ``tokens``: the epoch's token block (W, M*K, A, mb, S), replayed every
    epoch (the finite sum); default ``synthetic.epoch_tokens`` from
    ``tcfg.seed``; under spmd drawn once and sliced per rank.
    ``device``: None is the current CUDA device (raises without one); the
    rank's device under spmd.
    """
    from repro_torch import kernels

    if backend not in ("vmap", "spmd"):
        raise ValueError(f"unknown backend {backend!r}: "
                         "expected 'vmap' or 'spmd'")
    if backend == "spmd":
        if group is None:
            from repro_torch.launch import mesh
            group = mesh.make_worker_mesh(W)
        if group.world != W:
            raise ValueError(
                f"worker mesh has {group.world} devices but W={W}; the spmd "
                "epoch runtime places exactly one worker per device")
        if device is not None and torch.device(device) != group.device:
            raise ValueError(f"make_epoch_runner: device={device!r}, but "
                             f"this rank runs on {group.device}")
        device = group.device
    elif group is not None:
        raise ValueError("make_epoch_runner: group= is the worker group of "
                         "backend='spmd'")
    device = kernels.resolve_device(device, "repro_torch.train")
    fuse_on = kernels.resolve_fused(fused, device)
    if (fused is True and tcfg.vr != "none"
            and tcfg.optimizer != "sgd"):
        raise ValueError(
            f"fused=True: the fused VR step bakes a plain SGD update, but "
            f"optimizer={tcfg.optimizer!r}; use optimizer='sgd' or "
            "fused='auto' (which fuses only the model forward)")
    if fuse_on and device.type == "cuda":
        _check_kernel_shapes(cfg)
    M = tcfg.vr_table_size
    E = M * tcfg.local_epoch
    accum, mb = batch_geometry(tcfg, W)
    mode = tcfg.vr
    meta = {"workers": W, "comm_every": E, "accum": accum,
            "microbatch": mb, "backend": backend,
            "grads_per_step": vr_wrapper.grads_per_step(mode),
            "vr_storage_mult": vr_wrapper.storage_multiplier(mode, M),
            "fused": fuse_on, "device": str(device)}
    if backend == "spmd":
        meta["group"] = group

    if tokens is None:
        tokens = synthetic.epoch_tokens(
            cfg, tcfg.seed, workers=W, steps=E, accum=accum, microbatch=mb,
            seq=tcfg.seq_len, table_size=M)
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    tokens = tokens.to(device, torch.int64)
    want = (W, E, accum, mb, tcfg.seq_len)
    if tuple(tokens.shape) != want:
        raise ValueError(f"tokens has shape {tuple(tokens.shape)}, the run "
                         f"needs (W, M*K, A, mb, S) = {want}")
    # the workers this process steps: W stacked, or its rank's one
    spmd_run = backend == "spmd" and W > 1
    if spmd_run:
        tokens = tokens[group.rank:group.rank + 1]
    nw = 1 if spmd_run else W

    opt = optimizers.make(tcfg.optimizer, tcfg.learning_rate,
                          tcfg.weight_decay)
    fuse_vr = fuse_on and mode != "none" and tcfg.optimizer == "sgd"

    def train_step(state: TrainState, toks, idx: int):
        ctx = kernel_ctx.scope(True) if fuse_on else contextlib.nullcontext()
        vr = state.vr_state
        with ctx:
            losses = []
            for w in range(nw):
                losses.append(_local_grads(state.params[w], state.layout,
                                           cfg, tcfg, toks[w],
                                           state.grad[w]))
                if mode == "svrg":
                    _local_grads(vr.snapshot[w], state.layout, cfg, tcfg,
                                 toks[w], state.grad_snap[w])
        # the table row that ``g`` replaces is the next step's accumulator
        # when the row is rebound to ``g`` (float32 rows); a bfloat16 row
        # takes a rounded copy of ``g`` and the accumulator stays
        spare = vr.table[idx] if vr is not None and vr.table else None
        if fuse_vr:
            vr_wrapper.apply(mode, vr, state.grad, M, lr=tcfg.learning_rate,
                             g_snap=state.grad_snap, params=state.params,
                             idx=idx)
        else:
            if mode != "none":
                v, _ = vr_wrapper.correct(mode, vr, state.grad, M,
                                          g_snap=state.grad_snap,
                                          params=state.params, idx=idx)
            else:
                v = state.grad
            updates, state.opt_state = opt.update(v, state.opt_state,
                                                  state.params)
            optimizers.apply_updates(state.params, updates)
        if spare is not None and vr.table[idx] is not spare:
            state.grad = spare
        return torch.stack(losses).mean()

    def run_epoch(state: TrainState):
        if state.step % E:
            raise ValueError(f"state.step={state.step} is not at an epoch "
                             f"boundary (M*K={E})")
        if state.params.shape[0] != nw:
            raise ValueError(
                f"the state holds {state.params.shape[0]} workers, this "
                f"runner steps {nw}"
                + (" (its rank's; place_train_state)" if spmd_run else ""))
        losses = torch.stack([train_step(state, tokens[:, s],
                                         (state.step + s) % M)
                              for s in range(E)])
        state.step += E
        if spmd_run:
            group_average_(state.params, group)
            if mode != "none":
                group_average_(state.vr_state.gbar, group)
            group_average_(losses, group)
        elif W > 1:
            worker_average(state.params)
            if mode != "none":
                worker_average(state.vr_state.gbar)
        return state, losses

    return run_epoch, meta


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig):
    """(serve_step, serve_prefill), without autograd: ``serve_step(params,
    token, cache, pos)`` is ``model.decode_step``; ``serve_prefill(params,
    tokens, fe=None)`` returns the last position's logits (B, vocab), as
    the reference's does (all (B, S, vocab) logits are not kept)."""
    @torch.no_grad()
    def serve_step(params, token, cache, pos):
        return model.decode_step(params, cfg, token, cache, pos)

    @torch.no_grad()
    def serve_prefill(params, tokens, fe=None):
        batch = {"tokens": tokens}
        if fe is not None:
            batch["frontend_embeds"] = fe
        logits, _ = model.forward(params, cfg, batch, remat="none")
        return logits[:, -1]

    return serve_step, serve_prefill
