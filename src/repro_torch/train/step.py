"""The LM step factories of the port — ``repro/train/step.py``: the
epoch runner ``make_epoch_runner`` (``backend="vmap"`` and ``"spmd"``),
the per-step ``make_train_step`` on a process mesh, and their helpers.

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

``make_train_step`` is one step on a ``launch.mesh.ProcessMesh`` (the
reference's, under GSPMD, on a ``jax.sharding.Mesh``). Each rank holds
its local shards of every leaf (``sharding/specs.py``: FSDP over 'data'
unless ``dp_replicated``, tensor parallelism over 'model') as flat
(W_local, N_local) buffers over a :class:`ShardedLayout`, so K1 stays one
launch a step, over the rank's shard. The FSDP leaves are gathered where
the blocks use them (``sharding/gather_ctx.py``) and their gradients
reduce-scattered back; the rest of the gradient is all-reduced over the
batch axes, and the loss is the global-batch mean. CentralVR workers on
the mesh's 'data' (or 'pod') axis are averaged over those axes at every
epoch boundary (Algorithm 2, lines 16-18). Collectives are explicit, in
the open (``core/spmd.py``), not PyTorch's FSDP or DTensor wrappers: the
trainer's state is the flat buffers the VR step updates in place.

``make_serve_step`` is the reference's serving pair: one lockstep decode
step and the prefill's last-position logits.
"""
from __future__ import annotations

import contextlib
import functools
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
                     params=None, device=None, mesh=None,
                     vr_workers: str = "none") -> TrainState:
    """Fresh state of W identical workers: the params come from ``params``
    (a tree in the port's layout, e.g. ``convert.lm_params_from_jax``) or
    are drawn from ``generator`` (default: seeded with ``tcfg.seed`` on
    ``device``). On ``device="meta"`` nothing is allocated or drawn.

    With ``mesh`` (a ``launch.mesh.ProcessMesh``), the state of this
    rank in ``make_train_step(cfg, tcfg, mesh, vr_workers)``: its local
    shards (W is then the run's worker count, of which the rank holds its
    own when the workers lie on mesh axes). Each full leaf is drawn (or
    taken from ``params``) one at a time and only the rank's shard kept,
    so the params equal the unsharded ones and a rank's peak is its
    shards plus one leaf."""
    from repro_torch.kernels import resolve_device
    if mesh is not None:
        pl = placement(cfg, tcfg, mesh, vr_workers, W)
        device = mesh.device if device is None else device
        if torch.device(device) != mesh.device:
            raise ValueError(f"init_train_state: device={device!r}, but "
                             f"this rank runs on {mesh.device}")
        layout, W = pl.layout, pl.local_workers
    else:
        layout = model.ParamLayout(cfg)
    device = resolve_device(device, "repro_torch.train")
    flat = torch.empty((W, layout.n), dtype=getattr(torch, cfg.param_dtype),
                       device=device)
    if device.type == "meta":
        pass
    elif params is not None:
        layout.load_(flat[0], params)
    else:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(tcfg.seed)
        layout.init_(flat[0], generator)
    if device.type != "meta":
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


def _make_per_worker(cfg: ModelConfig, tcfg: TrainConfig, fuse_on: bool,
                     grads=None):
    """One step of the workers a process holds — gradients, then the VR
    correction and the optimizer, or with ``fuse_on`` and SGD the one K1
    launch over all of them — shared by the epoch runner and
    ``make_train_step``, as the reference's ``_make_per_worker`` is: the
    execution models differ, the math must not.

    ``per_worker(state, toks, idx) -> loss``: ``toks`` (W_local, A, mb,
    S), ``idx`` the step's table row; ``state`` is updated in place.
    ``grads(row, layout, toks, out) -> loss`` writes one worker's gradient
    into ``out`` (default ``_local_grads``; the sharded step's adds its
    reductions over the mesh)."""
    M = tcfg.vr_table_size
    mode = tcfg.vr
    opt = optimizers.make(tcfg.optimizer, tcfg.learning_rate,
                          tcfg.weight_decay)
    fuse_vr = fuse_on and mode != "none" and tcfg.optimizer == "sgd"
    if grads is None:
        def grads(row, layout, toks, out):
            return _local_grads(row, layout, cfg, tcfg, toks, out)

    def per_worker(state: TrainState, toks, idx: int):
        ctx = kernel_ctx.scope(True) if fuse_on else contextlib.nullcontext()
        vr = state.vr_state
        with ctx:
            losses = []
            for w in range(state.params.shape[0]):
                losses.append(grads(state.params[w], state.layout, toks[w],
                                    state.grad[w]))
                if mode == "svrg":
                    grads(vr.snapshot[w], state.layout, toks[w],
                          state.grad_snap[w])
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

    return per_worker


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

    train_step = _make_per_worker(cfg, tcfg, fuse_on)

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
# The per-step runtime on a process mesh
# ---------------------------------------------------------------------------

def _leaf_paths(tree, prefix=""):
    """The path string of each leaf of a layout tree, by leaf number."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(_leaf_paths(v, path))
        else:
            out[v] = path
    return out


class ShardedLayout(model.ParamLayout):
    """A :class:`models.model.ParamLayout` over one mesh position's local
    shards: each leaf's spec (``sharding/specs.py``; FSDP over 'data'
    when ``fsdp``, tensor parallel over 'model', an axis that does not
    divide its dim dropped), its slice of the full leaf and its local
    shape, laid out in the full layout's leaf order. ``axis_names`` /
    ``shape`` are the mesh's, ``coords`` the position's."""

    def __init__(self, cfg: ModelConfig, axis_names, shape, coords, *,
                 fsdp: bool):
        from repro_torch.sharding import specs
        full = model.ParamLayout(cfg)
        self.full = full
        self.tree, self.inits = full.tree, full.inits
        self.axis_names, self.mesh_shape = tuple(axis_names), tuple(shape)
        self.coords = tuple(coords)
        sizes = dict(zip(self.axis_names, self.mesh_shape))
        paths = _leaf_paths(full.tree)
        self.paths = [paths[j] for j in range(len(full.shapes))]
        self.specs = [specs.leaf_spec(path, shp, cfg,
                                      fsdp_axis="data" if fsdp else None,
                                      axis_sizes=sizes)
                      for path, shp in zip(self.paths, full.shapes)]
        self.slices = self.slices_at(self.coords)
        self.shapes, self.offsets, self.n = [], [], 0
        for sl in self.slices:
            shp = torch.Size(x.stop - x.start for x in sl)
            self.shapes.append(shp)
            self.offsets.append(self.n)
            self.n += shp.numel()

    def _axes(self, ax):
        if ax is None:
            return ()
        return (ax,) if isinstance(ax, str) else tuple(ax)

    def slices_at(self, coords):
        """Each leaf's slice of the full leaf at mesh position ``coords``."""
        out = []
        for spec, shp in zip(self.specs, self.full.shapes):
            sl = []
            for dim, ax in zip(shp, spec):
                parts, i = 1, 0
                for a in self._axes(ax):
                    k = self.axis_names.index(a)
                    parts *= self.mesh_shape[k]
                    i = i * self.mesh_shape[k] + coords[k]
                step = dim // parts
                sl.append(slice(i * step, (i + 1) * step))
            out.append(tuple(sl))
        return out

    def init_(self, flat: torch.Tensor, generator: torch.Generator):
        """The rank's shards of the params the full layout draws from
        ``generator``: each full leaf drawn in layout order, its shard
        kept."""
        for view, shp, init, sl in zip(self.leaf_views(flat),
                                       self.full.shapes, self.inits,
                                       self.slices):
            full = torch.empty(shp, dtype=flat.dtype, device=flat.device)
            view.copy_(model.fill_(full, init, generator)[sl])
        return flat

    def load_(self, flat: torch.Tensor, params):
        """The rank's shards of a full params tree."""
        views = self.leaf_views(flat)

        def put(j, value):
            value = torch.as_tensor(value)
            if value.shape != self.full.shapes[j]:
                raise ValueError(f"param {j}: shape {tuple(value.shape)}, "
                                 f"layout has {tuple(self.full.shapes[j])}")
            views[j].copy_(value[self.slices[j]])
        model.tree_zip(put, self.tree, params)
        return flat

    def shard_tree(self, params, device=None):
        """The rank's params tree from a full one: each leaf's slice, a
        copy of its own where the slice is a proper part (so the full leaf
        can be freed), on ``device`` (the leaf's own by default)."""
        leaves = [None] * len(self.shapes)

        def put(j, value):
            value = torch.as_tensor(value)
            if value.shape != self.full.shapes[j]:
                raise ValueError(
                    f"param {j}: shape {tuple(value.shape)}, the layout has "
                    f"{tuple(self.full.shapes[j])}")
            if value.shape != self.shapes[j]:
                value = value[self.slices[j]].clone()
            leaves[j] = value.to(device) if device is not None else value
        model.tree_zip(put, self.tree, params)
        return self.unflatten(leaves)

    def sharded_over(self, axis: str):
        """Leaf numbers whose spec splits them over ``axis``."""
        return [j for j, spec in enumerate(self.specs)
                if any(axis in self._axes(a) for a in spec)]

    def scatter_into(self, full_flat: torch.Tensor, local: torch.Tensor,
                     coords):
        """Write the local flat buffer of mesh position ``coords`` into its
        place in the full flat buffer (N,)."""
        fviews = self.full.leaf_views(full_flat)
        for j, sl in enumerate(self.slices_at(coords)):
            shp = torch.Size(x.stop - x.start for x in sl)
            o = self.offsets[j]
            fviews[j][sl] = local[o:o + shp.numel()].view(shp)
        return full_flat


def _ranges(layout, leaves):
    """The (offset, length) runs of ``leaves`` in the flat buffer, with
    adjacent runs merged."""
    runs = []
    for j in sorted(leaves):
        o, n = layout.offsets[j], layout.shapes[j].numel()
        if runs and runs[-1][0] + runs[-1][1] == o:
            runs[-1][1] += n
        else:
            runs.append([o, n])
    return [tuple(r) for r in runs]


@dataclass
class Placement:
    """Where a run of ``make_train_step`` puts its state on the mesh, and
    the collectives that follow from it: ``workers`` W in all,
    ``local_workers`` on this rank, the axes they lie on, the batch axes
    (the data axes that are no worker axis, which split every
    microbatch's rows), and whether the FSDP gather is engaged."""

    mesh: Any
    layout: Any
    workers: int
    local_workers: int
    worker_axes: tuple
    batch_axes: tuple
    gather: bool
    sharded: bool

    def scope(self, cfg: ModelConfig, split_rows: bool = True):
        """The step's forward and backward context: the weight gather over
        'data' and tensor parallelism over 'model', where they apply.
        ``split_rows``: the batch's rows are split over the batch axes
        (False for a batch every rank holds whole, the held-out eval's)."""
        from repro_torch.launch import mesh as meshlib
        from repro_torch.sharding import gather_ctx, tp
        stack = contextlib.ExitStack()
        if self.sharded:
            if self.gather:
                stack.enter_context(gather_ctx.scope(
                    self.mesh, cfg, meshlib.mesh_axis_sizes(self.mesh)))
            stack.enter_context(tp.scope(
                self.mesh, cfg, self.batch_axes if split_rows else ()))
        return stack

    @functools.cached_property
    def _reductions(self):
        """(axes, runs): the leaves whose gradient the backward already
        summed over 'data' (FSDP's reduce-scatter) are summed over the
        other batch axes, the rest over all of them."""
        lay = self.layout
        fsdp = set(lay.sharded_over("data")) if self.gather else set()
        rest = set(range(len(lay.shapes))) - fsdp
        return [(tuple(a for a in self.batch_axes if a != "data"),
                 _ranges(lay, fsdp)),
                (self.batch_axes, _ranges(lay, rest))]

    def reduce_grads_(self, out: torch.Tensor) -> torch.Tensor:
        """One worker's local gradient (N_local,) made the global-batch
        mean's: summed over the batch axes, divided by their size."""
        from repro_torch.core import spmd
        count = self.mesh.count(self.batch_axes) if self.sharded else 1
        if count == 1:
            return out
        for axes, runs in self._reductions:
            g = self.mesh.group(axes)
            if g.world == 1 or not runs:
                continue
            if runs == [(0, out.numel())]:
                spmd.psum_(out, g)
                continue
            buf = torch.cat([out[o:o + n] for o, n in runs])
            spmd.psum_(buf, g)
            i = 0
            for o, n in runs:
                out[o:o + n].copy_(buf[i:i + n])
                i += n
        return out.div_(count)

    def local_tokens(self, tokens, device, accum: int, mb: int, seq: int):
        """This rank's (W_local, A, mb_local, S) slice of the global token
        block: (W, A, mb, S) when W > 1, else (A, mb, S)."""
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        W = self.workers
        want = ((W,) if W > 1 else ()) + (accum, mb, seq)
        if tuple(tokens.shape) != want:
            raise ValueError(f"tokens has shape {tuple(tokens.shape)}, the "
                             f"step needs {want}")
        toks = tokens.to(device, torch.int64)
        if W == 1:
            toks = toks[None]
        if self.local_workers < W:
            w = self.mesh.index(self.worker_axes)
            toks = toks[w:w + 1]
        if self.sharded:
            B = self.mesh.count(self.batch_axes)
            if mb % B:
                raise ValueError(
                    f"microbatch {mb} does not split over the batch axes "
                    f"{self.batch_axes} ({B} ranks); every rank takes the "
                    "same number of rows")
            b, n = self.mesh.index(self.batch_axes), mb // B
            toks = toks[:, :, b * n:(b + 1) * n]
        return toks

    def worker_mean_(self, buf: torch.Tensor) -> torch.Tensor:
        """Algorithm 2's central average of ``buf`` (W_local, N_local) over
        the workers, in place."""
        if self.local_workers > 1:
            return worker_average(buf)
        g = self.mesh.group(self.worker_axes)
        return group_average_(buf, g) if g.world > 1 else buf

    def loss_mean(self, loss: torch.Tensor) -> torch.Tensor:
        """The step's loss averaged over the data axes' ranks (workers and
        batch rows): the global mean."""
        from repro_torch.core import spmd
        g = self.mesh.group(("pod", "data")) if self.sharded else None
        if g is None or g.world == 1:
            return loss
        return spmd.psum_(loss.reshape(1).clone(), g)[0] / g.world

    def gather_full(self, buf: torch.Tensor) -> torch.Tensor:
        """The full (W, N) buffer on the CPU from every rank's (W_local,
        N_local) ``buf``; every rank calls this."""
        from repro_torch.core import spmd
        from repro_torch.launch import mesh as meshlib
        if not self.sharded or self.mesh.size == 1:
            return buf.detach().cpu()
        mesh, lay = self.mesh, self.layout
        parts = spmd.all_gather(buf.contiguous(), mesh.group(
            mesh.axis_names)).cpu()
        full = torch.zeros((self.workers, lay.full.n), dtype=buf.dtype)
        for q in range(mesh.size):
            coords = meshlib.unravel(q, mesh.shape)
            if self.local_workers < self.workers:
                w = 0
                for a in self.worker_axes:
                    k = mesh.axis_names.index(a)
                    w = w * mesh.shape[k] + coords[k]
                rows = [(w, 0)]
            else:
                rows = [(w, w) for w in range(self.workers)]
            for w, lw in rows:
                lay.scatter_into(full[w], parts[q, lw], coords)
        return full


def placement(cfg: ModelConfig, tcfg: TrainConfig, mesh,
              vr_workers: str = "none", W: Optional[int] = None, *,
              workers: Optional[int] = None) -> Placement:
    """The :class:`Placement` of ``make_train_step(cfg, tcfg, mesh,
    vr_workers, workers=workers)``. ``W``, when given, must be its worker
    count. A MoE arch on a 'model' axis above one holds its experts and
    router columns split over 'model' (``models/moe.py``). Raises for
    workers on a 'data' axis above one without ``dp_replicated`` (each
    such worker holds a whole model copy, which the reference's specs
    cannot place either)."""
    from repro_torch.launch import mesh as meshlib
    mode = tcfg.vr
    if workers is not None:
        # W stacked copies on the rank's device, replicated: the epoch
        # runner's layout, no collectives
        pl = Placement(mesh, model.ParamLayout(cfg), workers, workers, (),
                       (), False, False)
    else:
        sizes = meshlib.mesh_axis_sizes(mesh)
        w_axes = (meshlib.worker_axes(mesh, vr_workers)
                  if mode != "none" else ())
        n = (meshlib.worker_count(mesh, vr_workers) if mode != "none"
             else 1)
        if ("data" in w_axes and sizes.get("data", 1) > 1
                and not tcfg.dp_replicated):
            raise ValueError(
                "vr_workers='data' puts one CentralVR worker, a whole model "
                "copy, on each 'data' group: pass dp_replicated=True (FSDP "
                "over 'data' would shard the workers' own axis)")
        gather = (not tcfg.dp_replicated and "data" in mesh.axis_names
                  and mesh.size > 1 and "data" not in w_axes)
        batch = tuple(a for a in ("pod", "data")
                      if a in mesh.axis_names and a not in w_axes)
        layout = ShardedLayout(cfg, mesh.axis_names, mesh.shape, mesh.coords,
                               fsdp=not tcfg.dp_replicated)
        pl = Placement(mesh, layout, n, 1 if w_axes else n, w_axes, batch,
                       gather, True)
    if W is not None and W != pl.workers:
        raise ValueError(f"W={W}, but this placement holds {pl.workers} "
                         f"worker(s) (vr_workers={vr_workers!r})")
    return pl


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    vr_workers: str = "none", *,
                    workers: Optional[int] = None, fused=False,
                    device=None):
    """One training step on a process mesh: returns ``(train_step(state,
    tokens, idx=None) -> (state, {"loss"}), meta)``, as the reference's.

    W comes from the mesh (``launch.mesh.worker_count(mesh,
    vr_workers)`` when ``tcfg.vr != "none"``, else 1), or from the
    explicit ``workers``: W stacked copies on the rank's device, as the
    epoch runner's ``backend="vmap"`` holds them (nothing sharded, no
    collective). ``mesh`` defaults to ``launch.mesh.make_test_mesh()``;
    every rank of it calls this and every step with the same arguments.

    ``state`` comes from ``init_train_state(cfg, tcfg, W, mesh=mesh,
    vr_workers=vr_workers)`` (explicit workers: without ``mesh``) and is
    updated in place. ``tokens`` is the GLOBAL batch, (W, A, mb, S) when
    W > 1 else (A, mb, S): the rank takes its worker's rows and its share
    of each microbatch along the batch axes. ``idx`` is the table row
    (default ``state.step % M``). The loss is the mean over every worker
    and row. At every epoch boundary (step + 1 a multiple of M*K) the
    params and gbar are averaged over the workers.

    The FSDP weight gather (``sharding/gather_ctx.py``) engages where the
    reference's does: no explicit ``workers``, not ``dp_replicated``, a
    'data' axis on a mesh of more than one rank, and 'data' no worker
    axis. ``fused`` and ``device`` as in ``make_epoch_runner``; ``device``
    must be the mesh's. ``meta["placement"]`` is the :class:`Placement`.
    """
    from repro_torch import kernels
    from repro_torch.launch import mesh as meshlib

    if mesh is None:
        mesh = meshlib.make_test_mesh(device=device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"make_train_step: device={device!r}, but this "
                         f"rank runs on {mesh.device}")
    device = mesh.device
    fuse_on = kernels.resolve_fused(fused, device)
    if (fused is True and tcfg.vr != "none"
            and tcfg.optimizer != "sgd"):
        raise ValueError(
            f"fused=True: the fused VR step bakes a plain SGD update, but "
            f"optimizer={tcfg.optimizer!r}; use optimizer='sgd' or "
            "fused='auto' (which fuses only the model forward)")
    if fuse_on and device.type == "cuda":
        _check_kernel_shapes(cfg)
    pl = placement(cfg, tcfg, mesh, vr_workers, workers=workers)
    W, mode, M = pl.workers, tcfg.vr, tcfg.vr_table_size
    E = M * tcfg.local_epoch
    accum, mb = batch_geometry(tcfg, W)

    def grads(row, layout, toks, out):
        with pl.scope(cfg):
            loss = _local_grads(row, layout, cfg, tcfg, toks, out)
        pl.reduce_grads_(out)
        return loss

    per_worker = _make_per_worker(cfg, tcfg, fuse_on,
                                  grads if pl.sharded else None)

    def train_step(state: TrainState, tokens, idx: Optional[int] = None):
        if state.params.shape[0] != pl.local_workers:
            raise ValueError(
                f"the state holds {state.params.shape[0]} workers, this "
                f"step runs {pl.local_workers} on this rank")
        toks = pl.local_tokens(tokens, device, accum, mb, tcfg.seq_len)
        loss = per_worker(state, toks, state.step % M if idx is None
                          else idx)
        if W > 1 and (state.step + 1) % E == 0:
            # average x and gbar across the workers; tables and
            # accumulators stay local
            pl.worker_mean_(state.params)
            if mode != "none":
                pl.worker_mean_(state.vr_state.gbar)
        state.step += 1
        return state, {"loss": pl.loss_mean(loss)}

    meta = {"workers": W, "comm_every": E, "accum": accum,
            "microbatch": mb, "local_workers": pl.local_workers,
            "grads_per_step": vr_wrapper.grads_per_step(mode),
            "vr_storage_mult": vr_wrapper.storage_multiplier(mode, M),
            "fused": fuse_on, "device": str(device), "mesh": mesh,
            "placement": pl}
    return train_step, meta


def eval_shape_train_state(cfg: ModelConfig, tcfg: TrainConfig, W: int):
    """The state's shapes and dtypes on ``torch.device("meta")``: nothing
    allocated (the dry run's)."""
    return init_train_state(cfg, tcfg, W, device="meta")


def state_shardings(state_shapes: TrainState, cfg: ModelConfig,
                    tcfg: TrainConfig, mesh, vr_workers: str):
    """The spec of every param leaf of ``state_shapes`` (from
    ``eval_shape_train_state``) on ``mesh``, as a params tree: a leading
    worker dim on the worker axes when W > 1. Every param-shaped buffer
    of the state (VR table rows, gbar, gtilde, snapshot, optimizer
    moments, the gradient) is placed as the params are."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.sharding import specs
    w_axes = (meshlib.worker_axes(mesh, vr_workers)
              if tcfg.vr != "none" else ())
    W = state_shapes.params.shape[0]
    layout = state_shapes.layout
    lead = (W,) if W > 1 else ()
    shapes = model.tree_map(
        lambda j: torch.empty(lead + tuple(layout.shapes[j]), device="meta"),
        layout.tree)
    return specs.tree_specs(shapes, cfg, fsdp=not tcfg.dp_replicated,
                            worker_axes=w_axes,
                            axis_sizes=meshlib.mesh_axis_sizes(mesh))


def batch_sharding(mesh, tcfg: TrainConfig, vr_workers: str, *,
                   with_fe=False):
    """The spec of the step's global token block (and of frontend
    embeddings with ``with_fe``)."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.sharding import specs
    w_axes = (meshlib.worker_axes(mesh, vr_workers)
              if tcfg.vr != "none" else ())
    data_axes = tuple(a for a in ("pod", "data")
                      if a in mesh.axis_names and a not in w_axes)
    tok = specs.batch_specs(w_axes, data_axes)
    out = {"tokens": tok}
    if with_fe:
        out["fe"] = tuple(tok) + (None,)
    return out


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
