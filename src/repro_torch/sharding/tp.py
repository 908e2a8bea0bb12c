"""Tensor parallelism over the mesh's 'model' axis: the collectives the
model runs when ``sharding/specs.py`` splits a leaf over 'model', as
explicit autograd functions where the reference lets GSPMD place them.

The residual stream is replicated over 'model'. A column-parallel layer
(attention's q heads, the MLP's ``wg``/``wu``/``wi``, the head's vocab
columns) takes its input through :func:`copy_in` — identity forward,
all-reduce of the gradient backward — and a row-parallel one (``wo``,
``wd``) gives its output through :func:`reduce_out` — all-reduce
forward, identity backward. A leaf that is replicated over 'model' but
used by one rank for only part of the work (attention's ``wk``/``wv``
and their biases and norms, whose kv heads each rank slices) also goes
through :func:`copy_in`, so its gradient sums the ranks' parts. The
embedding is a masked lookup of the rank's vocab rows and an all-reduce;
the loss is a vocab-parallel cross-entropy (:func:`cross_entropy`).

The MoE FFN routes over the GLOBAL batch, as the reference's does under
GSPMD (its capacity and its load-balance loss are functions of every
token of the batch): :func:`gather_batch` all-gathers its input over the
batch axes that split the rows (reduce-scatter backward) and
:func:`batch_rows` keeps the rank's rows of its output.

The context is process-global and the sharded train step enables it
around each step's forward and backward (:func:`scope`).
"""
from __future__ import annotations

import contextlib

import torch

_CTX: dict = {"mesh": None, "cfg": None, "batch_axes": ()}


@contextlib.contextmanager
def scope(mesh, cfg, batch_axes=()):
    """The context for the body: the mesh, and the axes that split the
    batch rows; the previous context restored after."""
    prev = dict(_CTX)
    _CTX.update(mesh=mesh, cfg=cfg, batch_axes=tuple(batch_axes))
    try:
        yield
    finally:
        _CTX.update(prev)


def group():
    return _CTX["mesh"].group("model")


def active() -> bool:
    """True inside a step on a mesh whose 'model' axis is above one."""
    return _CTX["mesh"] is not None and group().world > 1


def size() -> int:
    return group().world if _CTX["mesh"] is not None else 1


def rank() -> int:
    return group().rank if _CTX["mesh"] is not None else 0


def split(local: int, full: int) -> bool:
    """Whether a dim of ``full`` entries that this rank holds ``local``
    of is split over 'model'."""
    return active() and local != full


def _psum(x):
    from repro_torch.core import spmd
    return spmd.psum_(x.clone(), group())


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _psum(ct.contiguous())


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _psum(x.contiguous())

    @staticmethod
    def backward(ctx, ct):
        return ct


class _GatherOut(torch.autograd.Function):
    """The column pieces of a replicated result, gathered along the last
    dim; backward: this rank's columns of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x):
        from repro_torch.core import spmd
        ctx.n = x.shape[-1]
        return spmd.all_gather_dim(x.contiguous(), group(), x.dim() - 1)

    @staticmethod
    def backward(ctx, ct):
        r = rank()
        return ct[..., r * ctx.n:(r + 1) * ctx.n]


def copy_in(x):
    return _CopyIn.apply(x) if active() else x


def reduce_out(x):
    return _ReduceOut.apply(x) if active() else x


def gather_out(x):
    return _GatherOut.apply(x) if active() else x


def vocab_range(local_rows: int):
    r = rank()
    return r * local_rows, (r + 1) * local_rows


def embed(tok_local, tokens):
    """The embedding rows of ``tokens`` from this rank's vocab rows
    ``tok_local`` (V/T, d): a masked lookup, summed over 'model'."""
    v0, v1 = vocab_range(tok_local.shape[0])
    t = tokens.to(torch.int64)
    inside = (t >= v0) & (t < v1)
    rows = tok_local[(t - v0).clamp(0, tok_local.shape[0] - 1)]
    return reduce_out(rows * inside[..., None].to(rows.dtype))


def cross_entropy(logits_local, labels):
    """Per-position negative log-likelihood from this rank's vocab
    columns of the logits (..., V/T) float32: the max and the sum of
    exponentials all-reduced over 'model', the label's logit taken from
    the rank that holds it."""
    from repro_torch.core import spmd
    v0, v1 = vocab_range(logits_local.shape[-1])
    m = spmd.pmax_(logits_local.detach().amax(-1), group())
    sumexp = reduce_out(torch.exp(logits_local - m[..., None]).sum(-1))
    lab = labels.to(torch.int64)
    inside = (lab >= v0) & (lab < v1)
    picked = torch.gather(logits_local, -1,
                          (lab - v0).clamp(0, logits_local.shape[-1] - 1)
                          [..., None])[..., 0]
    target = reduce_out(torch.where(inside, picked, 0.0))
    return torch.log(sumexp) + m - target


def _batch_group():
    if _CTX["mesh"] is None or not _CTX["batch_axes"]:
        return None
    g = _CTX["mesh"].group(_CTX["batch_axes"])
    return g if g.world > 1 else None


def gather_batch(x):
    """``x`` (B_local, ...) with every batch rank's rows, in rank order
    (B, ...); ``x`` itself when the rows are not split."""
    from repro_torch.sharding import gather_ctx
    g = _batch_group()
    return x if g is None else gather_ctx._Gather.apply(x.contiguous(), 0, g)


def batch_rows(y, rows: int):
    """This rank's ``rows`` rows of a result over the global batch."""
    g = _batch_group()
    return y if g is None else y[g.rank * rows:(g.rank + 1) * rows]
