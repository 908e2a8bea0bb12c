"""Top-level model API of the port, train path: init, forward and the
next-token loss — the port of ``repro/models/model.py`` for the dense and
Mamba2 (ssm) archs without a frontend (decode, serving and the VLM/audio
frontend stubs are still to port, see ROADMAP.md).

Params are a nested dict ``{"embed": {"tok"}, "layers": [per-layer
dict, ...], "final_norm": {"scale"}, "head": {"w"}}`` in the reference's
layouts; ``convert.lm_params_from_jax`` maps the reference's params
(stacked layers) onto it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers, transformer


def build_params(cfg: ModelConfig, new):
    """The params tree, each leaf made by ``new(shape, init)`` in layout
    order (see ``layers``)."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend stub is not ported yet "
            "(ROADMAP.md queue 1, item 12)")
    return {
        "embed": layers.init_embed(cfg, new),
        "layers": transformer.init_stack(cfg, new),
        "final_norm": layers.init_norm(cfg, new),
        "head": layers.init_lm_head(cfg, new),
    }


def fill_(t: torch.Tensor, init, generator: torch.Generator):
    """Initialize ``t`` in place (``init`` as in ``layers``): ones, zeros,
    log(1..n), or normal(0, std) drawn from ``generator`` (on t's device),
    with an optional zeroed tail along one axis (padded heads)."""
    if init == "ones":
        return t.fill_(1.0)
    if init == "zeros":
        return t.zero_()
    if init == "log_arange":
        return t.copy_(torch.arange(1, t.numel() + 1, dtype=torch.float32,
                                    device=t.device).log_())
    t.normal_(0.0, 1.0, generator=generator).mul_(init[1])
    if len(init) == 3:
        axis, keep = init[2]
        t.narrow(axis, keep, t.shape[axis] - keep).zero_()
    return t


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device):
    """Random params in ``cfg.param_dtype``, drawn from ``generator`` (a
    generator on ``device``). The numbers are not the reference's
    ``jax.random`` ones: tests convert the reference's params instead."""
    dtype = getattr(torch, cfg.param_dtype)

    def new(shape, init):
        return fill_(torch.empty(shape, dtype=dtype, device=device), init,
                     generator)
    return build_params(cfg, new)


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_zip(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of the same structure."""
    if isinstance(tree, dict):
        if set(tree) != set(other):
            raise ValueError(f"params differ in keys: {sorted(tree)} vs "
                             f"{sorted(other)}")
        return {k: tree_zip(fn, tree[k], other[k]) for k in tree}
    if isinstance(tree, list):
        if len(tree) != len(other):
            raise ValueError(f"params differ in layer count: {len(tree)} vs "
                             f"{len(other)}")
        return [tree_zip(fn, a, b) for a, b in zip(tree, other)]
    return fn(tree, other)


class ParamLayout:
    """Where each parameter lives in a flat buffer of N elements: leaves
    in creation order (``build_params``), each at its offset. The trainer
    keeps params, gradients and VR state as flat buffers; the model sees
    views of them shaped as the params tree, so no param-sized copy is
    made to flatten or unflatten."""

    def __init__(self, cfg: ModelConfig):
        self.shapes, self.offsets, self.inits = [], [], []
        self.n = 0

        def new(shape, init):
            self.shapes.append(torch.Size(shape))
            self.offsets.append(self.n)
            self.inits.append(init)
            self.n += self.shapes[-1].numel()
            return len(self.shapes) - 1

        self.tree = build_params(cfg, new)      # leaves: leaf numbers

    def leaf_views(self, flat: torch.Tensor):
        """Views of ``flat`` (N,) shaped as the leaves, in layout order."""
        return [flat[o:o + s.numel()].view(s)
                for o, s in zip(self.offsets, self.shapes)]

    def unflatten(self, leaves):
        """The params tree over a list of leaves in layout order."""
        return tree_map(lambda j: leaves[j], self.tree)

    def views(self, flat: torch.Tensor):
        """The params tree as views of ``flat`` (N,)."""
        return self.unflatten(self.leaf_views(flat))

    def init_(self, flat: torch.Tensor, generator: torch.Generator):
        """Random params written into ``flat`` (N,), drawn from
        ``generator`` leaf by leaf in layout order."""
        for view, init in zip(self.leaf_views(flat), self.inits):
            fill_(view, init, generator)
        return flat

    def load_(self, flat: torch.Tensor, params):
        """Copy a params tree (tensors or arrays of the layout's shapes)
        into ``flat`` (N,)."""
        views = self.leaf_views(flat)

        def put(j, value):
            value = torch.as_tensor(value)
            if value.shape != self.shapes[j]:
                raise ValueError(f"param {j}: shape {tuple(value.shape)}, "
                                 f"layout has {tuple(self.shapes[j])}")
            views[j].copy_(value)
        tree_zip(put, self.tree, params)
        return flat


def forward(p, cfg: ModelConfig, tokens, *, remat: str = "block",
            window: Optional[int] = None):
    """tokens (B, S) -> logits (B, S, vocab) in float32."""
    compute = getattr(torch, cfg.dtype)
    x = layers.embed_tokens(p["embed"], tokens).to(compute)
    x = transformer.apply_stack_train(p["layers"], cfg, x, remat=remat,
                                      window=window)
    x = layers.apply_norm(p["final_norm"], x, cfg.norm_type)
    logits = layers.lm_logits(p["head"], p["embed"], x, cfg.tie_embeddings)
    return logits.to(torch.float32)


def loss_fn(p, cfg: ModelConfig, batch, *, remat: str = "block",
            window: Optional[int] = None):
    """Next-token cross-entropy; labels default to the shifted tokens."""
    tokens = batch["tokens"]
    logits = forward(p, cfg, tokens, remat=remat, window=window)
    labels = batch.get("labels")
    if labels is None:
        labels = tokens[:, 1:]
        logits = logits[:, :-1]
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    return nll.mean()
