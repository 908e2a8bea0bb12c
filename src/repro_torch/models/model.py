"""Top-level model API of the port: init, forward, the next-token loss
(+ the MoE aux loss) and the lockstep decode — the port of
``repro/models/model.py`` for every arch of the zoo, the VLM/audio
frontend stub included.

Batches are dicts: ``{"tokens": (B, S) int, ["labels": (B, S)],
["frontend_embeds": (B, S_f, d)]}``. For a frontend arch the sequence is
S_f + S: the projected embeddings, then the tokens; the loss leaves the
embedding positions out. Decode takes a (B, 1) token block, a cache from
:func:`init_cache` and the position, an int.

Params are a nested dict ``{"embed": {"tok"}, "layers": [per-layer
dict, ...], "final_norm": {"scale"}, "head": {"w"}[, "frontend_proj"]}``
in the reference's layouts; ``convert.lm_params_from_jax`` maps the
reference's params (stacked layers) onto it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers, rglru, transformer


def build_params(cfg: ModelConfig, new):
    """The params tree, each leaf made by ``new(shape, init)`` in layout
    order (see ``layers``)."""
    p = {
        "embed": layers.init_embed(cfg, new),
        "layers": transformer.init_stack(cfg, new),
        "final_norm": layers.init_norm(cfg, new),
        "head": layers.init_lm_head(cfg, new),
    }
    if cfg.frontend is not None:
        d = cfg.d_model
        p["frontend_proj"] = new((d, d), layers.dense(d))
    return p


def fill_(t: torch.Tensor, init, generator: torch.Generator):
    """Initialize ``t`` in place (``init`` as in ``layers``): ones, zeros,
    log(1..n), the RG-LRU's lambda, or normal(0, std) drawn from
    ``generator`` (on t's device), with an optional zeroed tail along one
    axis (padded heads)."""
    if init == "ones":
        return t.fill_(1.0)
    if init == "zeros":
        return t.zero_()
    if init == "log_arange":
        return t.copy_(torch.arange(1, t.numel() + 1, dtype=torch.float32,
                                    device=t.device).log_())
    if init == "rglru_lambda":
        # softplus^-1(-log u / c), u uniform in [0.9, 0.999]
        u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
        u.uniform_(0.9, 0.999, generator=generator)
        return t.copy_(torch.log(torch.expm1(-torch.log(u)
                                             / rglru.C_RGLRU)))
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


def _top_params(p, cfg: ModelConfig):
    """The embedding, head and frontend projection as the model uses
    them: under the weight-gather context their FSDP shards gathered over
    'data' (``sharding/gather_ctx.py``), in their stored dtype."""
    from repro_torch.sharding import gather_ctx
    if not gather_ctx.active():
        return p
    d, V = cfg.d_model, cfg.vocab_size
    p = dict(p, embed={"tok": gather_ctx.constrain(
        "embed/tok", p["embed"]["tok"], (V, d))})
    if "w" in p["head"]:
        p["head"] = {"w": gather_ctx.constrain("head/w", p["head"]["w"],
                                               (d, V))}
    if "frontend_proj" in p:
        p["frontend_proj"] = gather_ctx.constrain(
            "frontend_proj", p["frontend_proj"], (d, d))
    return p


def _vocab_split(p, cfg: ModelConfig) -> bool:
    """Whether the embedding's vocab rows are split over 'model' (then so
    are the head's columns: both specs put 'model' on the vocab dim)."""
    from repro_torch.sharding import tp
    return tp.split(p["embed"]["tok"].shape[0], cfg.vocab_size)


def _embed_inputs(p, cfg: ModelConfig, batch):
    from repro_torch.sharding import tp
    compute = getattr(torch, cfg.dtype)
    if _vocab_split(p, cfg):
        x = tp.embed(p["embed"]["tok"], batch["tokens"]).to(compute)
    else:
        x = layers.embed_tokens(p["embed"], batch["tokens"]).to(compute)
    fe = batch.get("frontend_embeds")
    if cfg.frontend is not None and fe is not None:
        w = p["frontend_proj"]
        fe = fe.to(compute) @ w.to(compute)
        if tp.split(w.shape[1], cfg.d_model):
            fe = tp.gather_out(fe)
        x = torch.cat([fe, x], dim=1)
    return x


def forward(p, cfg: ModelConfig, batch, *, remat: str = "block",
            window: Optional[int] = None):
    """Full-sequence forward: (logits (B, S_f + S, vocab) in float32,
    aux). On a mesh whose 'model' axis splits the vocab, the logits are
    this rank's vocab columns (B, S_f + S, vocab / model)."""
    from repro_torch.sharding import tp
    p = _top_params(p, cfg)
    x = _embed_inputs(p, cfg, batch)
    x, aux = transformer.apply_stack_train(p["layers"], cfg, x, remat=remat,
                                           window=window)
    x = layers.apply_norm(p["final_norm"], x, cfg.norm_type)
    if _vocab_split(p, cfg):
        x = tp.copy_in(x)
    logits = layers.lm_logits(p["head"], p["embed"], x, cfg.tie_embeddings)
    return logits.to(torch.float32), aux


def loss_fn(p, cfg: ModelConfig, batch, *, remat: str = "block",
            window: Optional[int] = None):
    """Next-token cross-entropy + the MoE aux loss; labels default to the
    shifted tokens. Frontend positions are left out of the loss. With the
    vocab split over 'model', the cross-entropy is vocab-parallel
    (``sharding/tp.py``)."""
    from repro_torch.sharding import tp
    logits, aux = forward(p, cfg, batch, remat=remat, window=window)
    tokens = batch["tokens"]
    labels = batch.get("labels")
    n_f = logits.shape[1] - tokens.shape[1]        # frontend positions
    if labels is None:
        labels = tokens[:, 1:]
        logits = logits[:, n_f:-1]
    else:
        logits = logits[:, n_f:]
    if _vocab_split(p, cfg):
        return tp.cross_entropy(logits, labels).mean() + aux
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    return nll.mean() + aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device):
    """The lockstep decode's caches in the compute dtype, one per layer."""
    return transformer.init_stack_cache(cfg, batch, max_len,
                                        getattr(torch, cfg.dtype),
                                        device=device)


def decode_step(p, cfg: ModelConfig, token, cache, pos: int):
    """token: (B, 1) -> (logits (B, vocab) float32, cache). The cache's
    tensors are written in place, where the reference returns new ones."""
    compute = getattr(torch, cfg.dtype)
    x = layers.embed_tokens(p["embed"], token).to(compute)
    x, cache = transformer.apply_stack_decode(p["layers"], cache, cfg, x, pos)
    x = layers.apply_norm(p["final_norm"], x, cfg.norm_type)
    logits = layers.lm_logits(p["head"], p["embed"], x, cfg.tie_embeddings)
    return logits[:, 0].to(torch.float32), cache


def param_count_actual(params) -> int:
    """Elements in a params tree."""
    n = 0

    def add(t):
        nonlocal n
        n += t.numel()
    tree_map(add, params)
    return n
