"""Serving programs: chunked prefill and fixed-width batched decode over a
paged (or dense-oracle) KV cache — the port of ``repro/serve/runtime.py``.

Two programs per (config, geometry), built by :func:`build_programs`:

``decode(params, cache, tokens, lens, alive, tables)``
    One token for every lane of a fixed decode batch of ``width`` lanes,
    each lane at its own position ``lens[lane]`` (unlike the lockstep
    ``model.decode_step``). Dead lanes (``alive`` False) run padded
    compute whose KV writes land in the trash block (paged) or write a
    slot's own value back (dense, ring), so a lane's output stream is
    independent of what the other lanes do, bit for bit: every GEMM has
    the same shape whatever the number of live lanes.

``prefill(params, cache, tokens, len0, n_valid, lane, table_row)``
    Writes one chunk of ``C = len(tokens)`` prompt tokens (``n_valid``
    real, the rest padding) into lane ``lane``'s cache from absolute
    position ``len0`` (ints), and returns the logits at the last valid
    position (the first generated token when the final chunk lands).

The reference jits both with the cache donated; here they are plain
callables that write the cache's tensors in place and return it. Host
arrays (numpy) are staged onto the cache's device with one copy a call.

Per-layer cache modes (decided by layer kind + geometry):
  * windowed layers ("local" always; "attn" with cfg.sliding_window) keep
    per-lane ring buffers of ``min(context, window)`` slots;
  * full-attention layers use the paged pool ``(num_blocks, block_size,
    KV, hd)`` + shared block tables, or per-lane dense buffers of the
    same padded context width when ``geometry.kv_cache == "dense"``.

Both full-attention modes give :func:`attention.attend_serve` the same
contiguous (lanes, context, KV, hd) context with identical validity
masks, and masked entries contribute an exact 0.0 to the online softmax,
so paged and dense greedy decode are bit-identical: the dense path is the
paged one's oracle.

Ring prefill: a chunk may overwrite ring slots that earlier queries of
the same chunk still need, so the ring path attends over the
concatenated stream ``[old ring, chunk]`` and only afterwards folds the
chunk into the ring by a deterministic gather (slot c takes the newest
chunk position = c mod slots).

Tensor parallelism: called inside ``tp.scope(mesh, cfg)`` (the engine
does so with a mesh), the programs take the rank's shards
(``serve/engine.py:tp_params``). Attention runs over the
rank's q heads against the kv heads they read from the whole,
replicated cache (every rank writes every kv head) and ends in one
all-reduce over 'model'; the MLP is column / row parallel, the MoE
expert-parallel (``models/moe.py``); the embedding is the vocab-parallel
lookup and the logits are gathered over 'model', so every rank takes the
same argmax.

Params: the reference casts each block's float params to the compute
dtype inside every step. :func:`cast_params` does it once (the engine
calls it when it is built); the result is bit-identical, and a tree that
is already cast passes through without a copy. The embedding, the final
norm and the head keep the dtype the reference uses them in.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention, layers, model, moe, transformer
from repro_torch.serve.cache import Geometry

SERVE_KINDS = ("attn", "local")


def check_arch(cfg: ModelConfig) -> None:
    """The engine serves attention-family stacks; recurrent caches (ssm /
    rec) and frontend embeds keep the legacy per-token path."""
    bad = sorted(set(cfg.layer_kinds()) - set(SERVE_KINDS))
    if bad:
        raise ValueError(
            f"{cfg.name}: serve runtime handles attention-family layers "
            f"only, found {bad}; use the legacy host-loop path "
            f"(serve/legacy.py)")
    if cfg.frontend is not None:
        raise ValueError(f"{cfg.name}: frontend embeds are not servable by "
                         "the engine; use the legacy host-loop path")


def cast_params(params, cfg: ModelConfig, device):
    """``params`` on ``device`` with every block's float leaves in the
    compute dtype, as the reference's per-step cast makes them; the
    embedding, final norm, head (and frontend projection) as they are.
    Leaves already in place are kept, not copied."""
    compute = getattr(torch, cfg.dtype)
    out = {k: model.tree_map(lambda t: t.to(device), v)
           for k, v in params.items() if k != "layers"}
    out["layers"] = [transformer._cast_params(
        model.tree_map(lambda t: t.to(device), p), compute)
        for p in params["layers"]]
    return out


def init_cache(cfg: ModelConfig, geo: Geometry, *, device):
    """Serve cache, one entry per layer: paged pools / dense lane buffers
    / rings of zeros in the compute dtype."""
    dtype = getattr(torch, cfg.dtype)
    KV, hd = cfg.num_kv_heads, cfg.head_dim

    def make(kind, window):
        if window:
            shape = (geo.width, min(geo.context, window), KV, hd)
        elif geo.kv_cache == "paged":
            shape = (geo.num_blocks, geo.block_size, KV, hd)
        else:
            shape = (geo.width, geo.context, KV, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return transformer.init_stack_serve_cache(cfg, make)


# ---------------------------------------------------------------------------
# Per-layer attention: decode
# ---------------------------------------------------------------------------

def _decode_context(geo, lens, alive, tables):
    """What every layer's decode attention shares, computed once a step:
    the lanes' rope positions, the context's positions and validity, and
    the paged write's targets (or the dense write's slots). A ring's
    slots and positions are added per ring size as the layers ask."""
    D, dev = geo.width, lens.device
    lane = torch.arange(D, device=dev)
    t = torch.arange(geo.context, device=dev)
    ctx = {"lane": lane, "positions": lens[:, None], "lens": lens,
           "alive": alive, "k_pos": t[None, :].expand(D, geo.context),
           "k_valid": t[None, :] <= lens[:, None]}
    if geo.kv_cache == "paged":
        # dead lanes write the trash block 0 (never table-reachable)
        ctx["phys"] = torch.where(alive, tables[lane, lens // geo.block_size],
                                  0)
        ctx["off"] = lens % geo.block_size
        ctx["tables"] = tables
    else:
        ctx["slot"] = lens.clamp(max=geo.context - 1)
    return ctx


def _ring(ctx, slots):
    """A ring of ``slots``: each lane's write slot and the positions and
    validity of its slots after the write."""
    if slots not in ctx:
        lens = ctx["lens"]
        ctx[slots] = (lens % slots, *attention.ring_positions(lens, slots))
    return ctx[slots]


def _decode_attend(p, cfg, geo, x, kv, window, ctx):
    D = geo.width
    positions, lane = ctx["positions"], ctx["lane"]
    q, k_new, v_new = attention.project_qkv_serve(p, cfg, x, positions)
    heads = attention.serve_heads(p, cfg)

    if window:
        slot, k_pos, k_valid = _ring(ctx, kv["k"].shape[1])
        keep = ~ctx["alive"][:, None, None]
        for name, new in (("k", k_new), ("v", v_new)):
            buf = kv[name]
            buf[lane, slot] = torch.where(keep, buf[lane, slot], new[:, 0])
        out = attention.attend_serve(q, positions,
                                     attention.kv_local(kv["k"], heads),
                                     attention.kv_local(kv["v"], heads),
                                     k_pos, k_valid, window=window,
                                     softcap=cfg.attn_logit_softcap)
        return attention.output_proj_serve(p, cfg, out), kv

    if geo.kv_cache == "paged":
        phys, off, tables = ctx["phys"], ctx["off"], ctx["tables"]
        kv["k"][phys, off] = k_new[:, 0]
        kv["v"][phys, off] = v_new[:, 0]
        # the gather makes the same contiguous (D, T, KV, hd) layout as
        # the dense lane buffers
        k_c = kv["k"][tables].reshape(D, geo.context, *kv["k"].shape[2:])
        v_c = kv["v"][tables].reshape(D, geo.context, *kv["v"].shape[2:])
    else:
        # dense oracle: a dead lane writes its slot's own value back (the
        # reference drops its write)
        slot, live = ctx["slot"], ctx["alive"][:, None, None]
        for name, new in (("k", k_new), ("v", v_new)):
            buf = kv[name]
            buf[lane, slot] = torch.where(live, new[:, 0], buf[lane, slot])
        k_c, v_c = kv["k"], kv["v"]

    # under TP the kv heads this rank's q heads read
    k_c, v_c = attention.kv_local(k_c, heads), attention.kv_local(v_c, heads)
    out = attention.attend_serve(q, positions, k_c, v_c, ctx["k_pos"],
                                 ctx["k_valid"], window=None,
                                 softcap=cfg.attn_logit_softcap)
    return attention.output_proj_serve(p, cfg, out), kv


# ---------------------------------------------------------------------------
# Per-layer attention: prefill (single lane, one chunk)
# ---------------------------------------------------------------------------

def _prefill_attend(p, cfg, geo, x, kv, window, len0, n_valid, lane,
                    table_row):
    C = x.shape[1]
    dev = x.device
    i = torch.arange(C, device=dev)
    pos_i = len0 + i                                # (C,) absolute positions
    positions = pos_i[None, :]
    q, k_new, v_new = attention.project_qkv_serve(p, cfg, x, positions)
    heads = attention.serve_heads(p, cfg)
    chunk_valid = i < n_valid

    if window:
        slots = kv["k"].shape[1]
        ring_k, ring_v = kv["k"][lane], kv["v"][lane]
        r_pos, r_valid = attention.ring_positions(
            torch.full((1,), len0 - 1, device=dev), slots)
        k_s = torch.cat([ring_k[None], k_new], 1)
        v_s = torch.cat([ring_v[None], v_new], 1)
        k_pos = torch.cat([r_pos, positions], 1)
        k_valid = torch.cat([r_valid, chunk_valid[None]], 1)
        out = attention.attend_serve(q, positions,
                                     attention.kv_local(k_s, heads),
                                     attention.kv_local(v_s, heads),
                                     k_pos, k_valid,
                                     window=window,
                                     softcap=cfg.attn_logit_softcap)
        # fold the chunk into the ring: slot c takes the newest valid chunk
        # position = c (mod slots), else keeps its old entry
        last = len0 + n_valid - 1
        c = torch.arange(slots, device=dev)
        p_c = last - torch.remainder(last - c, slots)
        take = ((p_c >= len0) & (n_valid > 0))[:, None, None]
        idx = torch.clamp(p_c - len0, 0, C - 1)
        new_k = torch.where(take, k_new[0, idx], ring_k)
        new_v = torch.where(take, v_new[0, idx], ring_v)
        kv["k"][lane] = new_k
        kv["v"][lane] = new_v
        return attention.output_proj_serve(p, cfg, out), kv

    t = torch.arange(geo.context, device=dev)
    k_pos = t[None, :]
    k_valid = (t < len0 + n_valid)[None, :]

    if geo.kv_cache == "paged":
        blk = torch.clamp(pos_i // geo.block_size, max=geo.blocks_per_seq - 1)
        phys = torch.where(chunk_valid, table_row[blk], 0)
        off = pos_i % geo.block_size
        kv["k"][phys, off] = k_new[0]
        kv["v"][phys, off] = v_new[0]
        shape = (geo.context, *kv["k"].shape[2:])
        k_c = kv["k"][table_row].reshape(shape)[None]
        v_c = kv["v"][table_row].reshape(shape)[None]
    else:
        kv["k"][lane, len0:len0 + n_valid] = k_new[0, :n_valid]
        kv["v"][lane, len0:len0 + n_valid] = v_new[0, :n_valid]
        k_c, v_c = kv["k"][lane][None], kv["v"][lane][None]

    k_c, v_c = attention.kv_local(k_c, heads), attention.kv_local(v_c, heads)
    out = attention.attend_serve(q, positions, k_c, v_c, k_pos, k_valid,
                                 window=None, softcap=cfg.attn_logit_softcap)
    return attention.output_proj_serve(p, cfg, out), kv


# ---------------------------------------------------------------------------
# Block + full-model programs
# ---------------------------------------------------------------------------

def _apply_block(bp, bc, cfg, x, mixer_fn):
    bp = transformer._cast_params(bp, getattr(torch, cfg.dtype))
    h = layers.apply_norm(bp["norm1"], x, cfg.norm_type)
    mix, bc = mixer_fn(bp["mixer"], h, bc)
    x = x + mix
    h = layers.apply_norm(bp["norm2"], x, cfg.norm_type)
    if cfg.is_moe:
        y, _ = moe.apply_moe(bp["ffn"], cfg, h)
    else:
        y = layers.apply_mlp(bp["ffn"], h, cfg.mlp_type,
                             tp_split=transformer._mlp_split(bp["ffn"], cfg))
    return x + y, bc


def _embed(params, cfg, tokens):
    """The tokens' embedding rows in the compute dtype: a masked lookup of
    the rank's vocab rows and an all-reduce where the vocab is split over
    'model'."""
    from repro_torch.sharding import tp
    compute = getattr(torch, cfg.dtype)
    if model._vocab_split(params, cfg):
        return tp.embed(params["embed"]["tok"], tokens).to(compute)
    return layers.embed_tokens(params["embed"], tokens).to(compute)


def _logits(params, cfg, x):
    """The head's float32 logits over the whole vocabulary: the rank's
    vocab columns gathered over 'model' where the vocab is split, so that
    every rank takes the same argmax."""
    from repro_torch.sharding import tp
    logits = layers.lm_logits(params["head"], params["embed"], x,
                              cfg.tie_embeddings).to(torch.float32)
    return tp.gather_out(logits) if model._vocab_split(params, cfg) \
        else logits


def decode_step(params, cfg: ModelConfig, geo: Geometry, cache,
                tokens, lens, alive, tables):
    """tokens / lens / alive: (width,) tensors; tables: (width,
    blocks_per_seq) -> (logits (width, vocab) float32, cache), the cache
    written in place."""
    x = _embed(params, cfg, tokens[:, None])
    ctx = _decode_context(geo, lens, alive, tables)

    def block_fn(bp, bc, kind, window, x):
        return _apply_block(
            bp, bc, cfg, x,
            lambda mp, h, kv: _decode_attend(mp, cfg, geo, h, kv, window,
                                             ctx))

    x, cache = transformer.apply_stack_serve(params["layers"], cache, cfg,
                                             x, block_fn)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_type)
    return _logits(params, cfg, x)[:, 0], cache


def prefill_chunk(params, cfg: ModelConfig, geo: Geometry, cache,
                  tokens, len0: int, n_valid: int, lane: int, table_row):
    """tokens: (C,) tensor; len0 / n_valid / lane: ints; table_row:
    (blocks_per_seq,) tensor -> (logits (vocab,) float32 at the last valid
    position, cache), the cache written in place."""
    x = _embed(params, cfg, tokens[None, :])

    def block_fn(bp, bc, kind, window, x):
        return _apply_block(
            bp, bc, cfg, x,
            lambda mp, h, kv: _prefill_attend(mp, cfg, geo, h, kv, window,
                                              len0, n_valid, lane, table_row))

    x, cache = transformer.apply_stack_serve(params["layers"], cache, cfg,
                                             x, block_fn)
    last = min(max(n_valid - 1, 0), tokens.shape[0] - 1)
    x_last = layers.apply_norm(params["final_norm"], x[:, last:last + 1],
                               cfg.norm_type)
    return _logits(params, cfg, x_last)[0, 0], cache


def _device_of(cache):
    return cache[0]["k"].device


def stage(device, *arrays):
    """Integer host arrays (or tensors) as int64 tensors on ``device``, by
    one host-to-device copy for all of them."""
    if all(isinstance(a, torch.Tensor) and a.device == device
           for a in arrays):
        return arrays
    host = [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                       dtype=np.int64) for a in arrays]
    flat = torch.from_numpy(np.concatenate([h.ravel() for h in host]))
    flat = flat.to(device)
    out, at = [], 0
    for h in host:
        out.append(flat[at:at + h.size].view(h.shape))
        at += h.size
    return tuple(out)


@functools.lru_cache(maxsize=None)
def build_programs(cfg: ModelConfig, geo: Geometry):
    """Returns (decode, prefill) for one (config, geometry), memoized as
    the reference memoizes its jitted pair. Each runs without autograd,
    stages its host arrays onto the cache's device with one copy and
    writes the cache in place."""

    @torch.no_grad()
    def _decode(params, cache, tokens, lens, alive, tables):
        tokens, lens, alive, tables = stage(_device_of(cache), tokens, lens,
                                            alive, tables)
        return decode_step(params, cfg, geo, cache, tokens, lens,
                           alive.to(torch.bool), tables)

    @torch.no_grad()
    def _prefill(params, cache, tokens, len0, n_valid, lane, table_row):
        tokens, table_row = stage(_device_of(cache), tokens, table_row)
        return prefill_chunk(params, cfg, geo, cache, tokens, int(len0),
                             int(n_valid), int(lane), table_row)

    return _decode, _prefill
