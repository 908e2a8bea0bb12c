"""The port's serving programs (``repro_torch/serve/runtime.py``) and their
attention primitives against the reference's: ``ring_positions`` and
``attend_serve`` on random inputs (windows, softcap, a context that is
not a whole number of chunks, fully masked rows, GQA), and one decode
step and one prefill chunk from the same non-zero cache
(``convert.serve_cache_from_jax``) in the paged, dense and ring
geometries, in float32: logits and the new cache within ``LM_TOL``, and
the trash block never read."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro.models import model as jmodel
from repro.serve import cache as jcache_mod
from repro.serve import runtime as jruntime
from repro_torch import convert
from repro_torch.models import attention
from repro_torch.serve import runtime
from repro_torch.serve.cache import Geometry
from torch_lm_common import assert_close, cfgs

torch.set_num_threads(1)


@pytest.mark.parametrize("slots", [1, 5, 16])
def test_ring_positions_match_the_reference(slots):
    last = np.array([-1, 0, 3, 4, 5, 17, 63], np.int64)
    want_pos, want_valid = jattention.ring_positions(jnp.asarray(last), slots)
    pos, valid = attention.ring_positions(torch.from_numpy(last), slots)
    valid_np = np.asarray(want_valid)
    np.testing.assert_array_equal(valid.numpy(), valid_np)
    np.testing.assert_array_equal(pos.numpy()[valid_np],
                                  np.asarray(want_pos)[valid_np])


def _serve_inputs(B, C, H, KV, hd, T, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    q_pos = rng.integers(0, T, (B, C))
    k_pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    k_valid = rng.random((B, T)) < 0.8
    q_pos[0, 0] = -1                    # sees no key: a fully masked row
    k_valid[-1] = False                 # a lane with an empty context
    return q, q_pos, k, v, k_pos, k_valid


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("H,KV,T,kv_chunk", [(4, 2, 37, 16), (2, 2, 32, 8),
                                             (6, 1, 20, 128)])
def test_attend_serve_matches_the_reference(window, softcap, H, KV, T,
                                            kv_chunk):
    """GQA and not, T a whole number of chunks and not (padded with
    position -1, invalid), windows, softcap; fully masked rows are exact
    zeros in both."""
    B, C, hd = 3, 4, 16
    q, q_pos, k, v, k_pos, k_valid = _serve_inputs(B, C, H, KV, hd, T,
                                                   seed=T + H)
    want = np.asarray(jattention.attend_serve(
        *map(jnp.asarray, (q, q_pos, k, v, k_pos, k_valid)), window=window,
        softcap=softcap, kv_chunk=kv_chunk))
    got = attention.attend_serve(
        *map(torch.from_numpy, (q, q_pos, k, v, k_pos, k_valid)),
        window=window, softcap=softcap, kv_chunk=kv_chunk).numpy()
    assert_close(got, want)
    assert not got[0, 0].any() and not want[0, 0].any()
    assert not got[-1].any() and not want[-1].any()


def _programs(arch, geo_kw, **replace):
    """(reference cfg, port cfg, reference geometry, port geometry, the
    reference's params, the port's) at float32."""
    jcfg, cfg = cfgs(arch=arch)
    jcfg = dataclasses.replace(jcfg, **replace)
    cfg = dataclasses.replace(cfg, **replace)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return (jcfg, cfg, jcache_mod.Geometry(**geo_kw), Geometry(**geo_kw),
            jp, convert.lm_params_from_jax(jp, cfg))


def _random_cache(jcfg, jgeo, seed):
    """The reference's serve cache filled with random values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(
            np.float32)), jruntime.init_cache(jcfg, jgeo))


GEOS = {
    "paged": ("qwen2-7b", dict(width=3, block_size=4, blocks_per_seq=4,
                               num_blocks=10, kv_cache="paged"), {}),
    "dense": ("qwen2-7b", dict(width=3, block_size=4, blocks_per_seq=4,
                               num_blocks=1, kv_cache="dense"), {}),
    "ring": ("starcoder2-15b", dict(width=3, block_size=4, blocks_per_seq=8,
                                    num_blocks=1, kv_cache="dense"),
             {"sliding_window": 12}),
}
# lane 0 at 6, lane 1 dead, lane 2 at 13 (the ring wrapped); the tables
# reach blocks 1..7, block 0 only where unallocated
LENS = np.array([6, 0, 13], np.int32)
ALIVE = np.array([True, False, True])
TABLES = np.array([[3, 5, 0, 0], [0, 0, 0, 0], [1, 2, 4, 7]], np.int32)


def _compare_cache(got, jwant, cfg, geo):
    want = convert.serve_cache_from_jax(jwant, cfg)
    for g, w in zip(got, want):
        for name in ("k", "v"):
            a, b = g[name].numpy(), w[name].numpy()
            if geo.kv_cache == "paged" and a.shape[0] == geo.num_blocks:
                # the trash block takes the dead lanes' writes in an order
                # neither package fixes
                a, b = a[1:], b[1:]
            assert_close(a, b)


@pytest.mark.parametrize("mode", sorted(GEOS))
def test_decode_step_from_one_cache_matches_the_reference(mode):
    arch, geo_kw, rep = GEOS[mode]
    jcfg, cfg, jgeo, geo, jp, params = _programs(arch, geo_kw, **rep)
    jc = _random_cache(jcfg, jgeo, seed=1)
    cache = convert.serve_cache_from_jax(jc, cfg)
    tokens = np.array([5, 7, 11], np.int32)
    tables = TABLES[:, :geo.blocks_per_seq] if mode == "paged" else \
        np.zeros((3, geo.blocks_per_seq), np.int32)
    step = jax.jit(lambda p, c, *a: jruntime.decode_step(p, jcfg, jgeo, c,
                                                         *a))
    want, jc = step(jp, jc, tokens, LENS, ALIVE, tables)
    decode, _ = runtime.build_programs(cfg, geo)
    got, cache = decode(params, cache, tokens, LENS, ALIVE, tables)
    live = ALIVE
    assert_close(got.numpy()[live], np.asarray(want)[live])
    _compare_cache(cache, jc, cfg, geo)


@pytest.mark.parametrize("mode", sorted(GEOS))
@pytest.mark.parametrize("len0,n_valid,C", [(0, 8, 8), (4, 3, 8),
                                            (9, 5, 8)])
def test_prefill_chunk_from_one_cache_matches_the_reference(mode, len0,
                                                            n_valid, C):
    """One chunk into lane 2 from position len0 (n_valid real tokens, the
    rest padding): the last valid position's logits and the cache."""
    arch, geo_kw, rep = GEOS[mode]
    jcfg, cfg, jgeo, geo, jp, params = _programs(arch, geo_kw, **rep)
    jc = _random_cache(jcfg, jgeo, seed=2)
    cache = convert.serve_cache_from_jax(jc, cfg)
    tokens = np.arange(3, 3 + C, dtype=np.int32)
    row = TABLES[2, :geo.blocks_per_seq] if mode == "paged" else \
        np.zeros(geo.blocks_per_seq, np.int32)
    fill = jax.jit(lambda p, c, t, l0, nv, ln, r: jruntime.prefill_chunk(
        p, jcfg, jgeo, c, t, l0, nv, ln, r))
    want, jc = fill(jp, jc, tokens, len0, n_valid, 2, row)
    _, prefill = runtime.build_programs(cfg, geo)
    got, cache = prefill(params, cache, tokens, len0, n_valid, 2, row)
    assert_close(got.numpy(), np.asarray(want))
    _compare_cache(cache, jc, cfg, geo)


def test_the_trash_block_is_never_read():
    """Live lanes' logits are bit-identical whatever block 0 holds, in a
    decode step and a prefill chunk."""
    arch, geo_kw, rep = GEOS["paged"]
    _, cfg, _, geo, _, params = _programs(arch, geo_kw, **rep)
    decode, prefill = runtime.build_programs(cfg, geo)
    tokens = np.array([5, 7, 11], np.int32)
    outs = []
    for scale in (0.0, 1e3):
        cache = runtime.init_cache(cfg, geo, device="cpu")
        gen = torch.Generator().manual_seed(4)
        for layer in cache:
            for t in layer.values():
                t.normal_(generator=gen)
                t[0].mul_(scale)
        pre, cache = prefill(params, cache, np.arange(8), 4, 3, 0, TABLES[0])
        logits, _ = decode(params, cache, tokens, LENS, ALIVE, TABLES)
        outs.append((pre, logits[ALIVE]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_cast_params_casts_blocks_once_and_keeps_a_cast_tree():
    """Blocks in the compute dtype, embedding / final norm / head as they
    are; a tree already cast passes through without a copy."""
    _, cfg = cfgs(dtype="bfloat16")
    from repro_torch.models import model
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    cast = runtime.cast_params(params, cfg, torch.device("cpu"))
    assert cast["layers"][0]["mixer"]["wq"].dtype == torch.bfloat16
    assert cast["head"]["w"] is params["head"]["w"]
    assert cast["embed"]["tok"].dtype == torch.float32
    again = runtime.cast_params(cast, cfg, torch.device("cpu"))
    assert again["layers"][1]["ffn"]["wd"] is cast["layers"][1]["ffn"]["wd"]
