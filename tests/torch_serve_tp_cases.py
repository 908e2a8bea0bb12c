"""The rank side of ``test_torch_serve_tp.py``: module-level functions
that ``launch.mesh.spawn_workers`` runs in each gloo rank on the CPU, on
the (data 1, model 2) mesh (this module imports neither jax nor the
reference, so the ranks start fast).

A job is a dict with a ``kind``: ``engine`` serves a trace on the
tensor-parallel engine, ``program`` runs one decode step or one prefill
chunk from a given serve cache, ``draw`` draws the rank's params from a
seed. The parent passes the reference's params and caches as numpy.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.config import MeshConfig, get_arch
from repro_torch.launch import mesh as meshlib
from repro_torch.models import model
from repro_torch.serve import ServeEngine, runtime, synthetic_trace
from repro_torch.serve.cache import Geometry
from repro_torch.serve.engine import tp_params
from repro_torch.sharding import tp

# the reference's own TP decode test (tests/test_serve.py)
TRACE = dict(pattern="uniform", prompt_len=12, max_new=5, gap=2, seed=4)
N_REQUESTS = 3
ENGINE = dict(width=2, block_size=4, max_seq_len=20, chunk_buckets=(4, 8))


def cfg_of(arch, dtype="float32", **replace):
    return dataclasses.replace(get_arch(arch).reduced(), dtype=dtype,
                               **replace)


def serve_ids(cfg, params, kv_cache, mesh=None, device="cpu"):
    """The reference test's trace on the engine: its ids by rid, the
    blocks still in use, whether every block is free, and the experts a
    rank holds (MoE archs)."""
    eng = ServeEngine(cfg, params, kv_cache=kv_cache, mesh=mesh,
                      device=device, **ENGINE)
    eng.warmup()
    rep = eng.run(synthetic_trace(N_REQUESTS, **TRACE))
    free = eng.allocator.available() == eng.geo.num_blocks - 1
    return dict(ids={r.rid: list(r.tokens) for r in rep.results},
                in_use=eng.allocator.in_use, free=free,
                experts=(eng.params["layers"][0]["ffn"]["wg"].shape[0]
                         if cfg.is_moe else None))


def _engine(job, mesh):
    cfg = cfg_of(job["arch"])
    return serve_ids(cfg, convert.lm_params_from_jax(job["params"], cfg),
                     job["kv_cache"], mesh)


def _program(job, mesh):
    """One decode step (``kind`` decode) or prefill chunk from the given
    cache, on the rank's shards of the given params: (logits, the cache
    after)."""
    cfg = cfg_of(job["arch"], **job.get("replace", {}))
    geo = Geometry(**job["geo"])
    params = convert.shard_tree(job["params"], cfg,
                                meshlib.mesh_axis_sizes(mesh), mesh.coords)
    cache = convert.serve_cache_from_jax(job["cache"], cfg)
    decode, prefill = runtime.build_programs(cfg, geo)
    with tp.scope(mesh, cfg):
        if job["step"] == "decode":
            logits, cache = decode(params, cache, *job["args"])
        else:
            logits, cache = prefill(params, cache, *job["args"])
    return dict(logits=logits, cache=cache,
                wq=tuple(params["layers"][0]["mixer"]["wq"].shape))


def _draw(job, mesh):
    """The rank's params drawn from seed 0, leaf at a time, and the
    layout's slices."""
    from repro_torch.train.step import ShardedLayout
    cfg = cfg_of(job["arch"], dtype=get_arch(job["arch"]).reduced().dtype)
    lay = ShardedLayout(cfg, mesh.axis_names, mesh.shape, mesh.coords,
                        fsdp=False)
    leaves = []
    model.tree_map(leaves.append, tp_params(cfg, mesh, None, seed=0))
    return dict(leaves=leaves, slices=lay.slices)


KINDS = {"engine": _engine, "program": _program, "draw": _draw}


def run_all(group, jobs):
    """Every job in order on this rank's (data 1, model 2) mesh: {name:
    result}."""
    m = meshlib.make_mesh(MeshConfig((1, 2), ("data", "model")),
                          device="cpu")
    out = {job["name"]: KINDS[job["kind"]](job, m) for job in jobs}
    out["coords"] = m.coords
    return out

