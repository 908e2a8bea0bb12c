"""Tensor-parallel serving on the port (``ServeEngine(mesh=...)``, the
serving programs under ``sharding/tp.py``, ``launch/serve.py --tp``) on
two gloo ranks on the CPU, the (data 1, model 2) mesh of the reference's
own TP decode test (``tests/test_serve.py``), in float32:

  * the reference test's trace gives, on every rank, the ids of the
    port's single-device engine, paged and dense, for qwen2-7b and both
    MoE archs (experts split over 'model'; qwen2-moe's shared expert the
    tensor-parallel MLP), and every pool block is free at the end; for
    qwen2-7b the ids also equal the reference's single-device engine's
    wherever its top-2 margin is too wide for rounding to flip (the
    reference's TP test fails in this container, so the TP engine is
    held to the single-device ones);
  * one decode step and one prefill chunk from one converted non-zero
    cache (``convert.serve_cache_from_jax``), paged, dense and ring,
    against the single-device runtime and the reference at ``LM_TOL``;
  * the leaf-at-a-time draw equals ``model.init_params``'s slices;
  * ``launch/serve.py --tp 2`` gives the ids of ``--tp 1``.

One module fixture spawns the two ranks (``launch.mesh.spawn_workers``),
which run every job of ``torch_serve_tp_cases.py``.
"""
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_serve_tp_cases as tc
from repro import serve as jserve
from repro.config import get_arch as jget_arch
from repro.models import model as jmodel
from repro.serve import cache as jcache_mod
from repro.serve import runtime as jruntime
from repro_torch import convert
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model
from repro_torch.serve import runtime, synthetic_trace
from repro_torch.serve.cache import Geometry
from test_torch_serve import _assert_same_ids, _margins
from test_torch_serve_runtime import ALIVE, GEOS, LENS, TABLES, _random_cache
from torch_lm_common import assert_close

torch.set_num_threads(1)

ARCHS = ("qwen2-7b", "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b")
MODES = ("paged", "dense")
# one prefill chunk into lane 2: (len0, n_valid, C)
CHUNK = (4, 3, 8)


def _jcfg(arch, **replace):
    return dataclasses.replace(jget_arch(arch).reduced(), dtype="float32",
                               **replace)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _program_jobs():
    """A decode step and a prefill chunk in each of GEOS's geometries, the
    reference's params and a random reference cache, and the reference's
    outputs."""
    jobs, want = [], {}
    for mode, (arch, geo_kw, rep) in sorted(GEOS.items()):
        jcfg = _jcfg(arch, **rep)
        jgeo = jcache_mod.Geometry(**geo_kw)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        paged = mode == "paged"
        tables = (TABLES[:, :jgeo.blocks_per_seq] if paged
                  else np.zeros((3, jgeo.blocks_per_seq), np.int32))
        len0, n_valid, C = CHUNK
        row = tables[2]
        for step, args in (
                ("decode", (np.array([5, 7, 11], np.int32), LENS, ALIVE,
                            tables)),
                ("prefill", (np.arange(3, 3 + C, dtype=np.int32), len0,
                             n_valid, 2, row))):
            jc = _random_cache(jcfg, jgeo, seed=1)
            name = f"{mode} {step}"
            jobs.append(dict(name=name, kind="program", arch=arch,
                             replace=rep, geo=geo_kw, step=step,
                             params=_np(jp), cache=_np(jc), args=args))
            if step == "decode":
                out = jax.jit(lambda p, c, *a: jruntime.decode_step(
                    p, jcfg, jgeo, c, *a))(jp, jc, *args)
            else:
                out = jax.jit(lambda p, c, t, r: jruntime.prefill_chunk(
                    p, jcfg, jgeo, c, t, len0, n_valid, 2, r))(
                    jp, jc, args[0], row)
            want[name] = np.asarray(out[0])
    return jobs, want


def _single(job):
    """The port's single-device run of a job."""
    cfg = tc.cfg_of(job["arch"], **job.get("replace", {}))
    params = convert.lm_params_from_jax(job["params"], cfg)
    if job["kind"] == "engine":
        return tc.serve_ids(cfg, params, job["kv_cache"])
    geo = Geometry(**job["geo"])
    cache = convert.serve_cache_from_jax(job["cache"], cfg)
    decode, prefill = runtime.build_programs(cfg, geo)
    fn = decode if job["step"] == "decode" else prefill
    return fn(params, cache, *job["args"])


@pytest.fixture(scope="module")
def runs():
    params = {a: jmodel.init_params(_jcfg(a), jax.random.PRNGKey(0))
              for a in ARCHS}
    jobs = [dict(name=f"{a} {m}", kind="engine", arch=a, kv_cache=m,
                 params=_np(params[a])) for a in ARCHS for m in MODES]
    program_jobs, ref_logits = _program_jobs()
    jobs += program_jobs
    jobs.append(dict(name="draw", kind="draw", arch="qwen2-7b"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(meshlib.spawn_workers, 2, tc.run_all, jobs,
                          device="cpu", timeout=300)
        singles = {j["name"]: _single(j) for j in jobs
                   if j["kind"] != "draw"}
        trace = synthetic_trace(tc.N_REQUESTS, **tc.TRACE)
        jcfg = _jcfg("qwen2-7b")
        ref = jserve.serve_trace(jcfg, trace, params=params["qwen2-7b"],
                                 **tc.ENGINE)
        ref_ids = {r.rid: list(r.tokens) for r in ref.results}
        margins = _margins(jcfg, params["qwen2-7b"], trace, ref_ids)
        ranks = fut.result()
    return dict(ranks=ranks, singles=singles, ref_ids=ref_ids,
                margins=margins, ref_logits=ref_logits)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_ids_equal_the_single_device_engine(runs, arch, mode):
    name = f"{arch} {mode}"
    ids = runs["singles"][name]["ids"]
    assert ids and all(len(t) == tc.TRACE["max_new"] for t in ids.values())
    for rank in runs["ranks"]:
        got = rank[name]
        assert got["ids"] == ids
        assert got["in_use"] == 0 and got["free"]
        if arch != "qwen2-7b":          # 2 of the 4 experts a rank
            assert got["experts"] == 2


def test_tp_ids_equal_the_reference_where_margins_are_safe(runs):
    for mode in MODES:
        for rank in runs["ranks"]:
            got = {rid: tuple(t) for rid, t in
                   rank[f"qwen2-7b {mode}"]["ids"].items()}
            _assert_same_ids(got, runs["ref_ids"], runs["margins"])


@pytest.mark.parametrize("step", ["decode", "prefill"])
@pytest.mark.parametrize("mode", sorted(GEOS))
def test_tp_program_from_one_cache_matches_single_device(runs, mode, step):
    """The rank's logits against the single-device port's and the
    reference's, and the written cache against the single-device one;
    each rank holds half of the q heads."""
    name = f"{mode} {step}"
    want, want_cache = runs["singles"][name]
    live = ALIVE if step == "decode" else slice(None)
    for rank in runs["ranks"]:
        got = rank[name]
        assert got["wq"][1] * 2 == tc.cfg_of(GEOS[mode][0]).padded_heads
        assert_close(got["logits"].numpy()[live], want.numpy()[live])
        assert_close(got["logits"].numpy()[live],
                     runs["ref_logits"][name][live])
        for g, w in zip(got["cache"], want_cache):
            for k in ("k", "v"):
                a, b = g[k].numpy(), w[k].numpy()
                if mode == "paged":     # the trash block takes dead writes
                    a, b = a[1:], b[1:]
                assert_close(a, b)


def test_leaf_at_a_time_draw_equals_init_params_slices(runs):
    cfg = tc.get_arch("qwen2-7b").reduced()
    full = []
    model.tree_map(full.append, model.init_params(
        cfg, torch.Generator("cpu").manual_seed(0), device="cpu"))
    for rank in runs["ranks"]:
        got = rank["draw"]
        split = 0
        for leaf, want, sl in zip(got["leaves"], full, got["slices"]):
            assert torch.equal(leaf, want[sl])
            split += leaf.shape != want.shape
        assert split > 0


@pytest.mark.parametrize("fsdp", [False, True])
def test_shard_tree_is_the_tree_form_of_shard_params(fsdp):
    """``convert.shard_tree`` at every position of (data 2, model 2): the
    leaves of ``convert.shard_params``'s flat buffer, bit for bit, and
    the engine's placement (``tp_params``) of the converted full tree."""
    import types

    from repro_torch.serve.engine import tp_params
    from repro_torch.train.step import ShardedLayout
    jcfg = _jcfg("qwen3-moe-30b-a3b")
    cfg = tc.cfg_of("qwen3-moe-30b-a3b")
    jp = _np(jmodel.init_params(jcfg, jax.random.PRNGKey(1)))
    sizes = {"data": 2, "model": 2}
    for coords in ((0, 0), (0, 1), (1, 0), (1, 1)):
        got = convert.shard_tree(jp, cfg, sizes, coords, fsdp=fsdp)
        lay = ShardedLayout(cfg, tuple(sizes), (2, 2), coords, fsdp=fsdp)
        want = lay.views(convert.shard_params(jp, cfg, sizes, coords,
                                              fsdp=fsdp))
        model.tree_zip(lambda a, b: torch.testing.assert_close(
            a, b, rtol=0, atol=0), got, want)
        if not fsdp:
            mesh = types.SimpleNamespace(
                axis_names=tuple(sizes), shape=(2, 2), coords=coords,
                device=torch.device("cpu"))
            placed = tp_params(cfg, mesh, convert.lm_params_from_jax(jp, cfg))
            model.tree_zip(lambda a, b: torch.testing.assert_close(
                a, b, rtol=0, atol=0), placed, got)


def test_shard_tree_takes_full_leaves_only():
    """A tree of one rank's shards is refused (another rank's shards have
    the same shapes and would pass unnoticed); a replicated leaf is kept
    as given."""
    from repro_torch.train.step import ShardedLayout
    cfg = tc.cfg_of("qwen3-moe-30b-a3b")
    lay = ShardedLayout(cfg, ("data", "model"), (1, 2), (0, 1), fsdp=False)
    full = model.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    local = lay.shard_tree(full)
    norm = full["layers"][0]["norm1"]["scale"]
    assert local["layers"][0]["norm1"]["scale"] is norm
    assert local["layers"][0]["ffn"]["wg"].shape[0] == cfg.num_experts // 2
    with pytest.raises(ValueError, match="the layout has"):
        lay.shard_tree(local)


def test_serve_cli_tp_2_gives_the_ids_of_tp_1(capsys):
    small = ["--arch", "qwen2-7b", "--reduced", "--requests", "4",
             "--prompt-len", "16", "--max-new", "4", "--width", "2",
             "--device", "cpu"]
    one = serve_cli.main(small)
    two = serve_cli.main(small + ["--tp", "2"])
    out = capsys.readouterr().out
    assert "[engine tp 2] 4 requests" in out
    assert [r.tokens for r in two.results] == [r.tokens for r in one.results]
    assert all(len(r.tokens) == 4 for r in two.results)


def test_serve_cli_tp_refuses_a_world_it_does_not_divide(monkeypatch):
    """Under a world of 3 ranks (as ``torchrun --nproc-per-node 3`` gives)
    ``--tp 2`` exits naming the world it needs, before any mesh."""
    monkeypatch.setattr(meshlib, "_world_size", lambda: 3)
    with pytest.raises(SystemExit, match="needs a world of a multiple of 2 "
                       "ranks.*this world has 3"):
        serve_cli.main(["--arch", "qwen2-7b", "--reduced", "--device",
                        "cpu", "--tp", "2"])
