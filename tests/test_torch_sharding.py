"""The port's placement rules (``repro_torch.sharding.specs``,
``sharding.gather_ctx.gather_spec``) and its mesh configuration against
the JAX reference's, on the CPU with no devices: exact equality of every
leaf's spec for all ten archs, full and ``reduced()``, at four mesh
shapes, with and without FSDP, with no worker axis, with 'pod' and with
('pod', 'data'). The reference's shapes come from its
``eval_shape_train_state`` (abstract, nothing allocated).

A spec is a tuple in the port and a ``PartitionSpec`` in the reference;
``tuple(PartitionSpec)`` gives the same entries.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import config as jconfig
from repro.configs import ASSIGNED_ARCHS
from repro.models import model as jmodel
from repro.sharding import gather_ctx as jgather
from repro.sharding import specs as jspecs
from repro.train import step as jstep
from repro_torch import config, convert
from repro_torch.config import TrainConfig, get_arch
from repro_torch.models import model
from repro_torch.models import transformer
from repro_torch.sharding import gather_ctx, specs
from repro_torch.train import step as tstep

SIZES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
         {"data": 4, "model": 2}, {"data": 2, "model": 2})
WORKER_AXES = ((), ("pod",), ("pod", "data"))
VARIANTS = [(a, r) for a in ASSIGNED_ARCHS for r in (False, True)]
IDS = [f"{a}{'-reduced' if r else ''}" for a, r in VARIANTS]


def _cfgs(arch, reduced):
    j, t = jconfig.get_arch(arch), get_arch(arch)
    return (j.reduced(), t.reduced()) if reduced else (j, t)


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _as_tree(tree):
    """A reference pytree of shape records as nested dicts and lists (a
    named tuple's fields by name), for the port's functions."""
    if isinstance(tree, dict):
        return {k: _as_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _as_tree(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, (list, tuple)):
        return [_as_tree(v) for v in tree]
    return tree


def _flat_ref(spec_tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(_key(k) for k in path): tuple(s) for path, s in leaves}


def _flat_port(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(_flat_port(v, path))
        elif v is not None:
            out[path] = v
    return out


@functools.lru_cache(maxsize=None)
def _ref_state(arch, reduced):
    jcfg, _ = _cfgs(arch, reduced)
    tcfg = jconfig.TrainConfig(vr="centralvr", vr_table_size=2)
    return jstep.eval_shape_train_state(jcfg, tcfg, W=2)


@pytest.mark.parametrize("arch,reduced", VARIANTS, ids=IDS)
def test_tree_specs_equal_the_reference_for_every_leaf(arch, reduced):
    """The whole W = 2 CentralVR state (params, VR table, anchors): every
    leaf's spec at every axis-size set, FSDP on and off, each worker
    layout, as the reference gives it."""
    jcfg, cfg = _cfgs(arch, reduced)
    shapes = _ref_state(arch, reduced)
    tree = _as_tree(shapes)
    n = 0
    for sizes in SIZES:
        for fsdp in (True, False):
            for w in WORKER_AXES:
                want = _flat_ref(jspecs.tree_specs(
                    shapes, jcfg, fsdp=fsdp, worker_axes=w,
                    axis_sizes=sizes))
                got = _flat_port(specs.tree_specs(
                    tree, cfg, fsdp=fsdp, worker_axes=w, axis_sizes=sizes))
                assert got == want, (sizes, fsdp, w)
                n += len(got)
        # without axis sizes (no divisibility fix), as param_specs gives
        want = _flat_ref(jspecs.param_specs(shapes.params, jcfg, fsdp=True,
                                            worker_axes=("pod",)))
        got = _flat_port(specs.param_specs(_as_tree(shapes.params), cfg,
                                           fsdp=True, worker_axes=("pod",)))
        assert got == want
    assert n > 0


@pytest.mark.parametrize("arch,reduced", VARIANTS, ids=IDS)
def test_layer_leaves_take_the_rule_of_their_stacked_leaf(arch, reduced):
    """The port's one-entry-per-layer params: each layer leaf's spec is the
    reference's for its stacked leaf without the stack axis, and the
    sharded layout's local shards have the shapes those specs give."""
    jcfg, cfg = _cfgs(arch, reduced)
    jparams = jax.eval_shape(functools.partial(jmodel.init_params, jcfg),
                             jax.random.PRNGKey(0))
    stack = jparams["layers"]["stack"]
    period = len(stack)
    tree = model.tree_map(
        lambda j, lay=model.ParamLayout(cfg): torch.empty(
            lay.shapes[j], device="meta"), model.ParamLayout(cfg).tree)
    n_stacked = (jax.tree_util.tree_leaves(stack[0])[0].shape[0] * period
                 if stack else 0)
    for sizes in SIZES:
        for fsdp in (True, False):
            want = _flat_ref(jspecs.tree_specs(jparams, jcfg, fsdp=fsdp,
                                               axis_sizes=sizes))
            got = _flat_port(specs.tree_specs(tree, cfg, fsdp=fsdp,
                                              axis_sizes=sizes))
            for path, spec in got.items():
                parts = path.split("/")
                if parts[0] != "layers":
                    assert spec == want[path], path
                    continue
                i, rest = int(parts[1]), "/".join(parts[2:])
                if i < n_stacked:
                    ref = want[f"layers/stack/{i % period}/{rest}"]
                    assert ref[0] is None and spec == ref[1:], path
                else:
                    assert spec == want[
                        f"layers/tail/{i - n_stacked}/{rest}"], path
    # the local shard shapes of a position of (data 2, model 2)
    lay = tstep.ShardedLayout(cfg, ("data", "model"), (2, 2), (1, 1),
                              fsdp=True)
    for j, (spec, full) in enumerate(zip(lay.specs, lay.full.shapes)):
        local = tuple(n // (2 if a else 1) for n, a in zip(full, spec))
        assert tuple(lay.shapes[j]) == local


@pytest.mark.parametrize("arch,reduced", VARIANTS, ids=IDS)
def test_gather_spec_equals_the_reference(arch, reduced):
    """The FSDP-removed use-time spec of every block leaf (block-relative
    paths, full shapes), where the reference's ``gather_ctx`` gives one
    and where it gives None."""
    jcfg, cfg = _cfgs(arch, reduced)
    for sizes in SIZES:
        jgather.enable(object(), jcfg, sizes)
        gather_ctx.enable(object(), cfg, sizes)
        try:
            for kind in set(cfg.layer_kinds()):
                for path, shape in gather_ctx.block_shapes(cfg, kind).items():
                    want = jgather.gather_spec(path, shape)
                    got = gather_ctx.gather_spec(path, shape)
                    assert got == (None if want is None else tuple(want)), (
                        kind, path, sizes)
            for path, shape in (("embed/tok", (cfg.vocab_size, cfg.d_model)),
                                ("head/w", (cfg.d_model, cfg.vocab_size))):
                want = jgather.gather_spec(path, shape)
                assert gather_ctx.gather_spec(path, shape) == (
                    None if want is None else tuple(want))
        finally:
            jgather.disable()
            gather_ctx.disable()
    assert not gather_ctx.active()
    assert gather_ctx.gather_spec("mixer/wq", (8, 2, 4)) is None


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-130m",
                                  "recurrentgemma-2b"])
def test_cache_and_batch_specs_equal_the_reference(arch):
    jcfg, cfg = _cfgs(arch, True)
    cache = jax.eval_shape(lambda: jmodel.init_cache(jcfg, 4, 16))
    want = _flat_ref(jspecs.cache_specs(cache, jcfg))
    assert _flat_port(specs.cache_specs(_as_tree(cache), cfg)) == want
    for w in ((), ("pod",), ("pod", "data"), ("data",)):
        for d in ((), ("data",), ("pod", "data")):
            assert specs.batch_specs(w, d) == tuple(jspecs.batch_specs(w, d))


def test_mesh_config_input_shapes_and_overrides_equal_the_reference():
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model")),
                         ((4, 2), ("data", "model"))):
        j = jconfig.MeshConfig(shape, names)
        t = config.MeshConfig(shape, names)
        assert (t.multi_pod, t.num_devices, t.data_axes()) == (
            j.multi_pod, j.num_devices, j.data_axes())
    assert dataclasses.asdict(config.MeshConfig()) == dataclasses.asdict(
        jconfig.MeshConfig())
    assert {k: dataclasses.asdict(v) for k, v in config.INPUT_SHAPES.items()
            } == {k: dataclasses.asdict(v)
                  for k, v in jconfig.INPUT_SHAPES.items()}
    over = {"seq_len": "128", "learning_rate": "0.5", "dp_replicated": "yes",
            "vr": "svrg"}
    assert dataclasses.asdict(config.apply_overrides(TrainConfig(), over)) \
        == dataclasses.asdict(jconfig.apply_overrides(jconfig.TrainConfig(),
                                                      over))
    cfg = config.apply_overrides(get_arch("qwen2-7b"), {"num_layers": "3"})
    assert cfg.num_layers == 3
    with pytest.raises(KeyError, match="no field 'nope'"):
        config.apply_overrides(TrainConfig(), {"nope": 1})


def test_shard_params_and_gather_flat_carry_the_reference_params():
    """Every position's local buffer from the reference's params, then put
    back together: the full flat buffer equals the unsharded load."""
    jcfg, cfg = _cfgs("qwen2-7b", True)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    pnp = jax.tree_util.tree_map(np.asarray, jparams)
    full = model.ParamLayout(cfg)
    want = full.load_(torch.empty(full.n), convert.lm_params_from_jax(pnp,
                                                                      cfg))
    for sizes in ({"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2},
                  {"data": 4, "model": 1}):
        shape = tuple(sizes.values())
        n = int(np.prod(shape))
        locs = [convert.shard_params(pnp, cfg, sizes,
                                     tuple(np.unravel_index(q, shape)))
                for q in range(n)]
        lay = tstep.ShardedLayout(cfg, tuple(sizes), shape, (0,) * len(shape),
                                  fsdp=True)
        assert all(loc.numel() == lay.n for loc in locs)
        assert lay.n < full.n
        assert torch.equal(convert.gather_flat(locs, cfg, sizes), want)


def test_sharded_init_draws_the_unsharded_params():
    """``init_train_state`` on a mesh position keeps its shard of each leaf
    drawn from the same generator: the shards equal the unsharded
    params'."""
    _, cfg = _cfgs("qwen2-7b", True)
    tcfg = TrainConfig(seq_len=16, global_batch=2, optimizer="sgd",
                       vr="centralvr", vr_table_size=2)
    full = tstep.init_train_state(cfg, tcfg, 1, device="cpu")
    lay = tstep.ShardedLayout(cfg, ("data", "model"), (2, 2), (0, 1),
                              fsdp=True)
    flat = lay.init_(torch.empty(lay.n),
                     torch.Generator().manual_seed(tcfg.seed))
    for view, fview, sl in zip(lay.leaf_views(flat),
                               full.layout.leaf_views(full.params[0]),
                               lay.slices):
        assert torch.equal(view, fview[sl])


def test_eval_shape_train_state_allocates_nothing():
    _, cfg = _cfgs("qwen1.5-110b", False)
    tcfg = TrainConfig(vr="centralvr", vr_table_size=2, optimizer="sgd")
    st = tstep.eval_shape_train_state(cfg, tcfg, 2)
    n = model.ParamLayout(cfg).n
    assert st.params.device.type == "meta" and st.params.shape == (2, n)
    assert len(st.vr_state.table) == 2 and st.vr_state.gbar.is_meta
    assert n == cfg.param_count()
    jcfg = jconfig.get_arch("qwen1.5-110b")
    jshapes = jstep.eval_shape_train_state(
        jcfg, jconfig.TrainConfig(vr="centralvr", vr_table_size=2), W=2)
    assert sum(int(np.prod(x.shape)) for x in
               jax.tree_util.tree_leaves(jshapes.params)) == 2 * n


def test_state_and_batch_shardings_equal_the_reference():
    """On a (1, 1) mesh of one rank and of one jax device."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as meshlib

    jcfg, cfg = _cfgs("qwen2-7b", True)
    jm = jmesh.make_test_mesh()
    m = meshlib.make_test_mesh(device="cpu")
    assert meshlib.mesh_axis_sizes(m) == jmesh.mesh_axis_sizes(jm)
    for vr in ("none", "centralvr"):
        jt = jconfig.TrainConfig(vr=vr, vr_table_size=2)
        t = TrainConfig(vr=vr, vr_table_size=2, optimizer="sgd")
        for wk in ("none", "data", "pod"):
            assert tstep.batch_sharding(m, t, wk, with_fe=True) == {
                k: tuple(v.spec) for k, v in jstep.batch_sharding(
                    jm, jt, wk, with_fe=True).items()}
        shapes = jstep.eval_shape_train_state(jcfg, jt, W=1)
        want = _flat_ref(jax.tree_util.tree_map(
            lambda s: s.spec, jstep.state_shardings(shapes, jcfg, jt, jm,
                                                    "none").params))
        got = _flat_port(tstep.state_shardings(
            tstep.eval_shape_train_state(cfg, t, 1), cfg, t, m, "none"))
        for path, spec in got.items():
            parts = path.split("/")
            if parts[0] == "layers":
                key = f"layers/stack/0/{'/'.join(parts[2:])}"
                assert spec == want[key][1:], path
            else:
                assert spec == want[path], path


def test_block_shapes_are_the_blocks_leaves():
    _, cfg = _cfgs("qwen2-7b", True)
    shapes = gather_ctx.block_shapes(cfg, "attn")
    block = transformer.init_block(cfg, "attn", lambda s, i: tuple(s))
    assert shapes["mixer/wq"] == block["mixer"]["wq"]
    assert shapes["ffn/wd"] == (cfg.d_ff, cfg.d_model)
