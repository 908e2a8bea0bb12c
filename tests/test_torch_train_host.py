"""The port's per-step runtime (``repro_torch.train.host_loop``,
``train.step.make_train_step``) against the JAX reference's, on the CPU
in float32 at ``LM_TOL``: the reduced Qwen2-7B and Mamba2-130M, W in
{1, 2}, every vr mode, 5 steps (not a multiple of M*K = 2), from the
reference's params and tokens. And against the port's own epoch runner:
the same kernels in the same order, so bit for bit.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.data import synthetic as jsynthetic
from repro.launch import mesh as jmesh
from repro.train import host_loop as jhost
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.config import TrainConfig
from repro_torch.launch import mesh as meshlib
from repro_torch.models import model
from repro_torch.train import host_loop, loop
from repro_torch.train import step as tstep
from torch_lm_common import LM_TOL, assert_trees_close, cfgs, train_kw

STEPS = 5
VRS = ("none", "centralvr", "svrg", "saga")


@functools.lru_cache(maxsize=None)
def _reference(arch, vr, W):
    """The reference's host loop: (initial params of worker 0, token
    block, eval batch, losses, eval loss, final params per worker)."""
    jcfg, _ = cfgs(arch=arch)
    tcfg = JTrainConfig(**train_kw(vr, W))
    accum, mb = jstep.batch_geometry(tcfg, W)
    state = jax.jit(jstep.init_train_state, static_argnums=(0, 1, 3))(
        jcfg, tcfg, jax.random.PRNGKey(0), W)
    p0 = jax.tree_util.tree_map(lambda x: np.asarray(x[0] if W > 1 else x),
                                state.params)
    toks = np.asarray(jsynthetic.epoch_tokens(
        jcfg, tcfg.seed, workers=W, steps=2, accum=accum, microbatch=mb,
        seq=tcfg.seq_len, table_size=2))
    ev = np.asarray(jsynthetic.eval_batch(jcfg, tcfg.seed, batch=mb,
                                          seq=tcfg.seq_len))
    res = jhost.run_training(jcfg, tcfg, steps=STEPS,
                             workers=W if W > 1 else None, log_every=0)
    final = [jax.tree_util.tree_map(
        lambda x, w=w: np.asarray(x[w] if W > 1 else x), res.state.params)
        for w in range(W)]
    return p0, toks, ev, np.asarray(res.losses), res.final_eval_loss, final


def _port(arch, vr, W, p0, toks, ev, steps=STEPS):
    _, cfg = cfgs(arch=arch)
    return host_loop.run_training(
        cfg, TrainConfig(**train_kw(vr, W)), steps=steps,
        workers=W if W > 1 else None, device="cpu", log_every=0,
        params=convert.lm_params_from_jax(p0, cfg),
        tokens=convert.tokens_from_jax(toks),
        eval_tokens=torch.from_numpy(np.array(ev)))


@pytest.mark.parametrize("vr", VRS)
@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-130m"])
def test_host_loop_matches_the_reference(arch, W, vr):
    p0, toks, ev, want_losses, want_eval, want_params = _reference(arch, vr,
                                                                   W)
    res = _port(arch, vr, W, p0, toks, ev)
    _, cfg = cfgs(arch=arch)
    assert res.steps == STEPS and len(res.losses) == STEPS
    np.testing.assert_allclose(res.losses, want_losses, **LM_TOL)
    np.testing.assert_allclose(res.final_eval_loss, want_eval, **LM_TOL)
    for w in range(W):
        assert_trees_close(res.state.param_tree(w),
                           convert.lm_params_from_jax(want_params[w], cfg),
                           **LM_TOL)


def test_make_train_step_on_the_test_mesh_matches_the_reference():
    """One rank's (1, 1) mesh against the reference's ``make_test_mesh()``
    on its one device: losses and every param after each step."""
    arch, vr, W = "qwen2-7b", "centralvr", 1
    jcfg, cfg = cfgs(arch=arch)
    jt = JTrainConfig(**train_kw(vr, W))
    jm = jmesh.make_test_mesh()
    jfn, jmeta = jstep.make_train_step(jcfg, jt, jm, "none")
    js = jstep.init_train_state(jcfg, jt, jax.random.PRNGKey(0), W)
    p0 = jax.tree_util.tree_map(np.asarray, js.params)
    m = meshlib.make_test_mesh(device="cpu")
    assert (m.shape, m.axis_names) == (jm.devices.shape, jm.axis_names)
    fn, meta = tstep.make_train_step(cfg, TrainConfig(**train_kw(vr, W)), m)
    assert {k: meta[k] for k in jmeta} == jmeta
    state = tstep.init_train_state(cfg, TrainConfig(**train_kw(vr, W)), W,
                                   params=convert.lm_params_from_jax(p0, cfg),
                                   mesh=m)
    jfn = jax.jit(jfn)
    for s in range(STEPS):
        toks = np.asarray(jsynthetic.epoch_batch(
            jcfg, 0, s, workers=1, accum=2, microbatch=1, seq=16,
            table_size=2))[0]
        js, jl = jfn(js, toks)
        state, out = fn(state, convert.tokens_from_jax(toks))
        np.testing.assert_allclose(float(out["loss"]), float(jl["loss"]),
                                   **LM_TOL)
        assert_trees_close(state.param_tree(0), convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, js.params), cfg), **LM_TOL)
    assert state.step == STEPS


@pytest.mark.parametrize("vr", ["none", "centralvr", "svrg", "saga"])
@pytest.mark.parametrize("W", [1, 2])
def test_host_loop_equals_the_epoch_runner_bit_for_bit(W, vr):
    """Two epochs of the epoch loop and four steps of the host loop from
    the same seed: the same kernels' plain versions in the same order."""
    _, cfg = cfgs()
    tcfg = TrainConfig(**train_kw(vr, W))
    a = host_loop.run_training(cfg, tcfg, steps=4,
                               workers=W if W > 1 else None, device="cpu",
                               log_every=0, fused=True)
    b = loop.run_training(cfg, tcfg, epochs=2, workers=W, device="cpu",
                          log_every=0, fused=True)
    assert a.losses == b.losses
    assert torch.equal(a.state.params, b.state.params)
    assert a.final_eval_loss == b.final_eval_loss


def test_eval_uses_the_worker_average_not_worker_0():
    """Stopped mid-epoch, the W = 2 copies have diverged; the eval loss is
    the averaged params' (the reference's test_train_scan pin)."""
    _, cfg = cfgs()
    tcfg = TrainConfig(**train_kw("centralvr", 2))
    res = host_loop.run_training(cfg, tcfg, steps=1, workers=2,
                                 device="cpu", log_every=0)
    p = res.state.params
    assert float((p[0] - p[1]).abs().max()) > 0.0
    from repro_torch.data import synthetic
    ev = synthetic.eval_batch(cfg, tcfg.seed, batch=1, seq=tcfg.seq_len)

    def at(flat):
        with torch.no_grad():
            return float(model.loss_fn(res.state.layout.views(flat), cfg,
                                       {"tokens": ev}, remat="none"))
    assert res.final_eval_loss == at(p.mean(0))
    assert res.final_eval_loss != at(p[0])


def test_the_host_loop_logs_and_checkpoints_every_so_many_steps(tmp_path):
    from repro_torch.checkpoint import checkpoint as ckpt
    _, cfg = cfgs()
    tcfg = TrainConfig(**train_kw("centralvr", 2))
    lines = []
    path = str(tmp_path / "ck.npz")
    res = host_loop.run_training(cfg, tcfg, steps=3, workers=2,
                                 device="cpu", log_every=2,
                                 log_fn=lines.append, checkpoint_path=path,
                                 checkpoint_every=2)
    assert [ln.split()[1] for ln in lines] == ["0", "2"]
    assert ckpt.latest_step(path) == 3
    state = tstep.init_train_state(cfg, tcfg, 2, device="cpu")
    loop.restore_state(path, state)
    assert torch.equal(state.params, res.state.params)
    assert state.step == 3


def test_make_train_step_refusals():
    _, cfg = cfgs()
    m = meshlib.make_test_mesh(device="cpu")
    tcfg = TrainConfig(**dict(train_kw("centralvr", 1), optimizer="adam"))
    with pytest.raises(ValueError, match="plain SGD update"):
        tstep.make_train_step(cfg, tcfg, m, fused=True)
    fn, meta = tstep.make_train_step(cfg, TrainConfig(**train_kw("none", 1)),
                                     m)
    state = tstep.init_train_state(cfg, TrainConfig(**train_kw("none", 1)),
                                   1, mesh=m)
    with pytest.raises(ValueError, match="tokens has shape"):
        fn(state, torch.zeros(1, 2, 1, 16, dtype=torch.int64))
    with pytest.raises(ValueError, match="device="):
        tstep.make_train_step(cfg, TrainConfig(**train_kw("none", 1)), m,
                              device="meta")
    with pytest.raises(ValueError, match="make_test_mesh"):
        meshlib.make_test_mesh(devices=4, device="cpu")
