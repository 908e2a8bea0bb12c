"""The port's checkpoints (``repro_torch.checkpoint``) and the LM loop's
checkpoint and resume (``train/loop.py``), against the JAX reference.

The four cases of the reference's ``tests/test_checkpoint_roundtrip.py``
on the port (a CentralVR run interrupted at an epoch boundary, saved,
restored and continued is the uninterrupted run; the LM loop resumed from
an epoch-boundary save is the uninterrupted loop; an elastic checkpoint
restored at a new shape continues as the elastic run that dropped there;
a ``SyncState`` round-trips), checkpoints read across the two packages
in both directions (the format and the tree keys are the reference's), a
bfloat16-master ``TrainState`` round-tripping bit for bit (numpy has no
bfloat16: the bits are stored), and the train launcher's
``--checkpoint``/``--resume``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jcheckpoint
from repro.checkpoint import elastic as jeckpt
from repro.config import ConvexConfig as JConvexConfig
from repro.core import centralvr as jcentralvr
from repro.core import convex as jconvex
from repro.core import distributed as jdistributed
from repro.core import elastic as jelastic
from repro_torch import convert
from repro_torch.checkpoint import checkpoint
from repro_torch.checkpoint import elastic as eckpt
from repro_torch.config import (ConvexConfig, ModelConfig, TrainConfig,
                                get_arch)
from repro_torch.core import centralvr, convex, distributed, elastic
from repro_torch.launch import train as launch_train
from repro_torch.train import loop
from repro_torch.train import step as tstep

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_centralvr_roundtrip_continues_trajectory(tmp_path):
    prob = convex.make_logistic_data(_gen(0), 96, 9)
    eta = convex.auto_eta(prob, 0.3)
    g0 = convex.grad_norm0(prob)
    init, per = centralvr.draw_orders(_gen(3), prob.n, 6)

    def run(st, orders):
        rels = []
        for order in orders:
            st = centralvr.epoch(prob, st, eta, order)
            rels.append(float(convex.rel_grad_norm(prob, st.x, g0)))
        return st, rels

    _, rels_full = run(centralvr.init_state(prob, eta, init), per)
    st_half, rels_a = run(centralvr.init_state(prob, eta, init), per[:3])
    path = str(tmp_path / "centralvr.npz")
    checkpoint.save(path, st_half, step=3)
    assert checkpoint.latest_step(path) == 3
    restored = checkpoint.restore(path, like=st_half)
    assert isinstance(restored, centralvr.VRState)
    for got, want in zip(restored, st_half):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    _, rels_b = run(restored, per[3:])
    assert rels_a + rels_b == rels_full


def _tiny_lm():
    cfg = ModelConfig(name="tiny-resume", family="dense", num_layers=2,
                      d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
                      vocab_size=128, dtype="float32",
                      param_dtype="float32")
    tcfg = TrainConfig(seq_len=16, global_batch=4, microbatch=2,
                       optimizer="adam", learning_rate=1e-3,
                       vr="centralvr", vr_table_size=2, local_epoch=1)
    return cfg, tcfg


def test_lm_epoch_scan_resume_continues_trajectory(tmp_path):
    """Save at an epoch boundary, resume with ``resume=True``: the
    continued per-step losses and the final eval loss are the
    uninterrupted run's, exactly (the token stream is replayed, the VR
    table and anchor and the optimiser state ride the checkpoint)."""
    cfg, tcfg = _tiny_lm()
    kw = dict(workers=2, log_every=0, device="cpu")
    full = loop.run_training(cfg, tcfg, epochs=4, **kw)
    path = str(tmp_path / "lm.npz")
    first = loop.run_training(cfg, tcfg, epochs=2, checkpoint_path=path,
                              checkpoint_every=2, **kw)
    assert checkpoint.latest_step(path) == 2 * 2   # epoch boundary
    with open(path + ".json") as f:
        man = json.load(f)
    assert man["scratch"] == ["grad"] and "grad" not in man["keys"]
    resumed = loop.run_training(cfg, tcfg, epochs=4, checkpoint_path=path,
                                resume=True, **kw)
    assert len(resumed.losses) == len(full.losses) - len(first.losses)
    assert first.losses + resumed.losses == full.losses
    assert resumed.final_eval_loss == full.final_eval_loss
    assert checkpoint.latest_step(path) == 4 * 2
    with pytest.raises(ValueError, match="nothing left"):
        loop.run_training(cfg, tcfg, epochs=4, checkpoint_path=path,
                          resume=True, **kw)


@pytest.mark.parametrize("vr,opt", [("saga", "sgd"), ("svrg", "momentum")])
def test_lm_resume_carries_every_vr_mode(tmp_path, vr, opt):
    """SAGA's running gbar and row index, SVRG's snapshot and its
    gradient, momentum's buffer: resume == uninterrupted."""
    cfg, tcfg = _tiny_lm()
    tcfg = dataclasses.replace(tcfg, vr=vr, optimizer=opt)
    kw = dict(workers=2, log_every=0, device="cpu")
    full = loop.run_training(cfg, tcfg, epochs=3, **kw)
    path = str(tmp_path / "lm")
    first = loop.run_training(cfg, tcfg, epochs=1, checkpoint_path=path,
                              **kw)
    resumed = loop.run_training(cfg, tcfg, epochs=3, checkpoint_path=path,
                                resume=True, **kw)
    assert first.losses + resumed.losses == full.losses
    assert resumed.final_eval_loss == full.final_eval_loss


def _fused_resume(tmp_path, arch):
    cfg = get_arch(arch).reduced()
    tcfg = TrainConfig(seq_len=16, global_batch=4, microbatch=2,
                       optimizer="sgd", learning_rate=0.1, vr="centralvr",
                       vr_table_size=2, local_epoch=1)
    kw = dict(workers=2, log_every=0, device="cpu", fused=True)
    full = loop.run_training(cfg, tcfg, epochs=2, **kw)
    path = str(tmp_path / "m.npz")
    first = loop.run_training(cfg, tcfg, epochs=1, checkpoint_path=path,
                              checkpoint_every=1, **kw)
    resumed = loop.run_training(cfg, tcfg, epochs=2, checkpoint_path=path,
                                resume=True, **kw)
    assert first.losses + resumed.losses == full.losses
    assert resumed.final_eval_loss == full.final_eval_loss


def test_fused_mamba2_resume_continues_trajectory(tmp_path):
    """The kernels' path (``fused=True``: K1, K2, K4, their plain versions
    on the CPU) at ``mamba2-130m.reduced()``: resume == uninterrupted."""
    _fused_resume(tmp_path, "mamba2-130m")


def test_fused_moe_resume_continues_trajectory(tmp_path):
    """The kernels' path (K1, K2, K3) at ``qwen3-moe-30b-a3b.reduced()``,
    its routed FFN and aux loss included: resume == uninterrupted."""
    _fused_resume(tmp_path, "qwen3-moe-30b-a3b")


def test_lm_resume_refuses_a_step_off_the_epoch_boundary(tmp_path):
    cfg, tcfg = _tiny_lm()
    path = str(tmp_path / "odd")
    state = tstep.init_train_state(cfg, tcfg, 1, device="cpu")
    state.step = 3
    loop.save_state(path, state)
    with pytest.raises(ValueError, match="not an epoch boundary"):
        loop.run_training(cfg, tcfg, epochs=4, checkpoint_path=path,
                          resume=True, log_every=0, device="cpu")


def test_bf16_train_state_round_trips_bit_for_bit(tmp_path):
    """bfloat16 masters (params, VR table, gbar, gtilde): saved as their
    bits, restored into a fresh state's buffers in place."""
    cfg, tcfg = _tiny_lm()
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16", dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, optimizer="sgd")
    run, _ = tstep.make_epoch_runner(cfg, tcfg, 2, device="cpu")
    state = tstep.init_train_state(cfg, tcfg, 2, device="cpu")
    state, _ = run(state)
    path = str(tmp_path / "bf16")
    nbytes = loop.save_state(path, state)
    assert nbytes > 2 * state.params.numel() * 2
    with open(path + ".json") as f:
        man = json.load(f)
    assert man["dtypes"]["params"] == "bfloat16"
    assert man["dtypes"]["vr_state/table/0"] == "bfloat16"
    fresh = tstep.init_train_state(cfg, tcfg, 2, device="cpu")
    view = fresh.layout.leaf_views(fresh.params[1])[0]
    params, rows = fresh.params, list(fresh.vr_state.table)
    loop.restore_state(path, fresh)
    assert fresh.params is params
    assert all(a is b for a, b in zip(fresh.vr_state.table, rows))

    def bits(t):
        return t.view(torch.int16)

    assert torch.equal(bits(fresh.params), bits(state.params))
    for a, b in zip(fresh.vr_state.table, state.vr_state.table):
        assert torch.equal(bits(a), bits(b))
    for name in ("gbar", "gtilde"):
        assert torch.equal(bits(getattr(fresh.vr_state, name)),
                           bits(getattr(state.vr_state, name)))
    assert (fresh.step, fresh.vr_state.idx) == (state.step,
                                                state.vr_state.idx)
    # a view the model took before the restore sees the restored params
    assert torch.equal(bits(view),
                       bits(state.layout.leaf_views(state.params[1])[0]))


def test_elastic_roundtrip_across_mesh_shapes(tmp_path):
    """A p = 4 checkpoint restored at p = 3 and p = 2 re-shards the VR
    tables losslessly, and the continued trajectory is bit-identical to
    the elastic run that dropped to that shape at the same boundary."""
    cfg = ConvexConfig(problem="logistic", n=48, d=8, seed=0, workers=4)
    sp = distributed.make_distributed(_gen(0), cfg)
    eta = convex.auto_eta(sp.merged())
    g0 = convex.grad_norm0(sp.merged())
    speeds = (1.0, 1.0, 2.0, 4.0)
    rounds = 6
    elastic.run_async_elastic(sp, eta=eta, rounds=rounds, speeds=speeds,
                              checkpoint_dir=str(tmp_path),
                              checkpoint_every=3)
    path = str(tmp_path / "elastic_00003")
    man = eckpt.load_manifest(path)
    assert man["p"] == 4 and man["round"] == 3
    for live in ((0, 2, 3), (0, 3)):
        p_new = len(live)
        st_new, _ = eckpt.restore_elastic(path, p_new, device="cpu")
        assert st_new.tables.shape == (p_new, 4 * 48 // p_new)
        st_same, _ = eckpt.restore_elastic(path, device="cpu")
        assert torch.equal(elastic.merge_tables(st_new.tables),
                           elastic.merge_tables(st_same.tables))
        _, rels_cont = elastic.continue_async(
            elastic.reshard_problem(sp, p_new), st_new, eta=eta, g0=g0,
            start_round=3, rounds=rounds,
            speeds=elastic.survivor_speeds(speeds, live))
        res_drop = elastic.run_async_elastic(
            sp, eta=eta, rounds=rounds, speeds=speeds,
            membership=elastic.PlannedMembership(4, {3: live}))
        assert torch.equal(rels_cont, res_drop.rels[3:])


def test_sync_state_roundtrip(tmp_path):
    cfg = ConvexConfig(problem="ridge", n=32, d=6, workers=3)
    sp = distributed.make_distributed(_gen(1), cfg)
    eta = convex.auto_eta(sp.merged(), 0.3)
    st, _ = distributed.run_sync(sp, eta=eta, rounds=2, seed=2)
    path = str(tmp_path / "sync.npz")
    checkpoint.save(path, st, step=2)
    restored = checkpoint.restore(path, like=st)
    assert isinstance(restored, distributed.SyncState)
    for got, want in zip(restored, st):
        assert got.dtype == want.dtype and torch.equal(got, want)


def _reference_states():
    """The reference's SyncState, VRState and a wave-boundary AsyncState
    (float64), with the port's problems."""
    cfg = JConvexConfig(problem="ridge", n=16, d=5, workers=2)
    sp = jdistributed.make_distributed(jax.random.PRNGKey(1), cfg)
    eta = jconvex.auto_eta(sp.merged(), 0.3)
    st_sync, _ = jdistributed.run_sync(sp, eta=eta, rounds=2,
                                       key=jax.random.PRNGKey(2))
    prob = jconvex.make_logistic_data(jax.random.PRNGKey(0), 24, 4)
    st_vr = jcentralvr.init_state(prob, 0.1, jax.random.PRNGKey(3))
    return st_sync, st_vr


def test_reference_checkpoints_restore_in_the_port(tmp_path):
    st_sync, st_vr = _reference_states()
    for st, conv in ((st_sync, convert.to_sync_state),
                     (st_vr, convert.to_vr_state)):
        path = str(tmp_path / type(st).__name__)
        jcheckpoint.save(path, st, step=5)
        like = conv(st, device="cpu")
        restored = checkpoint.restore(path + ".npz", like)
        assert checkpoint.latest_step(path) == 5
        assert type(restored) is type(like)
        for got, want in zip(restored, st):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_checkpoints_restore_in_the_reference(tmp_path):
    st_sync, st_vr = _reference_states()
    for st, conv in ((st_sync, convert.to_sync_state),
                     (st_vr, convert.to_vr_state)):
        path = str(tmp_path / type(st).__name__)
        checkpoint.save(path, conv(st, device="cpu"), step=7)
        restored = jcheckpoint.restore(path, like=st)
        assert jcheckpoint.latest_step(path) == 7
        for got, want in zip(restored, st):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("p_new", [None, 2])
def test_elastic_checkpoints_cross_the_packages(tmp_path, p_new):
    """Either package's wave-boundary checkpoint restores in the other, at
    the saved shape and at a new one."""
    st = jelastic.resync_state(np.linspace(0, 1, 5), np.linspace(1, 2, 5),
                               np.linspace(-1, 1, 24), 4)
    jeckpt.save_elastic(str(tmp_path / "ref"), st, round_=3,
                        live=(0, 1, 2, 3), p0=4)
    eckpt.save_elastic(str(tmp_path / "port"),
                       convert.to_async_state(st, device="cpu"), round_=3,
                       live=(0, 1, 2, 3), p0=4)
    assert (eckpt.load_manifest(str(tmp_path / "port"))
            == jeckpt.load_manifest(str(tmp_path / "ref")))
    want, _ = jeckpt.restore_elastic(str(tmp_path / "port"), p_new)
    have, _ = eckpt.restore_elastic(str(tmp_path / "ref"), p_new,
                                    device="cpu")
    for name in jdistributed.AsyncState._fields:
        np.testing.assert_array_equal(getattr(have, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert eckpt.latest_elastic(str(tmp_path)) is None   # no elastic_ names


def test_train_launcher_checkpoint_and_resume(tmp_path, capsys):
    """``python -m repro_torch.launch.train --checkpoint f.npz --resume``
    on the CPU: the resumed launch trains the epochs left."""
    path = str(tmp_path / "f.npz")
    argv = ["--arch", "qwen2-7b", "--reduced", "--seq-len", "16",
            "--global-batch", "4", "--microbatch", "2", "--num-workers", "2",
            "--vr-table-size", "2", "--optimizer", "sgd", "--lr", "0.1",
            "--device", "cpu", "--checkpoint", path]
    launch_train.main(argv + ["--epochs", "1", "--checkpoint-every", "1"])
    assert checkpoint.latest_step(path) == 2
    capsys.readouterr()
    launch_train.main(argv + ["--epochs", "2", "--resume"])
    out = capsys.readouterr().out
    assert "epoch    1  step      4" in out and "epoch    0" not in out
    assert checkpoint.latest_step(path) == 4
