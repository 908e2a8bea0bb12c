"""The LM training slice of the PyTorch port against the JAX reference:
configs, the synthetic finite-sum stream, the params conversion, the loss
and its gradients, the optimizers and VR corrections, the epoch runner
(every vr mode, W in {1, 2}, fused and unfused), the training loop and
the launcher, and the contracts (error texts, device choice, the
package boundary).

Everything runs on the CPU with the reference's params and tokens fed to
the port (randomness is data). The fused path's kernels run their plain
versions here; ``test_torch_lm_kernels.py`` holds those against the
reference's kernels, and ``test_torch_cuda.py`` the CUDA kernels against
them on the card.
"""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_arch as jget_arch
from repro.data import synthetic as jsynthetic
from repro.models import model as jmodel
from repro.optim import optimizers as joptim
from repro.optim import vr_wrapper as jvr
from repro.train import loop as jloop
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.config import ModelConfig, TrainConfig, get_arch
from repro_torch.data import synthetic
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.vr_update import kernel as vr_kernel
from repro_torch.launch import train as launch_train
from repro_torch.models import kernel_ctx, model
from repro_torch.optim import optimizers, vr_wrapper
from repro_torch.train import loop
from repro_torch.train import step as tstep

from torch_lm_common import (LM_TOL, assert_trees_close, cfgs, port_run,
                             reference_run, train_kw)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


# ---------------------------------------------------------------------------
# configs, data, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_the_reference_config(reduced):
    ref, port = jget_arch("qwen2-7b"), get_arch("qwen2-7b")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.layer_kinds() == ref.layer_kinds()
    assert model.ParamLayout(port).n == port.param_count()
    assert (dataclasses.asdict(TrainConfig())
            == dataclasses.asdict(JTrainConfig()))


def test_slice_size_at_full_width():
    """Qwen2-7B width cut to 2 layers: 1,556,113,920 parameters, 6.22 GB
    in float32 (the reckoning behind the flat state's memory)."""
    cfg = dataclasses.replace(get_arch("qwen2-7b"), num_layers=2)
    assert model.ParamLayout(cfg).n == cfg.param_count() == 1_556_113_920
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


def test_other_block_kinds_raise_naming_the_roadmap_item():
    """ssm blocks are ported (tests/test_torch_ssm.py); the hybrid
    recurrent blocks and MoE FFNs are not."""
    base = dict(num_layers=3, d_model=32, num_heads=2, num_kv_heads=2,
                d_ff=64, vocab_size=64)
    for cfg in (ModelConfig(name="h", family="hybrid",
                            block_pattern=("rec", "rec", "attn"),
                            rglru_heads=2, local_window=8, **base),
                ModelConfig(name="m", family="moe", num_experts=4,
                            num_experts_per_tok=2, moe_d_ff=32, **base)):
        with pytest.raises(NotImplementedError, match="item 12"):
            model.ParamLayout(cfg)


def test_synthetic_stream_is_a_finite_sum():
    cfg = get_arch("qwen2-7b").reduced()
    a = synthetic.microbatch_tokens(cfg, 0, 1, 3, 2, 32)
    assert torch.equal(a, synthetic.microbatch_tokens(cfg, 0, 1, 3, 2, 32))
    assert not torch.equal(a, synthetic.microbatch_tokens(cfg, 0, 1, 4, 2,
                                                          32))
    assert a.shape == (2, 32) and 0 <= a.min() and a.max() < cfg.vocab_size
    block = synthetic.epoch_tokens(cfg, 0, workers=2, steps=4, accum=2,
                                   microbatch=1, seq=16, table_size=2)
    assert block.shape == (2, 4, 2, 1, 16)
    # step k uses component k mod M: steps 0 and 2 replay the same tokens
    assert torch.equal(block[:, 0], block[:, 2])
    assert not torch.equal(block[:, 0], block[:, 1])
    assert not torch.equal(block[0], block[1])
    ev = synthetic.eval_batch(cfg, 0, batch=1, seq=16)
    assert ev.shape == (1, 16) and not torch.equal(ev, block[0, 0, 0])


def test_lm_params_from_jax_unstacks_layers_in_order():
    jcfg, cfg = cfgs()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = convert.lm_params_from_jax(params, cfg)
    stack = params["layers"]["stack"][0]
    assert len(tree["layers"]) == 2
    for i, layer in enumerate(tree["layers"]):
        np.testing.assert_array_equal(layer["mixer"]["wq"].numpy(),
                                      np.asarray(stack["mixer"]["wq"][i]))
    flat = model.ParamLayout(cfg).load_(
        torch.empty(model.ParamLayout(cfg).n), tree)
    assert flat.numel() == cfg.param_count()
    with pytest.raises(ValueError, match="layers"):
        convert.lm_params_from_jax(params,
                                   dataclasses.replace(cfg, num_layers=3))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _loss_and_grads(remat, dtype="float32"):
    jcfg, cfg = cfgs(dtype)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0,
                              jcfg.vocab_size)
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {"tokens": toks},
                                 remat=remat))(params)
    tree = model.tree_map(lambda t: t.requires_grad_(),
                          convert.lm_params_from_jax(params, cfg))
    got = model.loss_fn(tree, cfg, {"tokens": convert.tokens_from_jax(toks)},
                        remat=remat)
    got.backward()
    return (got.item(), float(loss), model.tree_map(lambda t: t.grad, tree),
            convert.lm_params_from_jax(grads, cfg))


@pytest.mark.parametrize("remat", ["none", "block", "dots"])
def test_loss_and_grads_match_reference(remat):
    got, want, g_port, g_ref = _loss_and_grads(remat)
    np.testing.assert_allclose(got, want, **LM_TOL)
    assert_trees_close(g_port, g_ref, **LM_TOL)


def test_bf16_loss_matches_reference():
    """bfloat16 compute: both packages round each product and activation
    to 8 significand bits, at different places (the matmul libraries
    differ), so the loss agrees to a bf16 ulp (2**-8 = 3.9e-3 relative),
    not to float32 precision."""
    got, want, _, _ = _loss_and_grads("block", dtype="bfloat16")
    np.testing.assert_allclose(got, want, rtol=4e-3)


def test_remat_recomputes_the_same_gradients():
    """"block" recomputes each block, "dots" (the reference's
    checkpoint_dots_with_no_batch_dims) keeps the plain 2-D products and
    recomputes the rest: both give the gradients of "none" bit for bit,
    and a policy the reference does not have is refused."""
    _, cfg = cfgs()
    toks = synthetic.microbatch_tokens(cfg, 0, 0, 0, 2, 24)
    grads = {}
    for remat in ("none", "block", "dots"):
        tree = model.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        model.tree_map(lambda t: t.requires_grad_(), tree)
        model.loss_fn(tree, cfg, {"tokens": toks}, remat=remat).backward()
        grads[remat] = model.tree_map(lambda t: t.grad, tree)
    for remat in ("block", "dots"):
        model.tree_zip(lambda a, b: np.testing.assert_array_equal(
            a.numpy(), b.numpy()), grads["none"], grads[remat])
    with pytest.raises(ValueError, match="remat"):
        model.loss_fn(tree, cfg, {"tokens": toks}, remat="offload")


def test_remat_dots_saves_only_the_plain_products(monkeypatch):
    """Under "dots" the backward recomputes no 2-D product (they are
    saved) and does recompute the rest of the block (here the attention
    score products, which have batch dimensions)."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.models import transformer
    seen, save_dots = {}, transformer._save_dots

    def spy(ctx, op, *args, **kwargs):
        policy = save_dots(ctx, op, *args, **kwargs)
        seen.setdefault(policy, set()).add(str(op))
        return policy
    monkeypatch.setattr(transformer, "_save_dots", spy)
    _, cfg = cfgs()
    tree = model.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    model.tree_map(lambda t: t.requires_grad_(), tree)
    toks = synthetic.microbatch_tokens(cfg, 0, 0, 0, 2, 24)
    model.loss_fn(tree, cfg, {"tokens": toks}, remat="dots").backward()
    assert seen[CheckpointPolicy.MUST_SAVE] == {"aten.mm.default"}
    assert "aten.mm.default" not in seen[CheckpointPolicy.PREFER_RECOMPUTE]
    assert "aten.bmm.default" in seen[CheckpointPolicy.PREFER_RECOMPUTE]


def test_padded_heads_start_at_zero_like_the_reference():
    """With pad_heads_to set, the padded heads' columns of wq and rows of
    wo are zero at init, as the reference makes them, whether the params
    are drawn as a tree or into the trainer's flat buffer."""
    jcfg, cfg = cfgs()
    jcfg = dataclasses.replace(jcfg, pad_heads_to=6)
    cfg = dataclasses.replace(cfg, pad_heads_to=6)
    n = cfg.num_heads
    ref = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    layout = model.ParamLayout(cfg)
    flat = layout.init_(torch.empty(layout.n),
                        torch.Generator().manual_seed(0))
    trees = (model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu"), layout.views(flat),
             convert.lm_params_from_jax(ref, cfg))
    for tree in trees:
        for layer in tree["layers"]:
            wq, wo = layer["mixer"]["wq"], layer["mixer"]["wo"]
            assert wq.shape[1] == wo.shape[0] == 6
            assert torch.all(wq[:, n:] == 0) and torch.all(wo[n:] == 0)
            assert torch.all(wq[:, :n] != 0) and torch.all(wo[:n] != 0)


# ---------------------------------------------------------------------------
# optimizers and VR corrections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((3, 7)).astype(np.float32)
    grads = rng.standard_normal((4, 3, 7)).astype(np.float32)
    jopt, opt = joptim.make(name, 0.1, 0.05), optimizers.make(name, 0.1, 0.05)
    jp, p = jnp.asarray(p0), torch.from_numpy(p0.copy())
    js, s = jopt.init(jp), opt.init(p)
    for g in grads:
        ju, js = jopt.update(jnp.asarray(g), js, jp)
        jp = joptim.apply_updates(jp, ju)
        u, s = opt.update(torch.from_numpy(g), s, p)
        optimizers.apply_updates(p, u)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", ["centralvr", "svrg", "saga"])
def test_vr_steps_match_reference(mode, fused):
    """Two epochs of M=3 steps of ``correct`` + SGD (or the fused
    ``apply``) on one flat buffer, against the reference's on a
    one-leaf tree."""
    M, lr = 3, 0.05
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal(40).astype(np.float32)
    gs = rng.standard_normal((2 * M, 2, 40)).astype(np.float32)
    jp = {"w": jnp.asarray(x0)}
    jst = jvr.init_vr(mode, jp, M)
    p = torch.from_numpy(x0.copy())
    st = vr_wrapper.init_vr(mode, p, M)
    for k in range(2 * M):
        g, gs_ = gs[k]
        jg, jgs = {"w": jnp.asarray(g)}, {"w": jnp.asarray(gs_)}
        tg, tgs = torch.from_numpy(g.copy()), torch.from_numpy(gs_.copy())
        if fused:
            jp, jst = jvr.apply(mode, jst, jg, M, lr=lr, g_snap=jgs,
                                params=jp, idx=jnp.int32(k % M),
                                interpret=True)
            vr_wrapper.apply(mode, st, tg, M, lr=lr, g_snap=tgs, params=p,
                             idx=k % M)
        else:
            jv, jst = jvr.correct(mode, jst, jg, M, g_snap=jgs, params=jp,
                                  idx=jnp.int32(k % M))
            jp = joptim.apply_updates(jp, {"w": -lr * jv["w"]})
            v, _ = vr_wrapper.correct(mode, st, tg, M, g_snap=tgs, params=p,
                                      idx=k % M)
            optimizers.apply_updates(p, -lr * v)
    tol = dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp["w"]), **tol)
    np.testing.assert_allclose(st.gbar.numpy(), np.asarray(jst.gbar["w"]),
                               **tol)
    np.testing.assert_allclose(st.gtilde.numpy(),
                               np.asarray(jst.gtilde["w"]), **tol)
    for i, row in enumerate(st.table):
        np.testing.assert_allclose(row.numpy(),
                                   np.asarray(jst.table["w"][i]), **tol)
    assert st.idx == int(jst.idx)
    assert vr_wrapper.grads_per_step(mode) == jvr.grads_per_step(mode)
    assert (vr_wrapper.storage_multiplier(mode, M)
            == jvr.storage_multiplier(mode, M))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", ["centralvr", "svrg", "saga"])
def test_bf16_master_vr_steps_match_reference_exactly(mode, fused):
    """bfloat16 VR state with float32 gradients, as the trainer has them
    with param_dtype="bfloat16": two epochs of M=3 steps of ``correct`` +
    SGD (or the fused ``apply``) give the reference's params, table rows,
    gbar and gtilde bit for bit — the rows take a rounded copy of g and
    stay bfloat16, g keeps its float32 buffer, and every rounding point
    (the corrections in bfloat16, the kernel in float32 with the results
    rounded, -lr rounded to bfloat16 as JAX's weak type) is the
    reference's."""
    M, lr = 3, 0.05
    bf = jnp.bfloat16
    rng = np.random.default_rng(2)
    x0 = np.asarray(jnp.asarray(rng.standard_normal(40), bf),
                    dtype=np.float32)
    gs = rng.standard_normal((2 * M, 2, 40)).astype(np.float32)
    jp = {"w": jnp.asarray(x0, bf)}
    jst = jvr.init_vr(mode, jp, M)
    p = torch.from_numpy(x0.copy()).to(torch.bfloat16)
    st = vr_wrapper.init_vr(mode, p, M)
    for k in range(2 * M):
        g, gs_ = gs[k]
        jg, jgs = {"w": jnp.asarray(g)}, {"w": jnp.asarray(gs_)}
        tg, tgs = torch.from_numpy(g.copy()), torch.from_numpy(gs_.copy())
        if fused:
            jp, jst = jvr.apply(mode, jst, jg, M, lr=lr, g_snap=jgs,
                                params=jp, idx=jnp.int32(k % M),
                                interpret=True)
            vr_wrapper.apply(mode, st, tg, M, lr=lr, g_snap=tgs, params=p,
                             idx=k % M)
        else:
            jv, jst = jvr.correct(mode, jst, jg, M, g_snap=jgs, params=jp,
                                  idx=jnp.int32(k % M))
            ju, _ = joptim.sgd(lr).update(jv, ())
            jp = joptim.apply_updates(jp, ju)
            v, _ = vr_wrapper.correct(mode, st, tg, M, g_snap=tgs, params=p,
                                      idx=k % M)
            u, _ = optimizers.sgd(lr).update(v, ())
            optimizers.apply_updates(p, u)
        assert tg.dtype == torch.float32
        assert all(row.dtype == torch.bfloat16 for row in st.table)

    def same(t, a):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, dtype=np.float32))
    same(p, jp["w"])
    same(st.gbar, jst.gbar["w"])
    same(st.gtilde, jst.gtilde["w"])
    for i, row in enumerate(st.table):
        same(row, jst.table["w"][i])


# ---------------------------------------------------------------------------
# the epoch runner and the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("vr", ["centralvr", "svrg", "saga"])
def test_epoch_runner_matches_reference(vr, W, fused):
    """Two epochs (four steps, svrg's first epoch being a no-op) on the
    reference's params and ``epoch_tokens`` block, against the
    reference's unfused vmap runner; with fused=True the K1/K2/K3 plain
    versions run on these CPU tensors and launch nothing."""
    _, cfg = cfgs()
    p0, toks, want_losses, want_params = reference_run(vr, W, False)
    before = (vr_kernel.launches, rms_kernel.launches, fa_kernel.launches)
    state, losses, meta = port_run(vr, W, fused, p0, toks)
    assert (vr_kernel.launches, rms_kernel.launches,
            fa_kernel.launches) == before
    assert meta["fused"] is fused and meta["accum"] == 2 // 1
    np.testing.assert_allclose(losses, want_losses, **LM_TOL)
    for w in range(W):
        assert_trees_close(state.param_tree(w),
                           convert.lm_params_from_jax(want_params[w], cfg),
                           **LM_TOL)
    if W > 1:       # epoch boundary: the workers hold the central average
        torch.testing.assert_close(state.params[0], state.params[1],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("vr", ["centralvr", "svrg", "saga"])
def test_bf16_master_epoch_runner_matches_reference(vr, W, fused):
    """param_dtype="bfloat16" (the reference's optimized profile) with
    float32 compute, three epochs, against the reference's runner.

    The gradient accumulator stays float32 and the table rows bfloat16
    through every step (the step-level rounding is held bit for bit in
    ``test_bf16_master_vr_steps_match_reference_exactly``). The first
    loss, on the same params, is held to LM_TOL. After an update the two
    runs cannot stay within LM_TOL: the float32 gradients differ by
    ~1e-6 relative (summation order), and wherever x - lr*v lies that
    close to a rounding boundary of bfloat16, the two params round to
    neighbouring bfloat16 values, one ulp (2**-8 relative) apart, and
    each such flip moves the later gradients. So the later losses are
    held to 2**-9 relative (half a bf16 ulp), and the final params to 2%
    of the run's update in norm."""
    _, cfg = cfgs(param_dtype="bfloat16")
    p0, toks, want_losses, want_params = reference_run(
        vr, W, fused, param_dtype="bfloat16", epochs=3)

    def dtypes(state):
        assert state.params.dtype == torch.bfloat16
        assert state.grad.dtype == torch.float32
        if state.grad_snap is not None:
            assert state.grad_snap.dtype == torch.float32
        vrs = state.vr_state
        assert all(t.dtype == torch.bfloat16
                   for t in vrs.table + [vrs.gbar, vrs.gtilde])
    state, losses, _ = port_run(vr, W, fused, p0, toks, epochs=3,
                                param_dtype="bfloat16", after_epoch=dtypes)
    np.testing.assert_allclose(losses[0], want_losses[0], **LM_TOL)
    np.testing.assert_allclose(losses, want_losses, rtol=2.0 ** -9)
    layout = state.layout
    start = layout.load_(torch.empty(layout.n),
                         convert.lm_params_from_jax(p0, cfg))
    for w in range(W):
        want = layout.load_(torch.empty(layout.n),
                            convert.lm_params_from_jax(want_params[w], cfg))
        diff = (state.params[w].float() - want).norm()
        assert diff <= 0.02 * (want - start).norm()


def test_fused_step_calls_each_kernel_as_the_chip_run_counts(monkeypatch):
    """Per step with fused=True and remat="block" (L layers, A
    microbatches): K2 (2L + 1 forward + 2L recompute) * A times, K3
    (L + L) * A, K1 once — the launch counts chip_smoke.py holds the card
    to. Counted here at the wrappers, which run their plain versions."""
    calls = {"rmsnorm": 0, "flash_attention": 0, "vr_update": 0}

    def counting(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapper)
    counting(rms_kernel, "rmsnorm")
    counting(fa_kernel, "flash_attention")
    counting(vr_kernel, "vr_update")
    _, cfg = cfgs()
    tcfg = TrainConfig(**train_kw("centralvr", 1))
    run, meta = tstep.make_epoch_runner(cfg, tcfg, 1, fused=True,
                                        device="cpu")
    state, _ = run(tstep.init_train_state(cfg, tcfg, 1, device="cpu"))
    L, A, steps = cfg.num_layers, meta["accum"], 2
    assert calls == {"rmsnorm": (4 * L + 1) * A * steps,
                     "flash_attention": 2 * L * A * steps,
                     "vr_update": steps}


def test_run_training_matches_reference():
    jcfg, cfg = cfgs()
    kw = dict(train_kw("centralvr", 2), global_batch=8, microbatch=2)
    jres = jloop.run_training(jcfg, JTrainConfig(**kw), epochs=2, workers=2,
                              log_fn=lambda s: None)
    meta_acc, mb = jstep.batch_geometry(JTrainConfig(**kw), 2)
    toks = jsynthetic.epoch_tokens(jcfg, 0, workers=2, steps=2,
                                   accum=meta_acc, microbatch=mb, seq=16,
                                   table_size=2)
    ev = jsynthetic.eval_batch(jcfg, 0, batch=mb, seq=16)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    logs = []
    res = loop.run_training(
        cfg, TrainConfig(**kw), epochs=2, workers=2, device="cpu",
        params=convert.lm_params_from_jax(params, cfg),
        tokens=convert.tokens_from_jax(toks),
        eval_tokens=convert.tokens_from_jax(ev), log_fn=logs.append)
    np.testing.assert_allclose(res.losses, jres.losses, **LM_TOL)
    np.testing.assert_allclose(res.final_eval_loss, jres.final_eval_loss,
                               **LM_TOL)
    assert (res.steps, res.epochs) == (jres.steps, jres.epochs) == (4, 2)
    assert len(logs) == 2 and "loss" in logs[-1]


def test_run_training_on_its_own_data_learns():
    _, cfg = cfgs()
    tcfg = TrainConfig(**dict(train_kw("centralvr", 1), seq_len=32))
    res = loop.run_training(cfg, tcfg, steps=8, device="cpu",
                            log_fn=lambda s: None)
    again = loop.run_training(cfg, tcfg, steps=8, device="cpu",
                              log_fn=lambda s: None)
    assert res.losses == again.losses and len(res.losses) == 8
    assert np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]
    assert np.isfinite(res.final_eval_loss)
    with pytest.raises(ValueError, match="multiple of the communication"):
        loop.run_training(cfg, tcfg, steps=3, device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        loop.run_training(cfg, tcfg, steps=2, device="cpu",
                          checkpoint_path="ckpt")


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(global_batch=6, microbatch=2),
                                dict(global_batch=5, microbatch=0)])
def test_batch_geometry_refuses_like_the_reference(kw):
    with pytest.raises(ValueError) as want:
        jstep.batch_geometry(JTrainConfig(**kw), 2)
    with pytest.raises(ValueError) as got:
        tstep.batch_geometry(TrainConfig(**kw), 2)
    assert str(got.value) == str(want.value)
    assert tstep.batch_geometry(TrainConfig(global_batch=8, microbatch=2),
                                2) == (2, 2)


def test_fused_true_with_adam_refuses_like_the_reference():
    jcfg, cfg = cfgs()
    kw = dict(train_kw("centralvr", 1), optimizer="adam")
    with pytest.raises(ValueError, match="plain SGD") as want:
        jstep.make_epoch_runner(jcfg, JTrainConfig(**kw), 1, fused=True)
    with pytest.raises(ValueError, match="plain SGD") as got:
        tstep.make_epoch_runner(cfg, TrainConfig(**kw), 1, fused=True,
                                device="cpu")
    assert str(got.value) == str(want.value)
    # "auto" fuses only on a Hopper card: here it runs unfused, with adam
    run, meta = tstep.make_epoch_runner(cfg, TrainConfig(**kw), 1,
                                        fused="auto", device="cpu")
    state = tstep.init_train_state(cfg, TrainConfig(**kw), 1, device="cpu")
    state, losses = run(state)
    assert meta["fused"] is False and torch.isfinite(losses).all()
    with pytest.raises(ValueError, match="epoch boundary"):
        state.step = 1
        run(state)


def test_backends_and_token_block_are_checked():
    _, cfg = cfgs()
    tcfg = TrainConfig(**train_kw("centralvr", 1))
    with pytest.raises(RuntimeError, match="spawn_workers.*torchrun"):
        tstep.make_epoch_runner(cfg, tcfg, 1, backend="spmd", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tstep.make_epoch_runner(cfg, tcfg, 1, backend="pmap", device="cpu")
    with pytest.raises(ValueError, match="tokens has shape"):
        tstep.make_epoch_runner(cfg, tcfg, 1, device="cpu",
                                tokens=torch.zeros(1, 2, 2, 1, 8))


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = cfgs()
    tcfg = TrainConfig(**train_kw("centralvr", 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.make_epoch_runner(cfg, tcfg, 1, fused=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.init_train_state(cfg, tcfg, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.run_training(cfg, tcfg, epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "qwen2-7b", "--reduced", "--steps",
                           "2", "--vr-table-size", "2"])


def test_launcher_runs_on_the_cpu_and_refuses_unported_parts(capsys):
    base = ["--arch", "qwen2-7b", "--reduced", "--steps", "4",
            "--vr-table-size", "2", "--num-workers", "2", "--seq-len", "16",
            "--global-batch", "4", "--microbatch", "1", "--optimizer", "sgd",
            "--device", "cpu"]
    launch_train.main(base)
    assert "done: 4 steps" in capsys.readouterr().out
    for extra, item in ((["--runtime", "host"], "item 13"),
                        (["--mesh", "production"], "item 13")):
        with pytest.raises(SystemExit, match=item):
            launch_train.main(base + extra)


def test_kernel_ctx_scope_restores_the_switch():
    assert not kernel_ctx.active()
    with kernel_ctx.scope(True):
        assert kernel_ctx.active()
        with kernel_ctx.scope(False):
            assert not kernel_ctx.active()
        assert kernel_ctx.active()
    assert not kernel_ctx.active()


def test_worker_average_and_eval_params():
    buf = torch.tensor([[1.0, 2.0], [3.0, 6.0]])
    assert torch.equal(tstep.eval_params(buf, 2), torch.tensor([2.0, 4.0]))
    assert torch.equal(tstep.eval_params(buf, 1), buf[0])
    tstep.worker_average(buf)
    assert torch.equal(buf, torch.tensor([[2.0, 4.0], [2.0, 4.0]]))


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_fused_lm_step_loads_neither_jax_nor_the_reference():
    """In a fresh process: import the LM modules and run one fused epoch
    on the CPU (the kernels' plain versions and the modules they import
    lazily), then check that neither jax nor ``repro`` was loaded."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "from repro_torch.config import TrainConfig, get_arch\n"
        "from repro_torch.launch import train as launch_train\n"
        "from repro_torch.train import loop, step\n"
        "cfg = get_arch('qwen2-7b').reduced()\n"
        "tcfg = TrainConfig(seq_len=16, global_batch=2, microbatch=1, "
        "optimizer='sgd', learning_rate=0.1, vr='centralvr', "
        "vr_table_size=2)\n"
        "run, _ = step.make_epoch_runner(cfg, tcfg, 1, fused=True, "
        "device='cpu')\n"
        "run(step.init_train_state(cfg, tcfg, 1, device='cpu'))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(sorted(m for m in sys.modules if m.startswith("
        "'repro_torch.kernels.')))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    for name in ("rmsnorm.kernel", "flash_attention.kernel",
                 "vr_update.kernel"):
        assert f"repro_torch.kernels.{name}" in r.stdout


def test_port_and_chip_smoke_import_neither_jax_nor_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, (f, bad)


def test_flash_kernel_takes_every_head_size_and_float32():
    """K3 takes float32 as well as bfloat16 and every head size the repo's
    configs use (recurrentgemma-2b has 256); the fused trainer checks the
    model's shapes when it is built, before any step."""
    import repro.configs  # noqa: F401  (registers the reference's archs)
    from repro.config import list_archs as jlist_archs
    for name in jlist_archs():
        hd = jget_arch(name).head_dim
        for dtype in (torch.bfloat16, torch.float32):
            fa_kernel.check_supported(hd, dtype)
    src = fa_kernel.SOURCE.read_text()
    assert "case 256:" in src and "launch_hd<float>" in src
    with pytest.raises(ValueError, match="head size 96"):
        fa_kernel.check_supported(96, torch.bfloat16)
    with pytest.raises(TypeError, match="float16"):
        fa_kernel.check_supported(128, torch.float16)
    _, cfg = cfgs()
    tstep._check_kernel_shapes(cfg)
    with pytest.raises(ValueError, match="head size 16"):
        tstep._check_kernel_shapes(dataclasses.replace(cfg, head_dim=16))


@pytest.mark.parametrize("kernel,name", [
    (rms_kernel, "rmsnorm/kernel.py"), (fa_kernel,
                                        "flash_attention/kernel.py"),
    (ssd_kernel, "ssd_scan/kernel.py")])
def test_kernel_sources_name_their_tpu_kernel_and_target(kernel, name):
    from repro_torch.kernels import build
    src = kernel.SOURCE.read_text()
    assert f"src/repro/kernels/{name}" in src
    assert "compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
    assert 'extern "C"' in src and "torch/extension.h" not in src
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()
