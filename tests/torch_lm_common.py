"""Shared set-up of the LM agreement tests of the PyTorch port
(``test_torch_lm.py``, ``test_torch_lm_kernels.py``, ``test_torch_ssm.py``
and the ``test_torch_archs*.py`` files): a reduced config (Qwen2-7B by
default, or any arch of the zoo) computing in float32 for both packages,
epochs of the reference's epoch runner (cached per process), the same run
in the port from the reference's params and tokens, a leafwise
comparison, and the loss and gradients of one batch in both."""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_arch as jget_arch
from repro.data import synthetic as jsynthetic
from repro.models import model as jmodel
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.config import TrainConfig, get_arch
from repro_torch.models import model
from repro_torch.train import step as tstep

# the archs beyond Qwen2-7B and Mamba2-130M (tests/test_torch_archs*.py)
NEW_ARCHS = ("internvl2-26b", "qwen3-14b", "musicgen-large",
             "qwen3-moe-30b-a3b", "starcoder2-15b", "recurrentgemma-2b",
             "qwen2-moe-a2.7b", "qwen1.5-110b")

# float32 LM forward: kernel block order vs XLA fusion order
# (tests/test_fused_agreement.py)
LM_TOL = dict(rtol=3e-5, atol=1e-6)


def cfgs(dtype="float32", arch="qwen2-7b", param_dtype="float32"):
    """(reference cfg, port cfg): ``arch``.reduced() computing in dtype,
    with masters in param_dtype."""
    kw = dict(dtype=dtype, param_dtype=param_dtype)
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
    return jcfg, cfg


def train_kw(vr, W):
    return dict(seq_len=16, global_batch=2 * W, microbatch=1,
                optimizer="sgd", learning_rate=0.1, vr=vr, vr_table_size=2,
                local_epoch=1)


def assert_trees_close(port_tree, ref_tree, **tol):
    def check(a, b):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.float().numpy(), **tol)
    model.tree_zip(check, port_tree, ref_tree)


def assert_close(got, want):
    """LM_TOL for a module's output or gradient under a random cotangent,
    its absolute part taken relative to the largest magnitude of
    ``want`` where that is above 1: a gradient entry that is the sum of
    terms of size ~10 cancelling to ~1e-2 carries float32 rounding of
    the terms' size, whatever the order of summation."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=LM_TOL["rtol"],
                               atol=LM_TOL["atol"] * scale)


@functools.lru_cache(maxsize=None)
def reference_run(vr, W, fused, arch="qwen2-7b", param_dtype="float32",
                  epochs=2):
    """``epochs`` epochs of the reference's vmap epoch runner: (initial
    params of worker 0, token block, per-step losses, final params per
    worker)."""
    jcfg, _ = cfgs(arch=arch, param_dtype=param_dtype)
    tcfg = JTrainConfig(**train_kw(vr, W))
    run, meta = jstep.make_epoch_runner(jcfg, tcfg, W, backend="vmap",
                                        fused=fused)
    state = jstep.init_train_state(jcfg, tcfg, jax.random.PRNGKey(0), W)
    p0 = jax.tree_util.tree_map(lambda x: np.asarray(x[0] if W > 1 else x),
                                state.params)
    toks = jsynthetic.epoch_tokens(
        jcfg, tcfg.seed, workers=W, steps=2, accum=meta["accum"],
        microbatch=meta["microbatch"], seq=tcfg.seq_len, table_size=2)
    losses = []
    for _ in range(epochs):
        state, ls = run(state)
        losses.append(np.asarray(ls, dtype=float))
    final = [jax.tree_util.tree_map(
        lambda x, w=w: np.asarray(x[w] if W > 1 else x), state.params)
        for w in range(W)]
    return p0, np.asarray(toks), np.concatenate(losses), final


def port_run(vr, W, fused, p0, toks, epochs=2, arch="qwen2-7b",
             param_dtype="float32", after_epoch=None):
    """The same run in the port on the CPU: (state, losses, meta);
    ``after_epoch(state)`` is called after every epoch."""
    _, cfg = cfgs(arch=arch, param_dtype=param_dtype)
    tcfg = TrainConfig(**train_kw(vr, W))
    run, meta = tstep.make_epoch_runner(cfg, tcfg, W, fused=fused,
                                        device="cpu",
                                        tokens=convert.tokens_from_jax(toks))
    state = tstep.init_train_state(
        cfg, tcfg, W, params=convert.lm_params_from_jax(p0, cfg),
        device="cpu")
    losses = []
    for _ in range(epochs):
        state, ls = run(state)
        losses.append(ls.numpy())
        if after_epoch is not None:
            after_epoch(state)
    return state, np.concatenate(losses), meta


def loss_and_grads(arch, remat, *, num_layers=None, seq=24):
    """The loss and its gradients of ``arch``.reduced() (``num_layers``
    layers if given) on a (2, seq) token batch, with the frontend stub's
    embeddings where the arch takes them: (port loss, reference loss,
    port grads, reference grads as a port tree)."""
    jcfg, cfg = cfgs(arch=arch)
    if num_layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=num_layers)
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, seq), 0,
                              jcfg.vocab_size)
    jbatch = {"tokens": toks}
    batch = {"tokens": convert.tokens_from_jax(toks)}
    fe = jsynthetic.frontend_embeds(jcfg, 0, 2)
    if fe is not None:
        fe = np.array(fe, dtype=np.float32)
        jbatch["frontend_embeds"] = fe
        batch["frontend_embeds"] = torch.from_numpy(fe)
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, jbatch, remat=remat))(params)
    tree = model.tree_map(lambda t: t.requires_grad_(),
                          convert.lm_params_from_jax(params, cfg))
    got = model.loss_fn(tree, cfg, batch, remat=remat)
    got.backward()
    # a leaf the loss does not reach (musicgen's frontend_proj: no
    # frontend tokens) has no gradient here, and a zero one there
    g_port = model.tree_map(
        lambda t: t.grad if t.grad is not None else torch.zeros_like(t),
        tree)
    return got.item(), float(loss), g_port, convert.lm_params_from_jax(
        grads, cfg)


def check_runner(arch, fused):
    """Two epochs of CentralVR at W = 2 of ``arch``.reduced() in the
    reference and in the port from its params and tokens: per-step
    losses and both workers' final params at LM_TOL."""
    _, cfg = cfgs(arch=arch)
    p0, toks, want_losses, want_params = reference_run(
        "centralvr", 2, fused, arch=arch)
    state, losses, meta = port_run("centralvr", 2, fused, p0, toks,
                                   arch=arch)
    assert meta["fused"] is fused
    np.testing.assert_allclose(losses, want_losses, **LM_TOL)
    for w in range(2):
        assert_trees_close(state.param_tree(w),
                           convert.lm_params_from_jax(want_params[w], cfg),
                           **LM_TOL)
