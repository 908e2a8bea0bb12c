"""Shared set-up of the LM agreement tests of the PyTorch port
(``test_torch_lm.py``, ``test_torch_lm_kernels.py``,
``test_torch_ssm.py``): a reduced config (Qwen2-7B by default, or
Mamba2-130M) computing in float32 for both packages, epochs of the
reference's epoch runner (cached per process), the same run in the port
from the reference's params and tokens, and a leafwise comparison."""
import dataclasses
import functools

import jax
import numpy as np

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_arch as jget_arch
from repro.data import synthetic as jsynthetic
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.config import TrainConfig, get_arch
from repro_torch.models import model
from repro_torch.train import step as tstep

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
