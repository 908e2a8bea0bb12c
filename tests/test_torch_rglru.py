"""The RG-LRU recurrent block of the PyTorch port
(``repro_torch.models.rglru``) against the JAX reference's
``repro.models.rglru``: the gates, the prefix scan (against the
reference's ``associative_scan`` and against a sequential loop written
here), the whole Griffin block with its gradients, the decay bound, the
init, and a long sequence that a log-space cumulative sum would overflow.

Everything runs on the CPU in float32 with the reference's params (drawn
by ``init_rglru``) and inputs made from a seed with numpy. The reference
reaches no Pallas kernel here, and the port no kernel.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.config import get_arch as jget_arch
from repro.models import rglru as jrglru
from repro_torch.config import get_arch
from repro_torch.models import model, rglru

from torch_lm_common import LM_TOL, assert_close

torch.set_num_threads(1)

ARCH = "recurrentgemma-2b"


def _cfgs():
    kw = dict(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jget_arch(ARCH).reduced(), **kw),
            dataclasses.replace(get_arch(ARCH).reduced(), **kw))


def _params(seed=0):
    jcfg, cfg = _cfgs()
    jp = jrglru.init_rglru(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, cfg, jp, model.tree_map(
        lambda a: torch.from_numpy(np.array(a)), jp)


def _loop(p, x):
    """h_t = a_t h_{t-1} + b_t, one step at a time, from the port's
    gates."""
    log_a, b = rglru._gates(p, x)
    a = torch.exp(log_a)
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, 1)


@pytest.mark.parametrize("S", [1, 7, 16, 33])
def test_rglru_scan_matches_reference_and_a_loop(S):
    """S a power of two and not, and S = 1 (no pass)."""
    _, cfg, jp, p = _params()
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    jh, jlast = jrglru.rglru_scan(jp, jnp.asarray(x))
    h, last = rglru.rglru_scan(p, torch.from_numpy(x))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **LM_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **LM_TOL)
    np.testing.assert_allclose(h.numpy(), _loop(p, torch.from_numpy(x))
                               .numpy(), **LM_TOL)
    jla, jb = jrglru._gates(jp, jnp.asarray(x))
    la, b = rglru._gates(p, torch.from_numpy(x))
    assert la.dtype == b.dtype == torch.float32
    np.testing.assert_allclose(la.numpy(), np.asarray(jla), **LM_TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), **LM_TOL)


@pytest.mark.parametrize("S", [1, 7, 16, 33])
def test_apply_rec_train_matches_reference_with_gradients(S):
    """The Griffin block (conv, scan, GeLU branch, out projection): the
    output and the gradients of u and of every leaf of sum(y * ct), at
    LM_TOL (``assert_close``)."""
    jcfg, cfg, jp, p = _params(seed=1)
    rng = np.random.default_rng(10 + S)
    u = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(u.shape).astype(np.float32)

    def jloss(jp, ju):
        y = jrglru.apply_rec_train(jp, jcfg, ju)
        return jnp.sum(y * ct), y
    (_, jy), (jgp, jgu) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(u))
    leaves = model.tree_map(lambda t: t.clone().requires_grad_(), p)
    tu = torch.from_numpy(u).requires_grad_()
    y = rglru.apply_rec_train(leaves, cfg, tu)
    torch.sum(y * torch.from_numpy(ct)).backward()
    assert_close(y.detach().numpy(), jy)
    assert_close(tu.grad.numpy(), jgu)
    model.tree_zip(lambda t, g: assert_close(t.grad.numpy(), g), leaves,
                   jgp)


def test_rglru_decay_bounded():
    """The reference's check on the port: |a_t| < 1 always (the
    recurrence is contractive), at the reference's params and inputs."""
    cfg = JModelConfig(name="t", family="hybrid", num_layers=1, d_model=16,
                       num_heads=2, num_kv_heads=1, head_dim=8, d_ff=32,
                       vocab_size=64, rglru_heads=2, block_pattern=("rec",))
    jp = jrglru.init_rglru(cfg, jax.random.PRNGKey(0), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 8, 16)) * 10.0
    p = model.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    log_a, _ = rglru._gates(p, torch.from_numpy(
        np.asarray(x, dtype=np.float32)))
    assert bool((log_a < 0.0).all())


def test_long_sequence_stays_finite_and_matches_the_loop():
    """S 2048: the scan of (a, h) pairs stays finite and equals the loop,
    where the cumulative sum of log a falls below -88, past which
    exp(-sum log a) overflows float32 (a log-space scan fails here)."""
    _, cfg, _, p = _params(seed=2)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 2048, cfg.d_model)).astype(np.float32))
    h, _ = rglru.rglru_scan(p, x)
    assert bool(torch.isfinite(h).all())
    np.testing.assert_allclose(h.numpy(), _loop(p, x).numpy(), rtol=1e-4,
                               atol=1e-5)
    log_a, _ = rglru._gates(p, x)
    assert float(log_a.cumsum(1).min()) < -88.0


def test_init_draws_the_reference_layout_and_ranges():
    """The port's own init: the reference's leaves, shapes and order;
    lambda such that a^c = exp(-c softplus(lambda)) lies in
    [0.9, 0.999]; conv_w with std 0.1, the gates with std 1/sqrt(hb)."""
    jcfg, cfg, jp, _ = _params()
    layout = model.ParamLayout(cfg)
    tree = layout.views(layout.init_(torch.empty(layout.n),
                                     torch.Generator().manual_seed(0)))
    mixer = tree["layers"][0]["mixer"]
    assert list(mixer) == list(jp)
    model.tree_zip(lambda t, a: (t.shape == a.shape) or pytest.fail(
        f"{tuple(t.shape)} != {a.shape}"), mixer, jp)
    a_c = torch.exp(-rglru.C_RGLRU * torch.nn.functional.softplus(
        mixer["lambda"]))
    assert float(a_c.min()) >= 0.9 - 1e-6
    assert float(a_c.max()) <= 0.999 + 1e-6
    assert float(a_c.max() - a_c.min()) > 0.05
    hb = cfg.d_model // cfg.rglru_heads
    assert abs(float(mixer["conv_w"].std()) - 0.1) < 0.01
    assert abs(float(mixer["wa"].std()) * math.sqrt(hb) - 1.0) < 0.05
    assert torch.equal(mixer["conv_b"], torch.zeros(cfg.d_model))
