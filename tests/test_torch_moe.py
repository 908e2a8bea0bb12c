"""The MoE FFN of the PyTorch port (``repro_torch.models.moe``) against the
JAX reference's ``repro.models.moe``: the output, the load-balance loss
and the gradients of the input and of every leaf, for both MoE archs of
the zoo, at capacity factors that drop tokens and that drop none; the
routing's tie rule; the bfloat16 path's router promotion.

Everything runs on the CPU in float32 with the reference's params (drawn
by ``init_moe``) and inputs made from a seed with numpy. The reference
reaches no Pallas kernel here, and the port no kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch
from repro.models import moe as jmoe
from repro_torch.config import get_arch
from repro_torch.models import model, moe

from torch_lm_common import LM_TOL, assert_close

torch.set_num_threads(1)

MOE_ARCHS = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b")


def _cfgs(arch):
    kw = dict(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jget_arch(arch).reduced(), **kw),
            dataclasses.replace(get_arch(arch).reduced(), **kw))


def _setup(arch, T=64, seed=0):
    """The reference's params, an input (2, T/2, d) and a cotangent for
    y, each as (jax, torch)."""
    jcfg, cfg = _cfgs(arch)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    p = model.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T // 2, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    return jcfg, cfg, jp, p, x, ct


def _routing(p, cfg, x, capacity_factor):
    """(largest expert load, capacity) of the port's routing of x."""
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(torch.from_numpy(x).reshape(T, -1)
                          @ p["router"], -1)
    _, top = moe._top_k(probs, cfg.num_experts_per_tok)
    load = torch.bincount(top.reshape(-1), minlength=cfg.num_experts)
    cf = capacity_factor or cfg.moe_capacity_factor
    cap = max(int(cf * T * cfg.num_experts_per_tok / cfg.num_experts), 8)
    return int(load.max()), cap


def _dense_moe(p, cfg, x):
    """Every token through its top-K experts, no capacity: the dispatch's
    answer when nothing is dropped (the shared expert left out)."""
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt @ p["router"], -1)
    w, e = moe._top_k(probs, cfg.num_experts_per_tok)
    w = w / w.sum(-1, keepdim=True)
    h = (torch.nn.functional.silu(torch.einsum("td,edf->tef", xt, p["wg"]))
         * torch.einsum("td,edf->tef", xt, p["wu"]))
    y_all = torch.einsum("tef,efd->ted", h, p["wd"])
    picked = torch.gather(y_all, 1, e[..., None].expand(-1, -1, xt.shape[1]))
    return (picked * w[..., None]).sum(1).reshape(x.shape)


@pytest.mark.parametrize("cf", [0.25, 1.25, "E"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_reference_with_gradients(arch, cf):
    """y, aux, and the gradients of x and of every leaf (router, experts,
    shared expert and gate) of sum(y * ct) + 3 aux, against the
    reference at LM_TOL (``assert_close``). At capacity factor 0.25
    tokens are dropped, at E none."""
    jcfg, cfg, jp, p, x, ct = _setup(arch, T=128)
    cf = float(cfg.num_experts) if cf == "E" else cf
    load, cap = _routing(p, cfg, x, cf)
    if cf == 0.25:
        assert load > cap              # some (token, k) pairs overflow
    if cf == cfg.num_experts:
        assert load <= cap

    def jloss(jp, jx):
        y, aux = jmoe.apply_moe(jp, jcfg, jx, capacity_factor=cf)
        return jnp.sum(y * ct) + 3.0 * aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    leaves = model.tree_map(lambda t: t.clone().requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply_moe(leaves, cfg, tx, capacity_factor=cf)
    (torch.sum(y * torch.from_numpy(ct)) + 3.0 * aux).backward()

    assert aux.dtype == torch.float32 and aux.shape == ()
    assert_close(y.detach().numpy(), jy)
    np.testing.assert_allclose(aux.item(), float(jaux), **LM_TOL)
    assert_close(tx.grad.numpy(), jgx)
    model.tree_zip(lambda t, g: assert_close(t.grad.numpy(), g), leaves,
                   jgp)
    if "shared" not in p:
        dense = _dense_moe(p, cfg, torch.from_numpy(x))
        if cf == cfg.num_experts:
            np.testing.assert_allclose(y.detach().numpy(), dense.numpy(),
                                       **LM_TOL)
        if cf == 0.25:
            assert not np.allclose(y.detach().numpy(), dense.numpy(),
                                   **LM_TOL)


def test_top_k_breaks_ties_as_the_reference():
    """A uniform router: every probability ties, and the experts taken
    are the lowest indices, as ``jax.lax.top_k`` takes them; y and aux
    equal the reference's."""
    jcfg, cfg, jp, p, x, _ = _setup("qwen3-moe-30b-a3b", T=64, seed=2)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    probs = torch.full((5, cfg.num_experts), 1.0 / cfg.num_experts)
    vals, idx = moe._top_k(probs, cfg.num_experts_per_tok)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()),
                                cfg.num_experts_per_tok)
    assert idx.tolist() == np.asarray(jidx).tolist()
    jy, jaux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x))
    y, aux = moe.apply_moe(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LM_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **LM_TOL)
    # Switch normalisation: a uniform router's aux is the coefficient
    assert abs(aux.item() - cfg.router_aux_coef) < 0.2 * cfg.router_aux_coef


def test_bf16_params_promote_the_router_to_float32():
    """With every leaf cast to bfloat16 (as the block casts params to the
    compute dtype), the router logits are computed in float32 from the
    bf16 router, as the reference's ``xt.astype(f32) @ router``: the
    routing and the aux loss match the reference's, y to bf16
    precision."""
    jcfg, cfg, jp, p, x, _ = _setup("qwen2-moe-a2.7b", T=64, seed=3)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    p = model.tree_map(lambda t: t.to(torch.bfloat16), p)
    xb = jnp.asarray(x, jnp.bfloat16)
    jy, jaux = jmoe.apply_moe(jp, jcfg, xb)
    y, aux = moe.apply_moe(p, cfg, torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    want = np.asarray(jy, dtype=np.float32)
    np.testing.assert_allclose(y.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_init_moe_draws_the_reference_layout():
    """Shapes, order and scales of the port's own init."""
    _, cfg = _cfgs("qwen2-moe-a2.7b")
    jcfg, _ = _cfgs("qwen2-moe-a2.7b")
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(0), jnp.float32)
    layout = model.ParamLayout(cfg)
    p = layout.views(layout.init_(torch.empty(layout.n),
                                  torch.Generator().manual_seed(0)))
    ffn = p["layers"][0]["ffn"]
    model.tree_zip(lambda t, a: (t.shape == a.shape) or pytest.fail(
        f"{tuple(t.shape)} != {a.shape}"), ffn, jp)
    assert list(ffn) == list(jp) == ["router", "wg", "wu", "wd", "shared",
                                     "shared_gate"]
    d = cfg.d_model
    assert abs(float(ffn["wg"].std()) * d ** 0.5 - 1.0) < 0.05
    assert abs(float(ffn["wd"].std()) * cfg.moe_d_ff ** 0.5 - 1.0) < 0.05
