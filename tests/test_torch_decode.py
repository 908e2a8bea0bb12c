"""The port's lockstep decode (``models/model.py::decode_step`` over
``init_cache``, every block kind's decode half) against the reference's,
token by token from the reference's params, for every arch of the zoo at
its reduced size in float32; the reference's own decode-against-forward
oracles run on the port; the SSM and RG-LRU decode steps from one
non-zero cache in both packages. Tolerance ``LM_TOL``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.models import model, rglru, ssm
from repro_torch.train import step as tstep
from torch_lm_common import assert_close, cfgs

torch.set_num_threads(1)

STEPS = 4


def _cache_close(got, want):
    """The port's per-layer cache against the reference's, converted."""
    for g, w in zip(got, want):
        pairs = (zip(g.values(), w.values()) if isinstance(g, dict)
                 else zip(g, w))
        for a, b in pairs:
            assert_close(a.float().numpy(), b.float().numpy())


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decode_step_matches_the_reference(arch):
    """STEPS tokens through both packages' ``decode_step`` from the same
    params and a zero cache: logits and the cache after every step."""
    jcfg, cfg = cfgs(arch=arch)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_jax(jp, cfg)
    B, max_len = 2, 8
    jcache = jmodel.init_cache(jcfg, B, max_len)
    cache = model.init_cache(cfg, B, max_len, device="cpu")
    step = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, jcfg, t, c,
                                                           pos))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (STEPS, B, 1))
    for pos in range(STEPS):
        want, jcache = step(jp, jnp.asarray(toks[pos], jnp.int32), jcache,
                            pos)
        with torch.no_grad():
            got, cache = model.decode_step(
                params, cfg, torch.from_numpy(toks[pos]), cache, pos)
        assert got.shape == (B, cfg.vocab_size)
        assert_close(got.numpy(), np.asarray(want))
        _cache_close(cache, convert.decode_cache_from_jax(jcache, cfg))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-130m",
                                  "qwen3-moe-30b-a3b"])
def test_decode_step_from_a_nonzero_cache_matches_the_reference(arch):
    """Both packages' ``decode_step`` from one random cache
    (``convert.decode_cache_from_jax``) at positions 5 to 7, past
    recurrentgemma's reduced local window of 4 slots (the ring wraps)."""
    jcfg, cfg = cfgs(arch=arch)
    jcfg = dataclasses.replace(jcfg, local_window=min(jcfg.local_window, 4))
    cfg = dataclasses.replace(cfg, local_window=jcfg.local_window)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    params = convert.lm_params_from_jax(jp, cfg)
    B = 2
    rng = np.random.default_rng(7)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype)),
        jmodel.init_cache(jcfg, B, 8))
    cache = convert.decode_cache_from_jax(jcache, cfg)
    step = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, jcfg, t, c,
                                                           pos))
    for pos in range(5, 8):
        tok = rng.integers(0, cfg.vocab_size, (B, 1))
        want, jcache = step(jp, jnp.asarray(tok, jnp.int32), jcache, pos)
        with torch.no_grad():
            got, cache = model.decode_step(params, cfg,
                                           torch.from_numpy(tok), cache, pos)
        assert_close(got.numpy(), np.asarray(want))
        _cache_close(cache, convert.decode_cache_from_jax(jcache, cfg))


def _decode_against_forward(cfg, seed=0):
    params = model.init_params(cfg, torch.Generator().manual_seed(seed),
                               device="cpu")
    B, S = 2, 12
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        full, _ = model.forward(params, cfg, {"tokens": toks})
        cache = model.init_cache(cfg, B, S, device="cpu")
        outs = []
        for t in range(S):
            lg, cache = model.decode_step(params, cfg, toks[:, t:t + 1],
                                          cache, t)
            outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-130m",
                                  "recurrentgemma-2b", "musicgen-large"])
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the full forward's logits (float32,
    windowing off), the reference's oracle on the port."""
    _, cfg = cfgs(arch=arch)
    _decode_against_forward(dataclasses.replace(cfg, sliding_window=None))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"])
def test_moe_decode_matches_forward_without_dropping(arch):
    _, cfg = cfgs(arch=arch)
    _decode_against_forward(dataclasses.replace(cfg,
                                                moe_capacity_factor=8.0))


def test_serve_step_and_prefill_are_decode_and_the_last_logits():
    """``make_serve_step``: the decode step is ``model.decode_step``, the
    prefill the forward's last position."""
    _, cfg = cfgs()
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    serve_step, serve_prefill = tstep.make_serve_step(cfg)
    last = serve_prefill(params, toks)
    full, _ = model.forward(params, cfg, {"tokens": toks}, remat="none")
    assert torch.equal(last, full[:, -1].detach())
    cache = model.init_cache(cfg, 2, 6, device="cpu")
    for t in range(6):
        lg, cache = serve_step(params, toks[:, t:t + 1], cache, t)
    assert not lg.requires_grad
    np.testing.assert_allclose(lg.numpy(), last.numpy(), atol=2e-4,
                               rtol=2e-3)


def _mixer_params(jcfg, cfg, kind):
    """The first ``kind`` layer's mixer params of the reference's init, in
    both packages (float32 masters and compute: no cast)."""
    params = convert.lm_params_from_jax(
        jmodel.init_params(jcfg, jax.random.PRNGKey(3)), cfg)
    mixer = params["layers"][cfg.layer_kinds().index(kind)]["mixer"]
    return {k: jnp.asarray(v.numpy()) for k, v in mixer.items()}, mixer


@pytest.mark.parametrize("arch,kind", [("mamba2-130m", "ssm"),
                                       ("recurrentgemma-2b", "rec")])
def test_recurrent_decode_from_a_nonzero_cache(arch, kind):
    """``apply_ssm_decode`` / ``apply_rec_decode`` from one random cache
    (conv inputs and state), three steps: outputs and caches."""
    jcfg, cfg = cfgs(arch=arch)
    jp, p = _mixer_params(jcfg, cfg, kind)
    rng = np.random.default_rng(5)
    B = 3
    if kind == "ssm":
        jc = jssm.init_ssm_cache(jcfg, B, jnp.float32)
        apply_j, apply_p = jssm.apply_ssm_decode, ssm.apply_ssm_decode
    else:
        jc = jrglru.init_rec_cache(jcfg, B, jnp.float32)
        apply_j, apply_p = jrglru.apply_rec_decode, rglru.apply_rec_decode
    start = [rng.standard_normal(np.shape(a)).astype(np.float32) for a in jc]
    jc = type(jc)(*(jnp.asarray(a) for a in start))
    port_cls = ssm.SSMCache if kind == "ssm" else rglru.RecCache
    cache = port_cls(*(torch.from_numpy(a) for a in start))
    for _ in range(3):
        u = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jc = apply_j(jp, jcfg, jnp.asarray(u), jc)
        with torch.no_grad():
            got, cache = apply_p(p, cfg, torch.from_numpy(u), cache)
        assert_close(got.numpy(), np.asarray(want))
        for a, b in zip(cache, jc):
            assert_close(a.numpy(), np.asarray(b))


def test_param_count_actual_matches_the_reference():
    for arch in ASSIGNED_ARCHS:
        jcfg, cfg = cfgs(arch=arch)
        want = jmodel.param_count_actual(
            jmodel.init_params(jcfg, jax.random.PRNGKey(1)))
        params = model.init_params(cfg, torch.Generator().manual_seed(1),
                                   device="cpu")
        assert model.param_count_actual(params) == want, arch
