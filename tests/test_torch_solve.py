"""The PyTorch port's solver path against the JAX reference: Algorithm 1
(``centralvr``, permutation and uniform sampling) and Algorithm 2
(``centralvr_sync``), fused and unfused, with and without a prox; and
``RunSpec``'s validation for all eleven algorithms (the other nine run in
``tests/test_torch_baselines.py`` and ``tests/test_torch_distributed.py``).

Both packages get the same data (built by the reference, passed through
numpy) and the same visit orders (the reference's ``jax.random`` draws,
replayed by ``repro_torch.convert``). The reference's fused runs execute
its Pallas kernel in interpret mode; the port's fused runs go through its
kernel wrapper, which runs the kernel's plain version on CPU tensors.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.config import ConvexConfig as JConvexConfig
from repro.core import centralvr as jcentralvr
from repro.core import convex as jconvex
from repro.core import distributed as jdistributed
from repro_torch import convert
from repro_torch.config import ConvexConfig
from repro_torch.core import centralvr, distributed

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")

# the reference's own convex-trajectory tolerance in float64
# (tests/test_fused_agreement.py)
CONVEX_TOL = 1e-10
KEY = jax.random.PRNGKey(7)


def _close(have, want, tol=CONVEX_TOL):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=tol,
                               atol=tol)


def _single():
    prob = jconvex.make_logistic_data(jax.random.PRNGKey(2), 48, 8)
    return prob, jconvex.auto_eta(prob, 0.3)


def _sharded(p=2):
    cfg = JConvexConfig(problem="logistic", n=24, d=8, workers=p)
    sp = jdistributed.make_distributed(jax.random.PRNGKey(2), cfg)
    return sp, jconvex.auto_eta(sp.merged(), 0.3)


@pytest.mark.parametrize("prox", [None, "l1:0.01"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("sampling", ["permutation", "uniform"])
def test_centralvr_matches_reference(sampling, fused, prox):
    prob, eta = _single()
    kw = dict(eta=eta, rounds=3, sampling=sampling, fused=fused, prox=prox)
    want = repro.solve(repro.RunSpec("centralvr", **kw), prob, key=KEY)
    have = repro_torch.solve(
        repro_torch.RunSpec("centralvr", **kw),
        convert.to_problem(prob, device="cpu"), device="cpu",
        orders=convert.centralvr_orders(jax.random, KEY, prob.n, 3,
                                        sampling))
    _close(have.x, want.x)
    _close(have.rels, want.rels)
    _close(have.state.table, want.state.table)
    _close(have.state.gbar, want.state.gbar)
    np.testing.assert_array_equal(have.grad_evals, want.grad_evals)
    assert have.launches == {"vr_update": 0, "vr_epoch": 0, "lazy_epoch": 0}
    assert have.device == "cpu"


@pytest.mark.parametrize("prox", [None, "l1:0.01"])
@pytest.mark.parametrize("fused", [False, True])
def test_centralvr_sync_matches_reference(fused, prox):
    sp, eta = _sharded()
    kw = dict(p=2, eta=eta, rounds=3, fused=fused, prox=prox)
    want = repro.solve(repro.RunSpec("centralvr_sync", **kw), sp, key=KEY)
    have = repro_torch.solve(
        repro_torch.RunSpec("centralvr_sync", **kw),
        convert.to_problem(sp, device="cpu"), device="cpu",
        orders=convert.sync_orders(jax.random, KEY, 2, sp.ns, 3))
    _close(have.x, want.x)
    _close(have.rels, want.rels)
    _close(have.state.tables, want.state.tables)
    _close(have.state.gbar, want.state.gbar)
    assert have.comms["n_allreduce_per_round"] == 2
    assert have.comms["bytes_per_round"] == 2 * sp.d * 8


@pytest.mark.parametrize("fused", [False, True])
def test_epochs_continue_the_reference_state(fused):
    """Reference state in, one step of each driver on both sides: the
    Algorithm-1 epoch from the reference's init_state, the Algorithm-2
    round from its sync_init."""
    from repro.core import fused as jfused
    from repro_torch.core import fused as tfused

    prob, eta = _single()
    k1, k2 = jax.random.split(KEY)
    jstate = jcentralvr.init_state(prob, eta, k1)
    order = jax.random.permutation(k2, prob.n)
    want, _ = jcentralvr.epoch(prob, jstate, eta, order,
                               fused=jfused.make_params(fused, eta, prob.lam))
    have = centralvr.epoch(
        convert.to_problem(prob, device="cpu"),
        convert.to_vr_state(jstate, device="cpu"), eta,
        torch.from_numpy(np.array(order)),
        fused=tfused.make_params(fused, eta, float(prob.lam), "cpu"))
    for h, w in zip(have, want):
        _close(h, w)

    sp, eta = _sharded()
    jst = jdistributed.sync_init(sp, eta, k1)
    perms = np.stack([np.array(jax.random.permutation(k, sp.ns))
                      for k in jax.random.split(k2, sp.p)])
    want = jdistributed.sync_round(
        sp, jst, eta, k2, fused=jfused.make_params(fused, eta, sp.lam))
    have = distributed.sync_round(
        convert.to_problem(sp, device="cpu"),
        convert.to_sync_state(jst, device="cpu"), eta,
        torch.from_numpy(perms),
        fused=tfused.make_params(fused, eta, float(sp.lam), "cpu"))
    for h, w in zip(have, want):
        _close(h, w)


INVALID = [
    dict(algo="nope"),
    dict(algo="centralvr", p=2),
    dict(algo="centralvr", rounds=0),
    dict(algo="centralvr", eta=-1.0),
    dict(algo="centralvr", metric_every=0),
    dict(algo="centralvr", backend="tpu"),
    dict(algo="centralvr_sync", p=2, sampling="uniform"),
    dict(algo="centralvr_sync", p=2, speeds=(1.0, 1.0)),
    dict(algo="centralvr_sync", p=2, tau=3),
    dict(algo="centralvr_sync", p=2, fetch="stale"),
    dict(algo="centralvr", prox="bogus:1"),
    dict(algo="centralvr", prox="group_l2:0.1:4", fused=True),
    dict(algo="centralvr", fused="yes"),
    dict(algo="centralvr", snapshot="avg"),
    dict(algo="centralvr", decay=0.5),
    dict(algo="centralvr", sampling="sparse", fused=True),
    dict(algo="centralvr", sampling="sparse", prox="box"),
    dict(algo="sgd", fused=True),
    dict(algo="centralvr", topology="mesh"),
    dict(algo="centralvr", topology="process"),
    dict(algo="centralvr_sync", p=2, elastic=True),
]


@pytest.mark.parametrize("kw", INVALID, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_runspec_refuses_like_the_reference(kw):
    with pytest.raises((ValueError, NotImplementedError)) as want:
        repro.RunSpec(**kw)
    with pytest.raises(type(want.value)) as have:
        repro_torch.RunSpec(**kw)
    assert str(have.value) == str(want.value)


@pytest.mark.parametrize("kw,item", [
    (dict(algo="centralvr_async", p=2, elastic=True), "item 11"),
    (dict(algo="centralvr_sync", p=2, topology="process"), "item 11"),
])
def test_unported_parts_raise_naming_the_roadmap_item(kw, item):
    repro.RunSpec(**kw)            # valid in the reference
    with pytest.raises(NotImplementedError, match=item):
        repro_torch.RunSpec(**kw)


def _grid():
    """Every combination of the spec's axes over a few values each."""
    import itertools
    axes = dict(p=(1, 2), fused=(False, True, "auto"),
                prox=(None, "l1:0.01", "group_l2:0.01:2"),
                snapshot=(None, "last", "avg", "rand"),
                fetch=(None, "instant", "stale"), speeds=(None, (1.0, 2.0)),
                tau=(None, 3), decay=(0.0, 0.5))
    for values in itertools.product(*axes.values()):
        yield dict(zip(axes, values))


@pytest.mark.parametrize("backend", ["vmap", "spmd"])
@pytest.mark.parametrize("algo", list(repro_torch.REGISTRY))
def test_runspec_accepts_what_the_reference_accepts(algo, backend):
    """For every algorithm and both backends, every combination the
    reference's RunSpec accepts with topology="local" is accepted (and
    resolved alike: D-SAGA's fetch defaults to "stale" under spmd) by the
    port's; every one it refuses is refused with the same error."""
    accepted = 0
    for kw in _grid():
        kw["backend"] = backend
        try:
            want = repro.RunSpec(algo, **kw)
        except (ValueError, NotImplementedError) as e:
            with pytest.raises(type(e)) as have:
                repro_torch.RunSpec(algo, **kw)
            assert str(have.value) == str(e)
            continue
        have = repro_torch.RunSpec(algo, **kw)
        assert dataclasses.asdict(have) == dataclasses.asdict(want)
        accepted += 1
    # the single-device baselines have no spmd program at all
    runs_here = backend == "vmap" or repro_torch.REGISTRY[algo].caps.spmd_ok
    assert (accepted > 0) == runs_here


def test_solve_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ConvexConfig(problem="ridge", n=16, d=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.solve(repro_torch.RunSpec("centralvr", rounds=1), cfg)


def test_auto_fuses_only_on_hopper_and_group_l2_stays_unfused():
    cfg = ConvexConfig(problem="logistic", n=16, d=4)
    runs = {f: repro_torch.solve(repro_torch.RunSpec(
        "centralvr", rounds=2, fused=f, prox="group_l2:0.01:2"), cfg,
        device="cpu") for f in (False, "auto")}
    np.testing.assert_array_equal(runs["auto"].x, runs[False].x)
    np.testing.assert_array_equal(runs["auto"].rels, runs[False].rels)


def test_own_data_and_orders_from_the_seed():
    """A ConvexConfig run draws data and orders from torch.Generators:
    deterministic, finite, decreasing, and fused == unfused."""
    cfg = ConvexConfig(problem="logistic", n=20, d=5, workers=2)
    spec = repro_torch.RunSpec("centralvr_sync", p=2, rounds=3,
                               metric_every=2)
    a = repro_torch.solve(spec, cfg, device="cpu")
    b = repro_torch.solve(spec, cfg, device="cpu")
    f = repro_torch.solve(repro_torch.RunSpec(
        "centralvr_sync", p=2, rounds=3, metric_every=2, fused=True), cfg,
        device="cpu")
    np.testing.assert_array_equal(a.x, b.x)
    assert a.rels.shape == (2,) and np.isfinite(a.rels).all()
    assert a.rels[-1] < a.rels[0]
    assert a.state.tables.shape == (2, 20)
    _close(f.x, a.x)
    _close(f.rels, a.rels)
    row = json.loads(json.dumps(a.provenance()))
    assert row["spec"]["eta"] == a.spec.eta > 0
    assert row["device"] == "cpu"
    assert row["launches"] == {"vr_update": 0, "vr_epoch": 0,
                               "lazy_epoch": 0}


def test_explicit_orders_are_shape_checked():
    prob = convert.to_problem(_single()[0], device="cpu")
    with pytest.raises(ValueError, match="per-round orders"):
        centralvr.run(prob, eta=0.1, epochs=2,
                      orders=(np.arange(48), np.zeros((3, 48), np.int64)))


def test_package_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "repro_torch.solve\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 15
