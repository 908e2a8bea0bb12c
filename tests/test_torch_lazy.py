"""The PyTorch port's sparse lazy driver (``repro_torch.prox.lazy``,
``sampling="sparse"``) against the JAX reference (``repro.prox.lazy``):
the fixed-width packing and its cache, the closed-form drift map
``lazy_apply`` (every phase, and the tiny drift whose step count passes
2**31), one lazy epoch (``kernels/lazy_epoch/ref.py`` against the
reference's jitted ``_lazy_epoch``), ``run_sparse`` and ``solve``, and
the refusals. The dense prox'd CentralVR driver is the oracle, as in
``tests/test_prox_agreement.py``.

Both packages get the same data (built by the reference, passed through
numpy) and the same permutations (the reference's draws, replayed by
``repro_torch.convert.centralvr_orders``). On CPU tensors the
``lazy_epoch`` wrapper runs its plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core.convex import Problem as JProblem
from repro.prox import lazy as jlazy
from repro.prox import operators as jproxops
from repro_torch import convert
from repro_torch.core import centralvr
from repro_torch.kernels.lazy_epoch import kernel as lazy_kernel
from repro_torch.kernels.lazy_epoch import ref as lazy_ref
from repro_torch.prox import lazy
from repro_torch.prox import operators as proxops

torch.set_num_threads(1)

# the reference's own convex-trajectory tolerance in float64
CONVEX_TOL = 1e-10
KEY = jax.random.PRNGKey(2)


def _close(have, want, tol=CONVEX_TOL):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=tol,
                               atol=tol)


def _sparse(kind="ridge", n=48, d=40, nnz=3, seed=7):
    """The reference's sparse problem and the port's copy of it."""
    prob = jlazy.make_sparse_data(jax.random.PRNGKey(seed), n, d, nnz,
                                  kind=kind)
    return prob, convert.to_problem(prob, device="cpu")


def _varying(kind="ridge", n=48, d=40, nnz=6, seed=7):
    """The reference's sparse problem with a seeded random tail of each
    row's nonzeros zeroed before ``sparsify`` (rows of varying length, so
    padding entries of value 0; row 0 all zero), and the port's copy."""
    prob = jlazy.make_sparse_data(jax.random.PRNGKey(seed), n, d, nnz,
                                  kind=kind)
    A = np.array(prob.A)
    rng = np.random.default_rng(seed)
    for i in range(n):
        nz = np.flatnonzero(A[i])
        A[i, nz[rng.integers(0, len(nz) + 1):]] = 0.0
    A[0] = 0.0
    jp = JProblem(jnp.asarray(A), prob.b, prob.lam, prob.kind)
    return jp, convert.to_problem(jp, device="cpu")


def _epoch_pair(jp, tp, perm=None, *, vr, l1, seed=5):
    """One epoch of the reference's scan and of the port's plain version
    (through the wrapper, on CPU tensors: no launch) from the same seeded
    state; ``perm`` None draws a permutation after it."""
    jsp, tsp = jlazy.sparsify(jp), lazy.sparsify(tp)
    rng = np.random.default_rng(seed)
    z = 0.1 * rng.standard_normal(jp.d)
    table = 0.3 * rng.standard_normal(jp.n)
    gbar = 0.01 * rng.standard_normal(jp.d)
    if perm is None:
        perm = rng.permutation(jp.n)
    eta = 0.05
    want = jlazy._lazy_epoch(jsp.idx, jsp.val, jsp.b, jp.kind, jnp.asarray(z),
                             jnp.asarray(table), jnp.asarray(gbar), eta,
                             jnp.asarray(eta * l1), jnp.asarray(perm), vr=vr)
    before = lazy_kernel.launches
    have = lazy_kernel.lazy_epoch(
        tsp.idx, tsp.val, tsp.b, tp.kind, torch.from_numpy(z),
        torch.from_numpy(table), torch.from_numpy(gbar),
        torch.from_numpy(np.asarray(perm)), eta=eta, c=eta * l1, vr=vr)
    assert lazy_kernel.launches == before       # CPU: the plain version
    return have, want, tsp


def _run_sparse_triple(jp, tp, prox, epochs):
    """run_sparse of the reference and of the port on the same draws, and
    the port's dense driver: the port's state and rels within the
    tolerance of both. Returns the three grad_evals."""
    orders = convert.centralvr_orders(jax.random, KEY, jp.n, epochs)
    st_w, rels_w, ge_w = jlazy.run_sparse(jp, eta=0.05, epochs=epochs,
                                          key=KEY, prox=prox)
    st, rels, ge = lazy.run_sparse(tp, eta=0.05, epochs=epochs,
                                   orders=orders, prox=prox)
    st_d, rels_d, ge_d = centralvr.run(tp, eta=0.05, epochs=epochs,
                                       orders=orders, prox=prox)
    for want in ((st_w.x, st_w.table, st_w.gbar, rels_w),
                 (st_d.x, st_d.table, st_d.gbar, rels_d)):
        for h, w in zip((st.x, st.table, st.gbar, rels), want):
            _close(h, w)
    return st, ge, ge_w, ge_d


def _solve_sparse_pair(jp, tp):
    """``sampling="sparse"`` through ``solve`` on the same problem and
    draws as the reference, and against the port's dense route."""
    spec = dict(algo="centralvr", sampling="sparse", prox="l1:0.02",
                rounds=3, seed=2)
    want = repro.solve(repro.RunSpec(**spec), jp)
    orders = convert.centralvr_orders(jax.random, jax.random.PRNGKey(2),
                                      jp.n, 3)
    have = repro_torch.solve(repro_torch.RunSpec(**spec), tp, device="cpu",
                             orders=orders)
    dense = repro_torch.solve(repro_torch.RunSpec(
        **dict(spec, sampling="permutation")), tp, device="cpu",
        orders=orders)
    for w in (want, dense):
        _close(have.x, w.x)
        _close(have.rels, w.rels)
    assert have.launches == {"vr_update": 0, "vr_epoch": 0, "lazy_epoch": 0}
    return spec, want, have


def _ragged(seed=3, n=30, d=25):
    """Rows of different supports (some empty), for the packing."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.2)
    A[4] = 0.0
    return JProblem(jnp.asarray(A), jnp.asarray(rng.standard_normal(n)),
                    jnp.asarray(0.0), "ridge")


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [None, 12, 25])
def test_sparsify_is_identical_to_the_reference(width):
    jp = _ragged()
    tp = convert.to_problem(jp, device="cpu")
    want = jlazy.sparsify(jp, width)
    have = lazy.sparsify(tp, width)
    assert have.idx.dtype == torch.int32
    np.testing.assert_array_equal(have.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(have.val.numpy(), np.asarray(want.val))
    assert (have.n, have.width, have.d) == (want.n, want.width, want.d)
    # lossless: the rows scatter back to A
    A = torch.zeros_like(tp.A).scatter_(1, have.idx.long(), have.val)
    assert torch.equal(A, tp.A)


def test_sparsify_refuses_a_width_that_drops_nonzeros():
    jp = _ragged()
    with pytest.raises(ValueError, match="drop nonzeros") as want:
        jlazy.sparsify(jp, width=1)
    with pytest.raises(ValueError, match="drop nonzeros") as have:
        lazy.sparsify(convert.to_problem(jp, device="cpu"), width=1)
    assert str(have.value) == str(want.value)


def test_pack_cache_hits_misses_and_evicts_at_four(monkeypatch):
    calls = []
    real = lazy.sparsify
    monkeypatch.setattr(lazy, "sparsify",
                        lambda prob, width=None: calls.append(1)
                        or real(prob, width))
    monkeypatch.setattr(lazy, "_PACK_CACHE", {})
    probs = [_sparse(seed=s)[1] for s in range(5)]
    first = lazy._cached_sparsify(probs[0])
    assert lazy._cached_sparsify(probs[0]) is first and len(calls) == 1
    assert lazy._cached_sparsify(probs[0], 5) is not first   # other width
    assert len(calls) == 2
    for p in probs[1:4]:
        lazy._cached_sparsify(p)
    assert len(lazy._PACK_CACHE) == lazy._PACK_CACHE_CAP == 4
    assert id(probs[0].A) in lazy._PACK_CACHE
    lazy._cached_sparsify(probs[4])             # evicts the oldest entry
    assert len(lazy._PACK_CACHE) == 4
    assert id(probs[0].A) not in lazy._PACK_CACHE
    n = len(calls)
    lazy._cached_sparsify(probs[4])
    assert len(calls) == n                      # a hit


@pytest.mark.parametrize("kind", ["ridge", "logistic"])
def test_make_sparse_data_draws_the_reference_shape(kind):
    gen = torch.Generator().manual_seed(3)
    prob = lazy.make_sparse_data(gen, 64, 30, 4, kind=kind)
    again = lazy.make_sparse_data(torch.Generator().manual_seed(3), 64, 30,
                                  4, kind=kind)
    assert torch.equal(prob.A, again.A) and torch.equal(prob.b, again.b)
    assert prob.A.shape == (64, 30) and prob.A.dtype == torch.float64
    assert ((prob.A != 0).sum(1) == 4).all()
    assert prob.lam == 0.0 and prob.kind == kind
    if kind == "logistic":
        assert set(prob.b.unique().tolist()) <= {-1.0, 1.0}
    with pytest.raises(ValueError, match="nnz"):
        lazy.make_sparse_data(gen, 4, 3, 4)


# ---------------------------------------------------------------------------
# the closed-form drift map
# ---------------------------------------------------------------------------

# (z, k, b, c): every phase of psi^k, psi(z) = S_c(z + b)
LAZY_CASES = {
    "positive stays": (0.5, 7, 0.01, 0.0),
    "positive to negative": (0.5, 100, -0.01, 0.0),
    "negative to positive": (-0.3, 50, 0.02, 0.0),
    "negative stays, l1": (-0.3, 9, -0.02, 0.005),
    "absorbing zero": (0.1, 100, -0.01, 0.02),
    "escaping zero": (0.1, 100, -0.05, 0.02),
    "zero escapes": (0.0, 10, 0.05, 0.01),
    "zero absorbs": (0.0, 10, 0.005, 0.01),
    "k = 0": (0.7, 0, -0.5, 0.1),
    "tiny drift": (0.5, 1000, -1e-10, 0.0),
    "tiny drift, negative": (-0.5, 3000, 1e-12, 0.0),
    "drift 1e-300": (0.25, 40, -1e-300, 0.0),
}


@pytest.mark.parametrize("case", list(LAZY_CASES))
def test_lazy_apply_matches_the_reference(case):
    """Each case alone, then a grid of random ones around it. The tiny
    drifts make ceil(z / drift) pass 2**31: the reference's cast
    saturates, and the port must clamp in float64 before its cast (an
    unclamped ``.to(torch.int32)`` wraps to -2**31 and walks z off)."""
    z, k, b, c = LAZY_CASES[case]
    want = jlazy.lazy_apply(jnp.asarray([z]), jnp.asarray([k]),
                            jnp.asarray([b]), c)
    f64 = dict(dtype=torch.float64)
    have = lazy.lazy_apply(torch.tensor([z], **f64), torch.tensor([k]),
                           torch.tensor([b], **f64), c)
    _close(have, want, 1e-12)
    # and against k sequential steps
    zz = z
    for _ in range(k):
        zz = float(lazy_ref.soft(torch.tensor(zz + b, **f64), c))
    np.testing.assert_allclose(have.numpy(), [zz], rtol=1e-9, atol=1e-12)
    rng = np.random.default_rng(list(LAZY_CASES).index(case))
    zs = z + 0.1 * rng.standard_normal(64)
    ks = rng.integers(0, 2 * k + 2, 64)
    bs = b * (1.0 + rng.random(64))
    _close(lazy.lazy_apply(torch.from_numpy(zs), torch.from_numpy(ks),
                           torch.from_numpy(bs), c),
           jlazy.lazy_apply(jnp.asarray(zs), jnp.asarray(ks),
                            jnp.asarray(bs), c), 1e-12)


# ---------------------------------------------------------------------------
# one lazy epoch, and the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l1", [0.0, 0.02])
@pytest.mark.parametrize("kind", ["ridge", "logistic"])
@pytest.mark.parametrize("vr", [True, False])
def test_lazy_epoch_ref_matches_the_reference_scan(vr, kind, l1):
    have, want, _ = _epoch_pair(*_sparse(kind), vr=vr, l1=l1)
    for h, w in zip(have, want):
        _close(h, w)


@pytest.mark.parametrize("l1", [0.0, 0.02])
@pytest.mark.parametrize("kind", ["ridge", "logistic"])
@pytest.mark.parametrize("vr", [True, False])
def test_lazy_epoch_ref_skips_padding_and_matches_the_reference(vr, kind,
                                                                l1):
    """Rows of varying length: the plain version skips the value-0
    entries, the reference's scan updates them; one drift step each,
    which the next catch-up applies in closed form, so they agree to
    rounding."""
    jp, tp = _varying(kind)
    perm = np.random.default_rng(5).permutation(jp.n)
    have, want, tsp = _epoch_pair(jp, tp, perm, vr=vr, l1=l1)
    assert 0 < int((tsp.val == 0).sum()) < tsp.val.numel() // 2
    assert not tsp.val[0].any()                 # the all-zero row
    for h, w in zip(have, want):
        _close(h, w)


def test_lazy_epoch_ref_on_an_all_zero_row():
    """A row whose values are all zero: its margin is 0, so its table
    entry is l'(0; b), and it moves no coordinate."""
    jp, tp = _varying("logistic")
    perm = np.concatenate([[0], np.random.default_rng(6).permutation(
        np.arange(1, jp.n))])
    have, want, tsp = _epoch_pair(jp, tp, perm, vr=True, l1=0.02)
    for h, w in zip(have, want):
        _close(h, w)
    assert float(have[1][0]) == -0.5 * float(tsp.b[0])     # l'(0; b)


@pytest.mark.parametrize("vr", [True, False])
@pytest.mark.parametrize("varying", [False, True])
def test_lazy_epoch_ref_with_a_row_visited_twice_in_a_row(varying, vr):
    """perm[t+1] == perm[t] (and a row again two steps later): the second
    visit reads the first one's values and table entry."""
    jp, tp = _varying() if varying else _sparse()
    perm = np.random.default_rng(8).permutation(jp.n)
    perm[1] = perm[0]
    perm[5], perm[7] = perm[4], perm[5]
    have, want, _ = _epoch_pair(jp, tp, perm, vr=vr, l1=0.02)
    for h, w in zip(have, want):
        _close(h, w)


@pytest.mark.parametrize("kind", ["ridge", "logistic"])
@pytest.mark.parametrize("varying", [False, True])
def test_lazy_epoch_ref_when_consecutive_rows_share_most_coordinates(
        varying, kind):
    """d = 2 x width: consecutive rows share half their coordinates, so
    most of a step's catch-ups start from the last step's values."""
    shape = dict(kind=kind, n=40, d=12, nnz=6)
    jp, tp = _varying(**shape) if varying else _sparse(**shape)
    perm = np.random.default_rng(9).permutation(jp.n)
    have, want, _ = _epoch_pair(jp, tp, perm, vr=True, l1=0.02)
    for h, w in zip(have, want):
        _close(h, w)


@pytest.mark.parametrize("prox", [None, "l1:0.02"])
@pytest.mark.parametrize("kind", ["ridge", "logistic"])
def test_run_sparse_on_rows_of_varying_length(kind, prox):
    """run_sparse on rows of varying length (an all-zero row among them)
    against the reference's and the dense driver's."""
    _run_sparse_triple(*_varying(kind), prox, 3)


def test_solve_sparse_on_rows_of_varying_length():
    _solve_sparse_pair(*_varying("logistic"))


@pytest.mark.parametrize("prox", [None, "l1:0.02"])
@pytest.mark.parametrize("kind", ["ridge", "logistic"])
def test_run_sparse_matches_the_reference_and_the_dense_driver(kind, prox):
    st, ge, ge_w, ge_d = _run_sparse_triple(*_sparse(kind), prox, 4)
    np.testing.assert_array_equal(ge, np.asarray(ge_w))
    np.testing.assert_array_equal(ge, ge_d)
    if prox is not None:
        assert float((st.x == 0.0).double().mean()) > 0.3


def test_run_sparse_from_x0_and_through_centralvr_run():
    jp, tp = _sparse("logistic")
    x0 = 0.05 * np.random.default_rng(1).standard_normal(jp.d)
    orders = convert.centralvr_orders(jax.random, KEY, jp.n, 3)
    want = repro.core.centralvr.run(jp, eta=0.05, epochs=3, key=KEY,
                                    sampling="sparse", prox="l1:0.01",
                                    x0=jnp.asarray(x0))
    have = centralvr.run(tp, eta=0.05, epochs=3, orders=orders,
                         sampling="sparse", prox="l1:0.01",
                         x0=torch.from_numpy(x0))
    dense = centralvr.run(tp, eta=0.05, epochs=3, orders=orders,
                          prox="l1:0.01", x0=torch.from_numpy(x0))
    for w in (want, dense):
        _close(have[0].x, w[0].x)
        _close(have[1], w[1])


def test_solve_sparse_matches_the_reference():
    """The acceptance pin: ``sampling="sparse"`` through ``solve`` on the
    same problem and draws, and against the port's dense route."""
    jp, tp = _sparse()
    spec, want, have = _solve_sparse_pair(jp, tp)
    np.testing.assert_array_equal(have.grad_evals, want.grad_evals)
    assert have.device == "cpu"
    own = repro_torch.solve(repro_torch.RunSpec(**spec), tp, device="cpu")
    assert np.isfinite(own.rels).all() and own.rels[-1] < own.rels[0]


# ---------------------------------------------------------------------------
# refusals, where the reference refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(prox="l2:0.1"), dict(prox="box:-1:1"), dict(prox="elasticnet"),
    dict(fused=True), dict(fused="auto"), dict(backend="spmd"),
])
def test_sparse_runspec_refuses_like_the_reference(kw):
    spec = dict(algo="centralvr", sampling="sparse", **kw)
    with pytest.raises(ValueError) as want:
        repro.RunSpec(**spec)
    with pytest.raises(ValueError) as have:
        repro_torch.RunSpec(**spec)
    assert str(have.value) == str(want.value)


@pytest.mark.parametrize("case", ["lam", "prox"])
def test_run_sparse_refuses_like_the_reference(case):
    jp, tp = _sparse(n=16, d=12, nnz=2)
    kw = dict(eta=0.05, epochs=1)
    if case == "lam":
        jp = JProblem(jp.A, jp.b, jnp.asarray(1e-3), jp.kind)
        tp = tp._replace(lam=1e-3)
    prox = "box:-1:1" if case == "prox" else None
    with pytest.raises(ValueError) as want:
        jlazy.run_sparse(jp, key=KEY, prox=prox, **kw)
    with pytest.raises(ValueError) as have:
        lazy.run_sparse(tp, prox=prox, **kw)
    assert str(have.value) == str(want.value)


def test_lazy_epoch_wrapper_checks_its_operands():
    _, tp = _sparse()
    sp = lazy.sparsify(tp)
    z = torch.zeros(tp.d, dtype=torch.float64)
    tab = torch.zeros(tp.n, dtype=torch.float64)
    perm = torch.arange(tp.n)
    kw = dict(eta=0.1, c=0.0, vr=True)
    ok = (sp.idx, sp.val, sp.b, "ridge", z, tab, z, perm)
    lazy_kernel.lazy_epoch(*ok, **kw)
    bad = {
        "idx is torch.int64": (sp.idx.long(),) + ok[1:],
        "val is torch.float32": (sp.idx, sp.val.float()) + ok[2:],
        "not contiguous": (sp.idx, sp.val.t().contiguous().t()) + ok[2:],
        "gbar has shape": ok[:6] + (z[:-1],) + ok[7:],
        "unknown problem kind": ok[:3] + ("hinge",) + ok[4:],
        r"perm holds indices in \[1, 48\]": ok[:7] + (perm + 1,),
        r"idx holds indices": (sp.idx + tp.d,) + ok[1:],
    }
    for match, args in bad.items():
        with pytest.raises((TypeError, ValueError), match=match):
            lazy_kernel.lazy_epoch(*args, **kw)
    with pytest.raises(ValueError, match="row width 1025"):
        lazy_kernel.launch_plan(1025)


@pytest.mark.parametrize("width,threads,entries", [
    (1, 32, 1), (32, 32, 1), (74, 96, 1), (128, 128, 1), (129, 96, 2),
    (300, 96, 4), (512, 128, 4), (513, 96, 8), (1024, 128, 8)])
def test_lazy_epoch_launch_plan(width, threads, entries):
    plan = lazy_kernel.launch_plan(width)
    assert (plan.threads, plan.entries) == (threads, entries)
    assert plan.threads * plan.entries >= width


def test_prox_package_exports_what_the_reference_exports():
    import repro.prox
    import repro_torch.prox
    assert repro_torch.prox.__all__ == repro.prox.__all__
    for name in repro_torch.prox.__all__:
        assert callable(getattr(repro_torch.prox, name))
    assert proxops.names() == jproxops.names()
    w = np.random.default_rng(0).standard_normal(8) * 2.0
    for spec in ("l1:0.3", "elasticnet:0.2:0.5", "box:-0.5:0.5",
                 "group_l2:0.3:4"):
        _close(proxops.numeric_prox(spec, torch.from_numpy(w), 0.7),
               jproxops.numeric_prox(spec, jnp.asarray(w), 0.7), 1e-12)
