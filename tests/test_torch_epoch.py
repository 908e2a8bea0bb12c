"""K1's epoch route (``kernels/vr_update/epoch.py``, ``csrc/vr_epoch.cu``)
on the CPU: its plain version ``vr_epoch_ref`` against a step-by-step
loop of ``vr_update_ref``, the port's fused epochs (``core/fused.py``,
now one ``vr_epoch`` call each) against the reference's
``repro.core.fused`` run in Pallas interpret mode, the fused init epoch
against the plain SGD epoch, the wrapper's refusals and its launch plan.

Inputs are made with numpy from a seed and handed to both packages. The
CUDA kernel against its plain version on the card is in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fused as jfused
from repro_torch.core import convex, distributed
from repro_torch.core import fused as tfused
from repro_torch.kernels.vr_update import epoch as vr_epoch
from repro_torch.kernels.vr_update import ref as vr_ref
from repro_torch.prox import operators as proxops

torch.set_num_threads(1)

# the reference's own convex-trajectory tolerance in float64
# (tests/test_fused_agreement.py)
CONVEX_TOL = 1e-10
LANES = ["centralvr", "saga", "svrg"]
KINDS = ["logistic", "ridge", "huber@0.5", "pseudo_huber"]
PROXES = [None, "l1:0.05", "elasticnet:0.05:0.3", "box:-0.2:0.3"]
P, N, D, T = 2, 9, 5, 14


def _inputs(kind, repeats, seed=0, p=P, n=N, d=D, steps=T):
    """(A, b, orders, x, table, gbar) as numpy arrays: orders are
    permutations of the shard (cut to ``steps``) or, with ``repeats``,
    uniform draws that repeat indices, back to back among them."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, n, d)) / np.sqrt(d)
    b = (np.where(rng.random((p, n)) < 0.5, -1.0, 1.0)
         if kind == "logistic" else rng.standard_normal((p, n)))
    if repeats:
        orders = rng.integers(0, n, (p, steps))
        orders[:, 3] = orders[:, 2]
    else:
        orders = np.stack([rng.permutation(n) for _ in range(p)])[:, :steps]
    x = 0.1 * rng.standard_normal((p, d))
    table = 0.3 * rng.standard_normal((p, n))
    gbar = 0.1 * rng.standard_normal((p, d))
    return A, b, orders, x, table, gbar


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(have, want, tol=CONVEX_TOL):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=tol,
                               atol=tol)


def _step_loop(A, b, orders, x, table, gbar, *, lane, kind, eta, decay, m,
               prox):
    """The epoch written out step by step, each step one vr_update_ref,
    rows and table entries read by index (no gathered copy)."""
    w = torch.arange(A.shape[0])
    table, acc = table.clone(), torch.zeros_like(x)
    for t in range(orders.shape[1]):
        i = orders[:, t]
        a = A[w, i]
        s = convex._pointwise_residual(torch.linalg.vecdot(a, x), b[w, i],
                                       kind)
        x, _, acc, gbar = vr_ref.vr_update_ref(
            x, s[:, None] * a, table[w, i][:, None] * a, gbar, acc, eta=eta,
            m=m, saga=lane == "saga", decay=decay, prox=prox)
        if lane != "svrg":
            table[w, i] = s
    return x, table, gbar, acc


@pytest.mark.parametrize("repeats", [False, True],
                         ids=["permutation", "repeats"])
@pytest.mark.parametrize("prox", PROXES, ids=str)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lane", LANES)
def test_plain_epoch_is_a_loop_of_plain_updates(lane, kind, prox, repeats):
    """vr_epoch on CPU tensors (its plain version) is bit-equal to a loop
    of K1's plain version, leaves its inputs as they were and counts no
    launch."""
    arrays = _inputs(kind, repeats, seed=len(kind))
    ts = _torch(*arrays)
    kw = dict(lane=lane, kind=kind, eta=0.3, decay=2e-3, m=N * P,
              prox=proxops.parse(prox) if prox else None)
    before = vr_epoch.launches
    have = vr_epoch.vr_epoch(*ts, **kw)
    assert vr_epoch.launches == before
    want = _step_loop(*_torch(*arrays), **kw)
    for name, h, w in zip(("x", "table", "gbar"), have, want):
        assert torch.equal(h, w), name
    if lane == "centralvr":
        assert torch.equal(have[3], want[3])
    else:
        assert have[3] is None
    for t, a in zip(ts, arrays):
        assert torch.equal(t, torch.from_numpy(a))
    # what the lane leaves alone comes back as the input itself
    assert (have[1] is ts[4]) == (lane == "svrg")
    assert (have[2] is ts[5]) == (lane != "saga")


REFERENCE_CASES = ([(lane, kind, None) for lane in LANES for kind in KINDS]
                   + [(lane, "logistic", prox) for lane in LANES
                      for prox in PROXES[1:]])


@pytest.mark.parametrize("lane,kind,prox", REFERENCE_CASES, ids=str)
def test_fused_epochs_match_the_reference(lane, kind, prox):
    """core/fused.py's three functions (one vr_epoch call each) against
    the reference's (a lax.scan of the Pallas kernel in interpret mode),
    worker by worker, with repeated indices."""
    A, b, orders, x, table, gbar = _inputs(kind, True, seed=7)
    tA, tb, to, tx, ttab, tg = _torch(A, b, orders, x, table, gbar)
    eta, lam = 0.05, float(np.float32(1e-3))
    fp = tfused.make_params(True, eta, lam, "cpu", prox=prox)
    jfp = jfused.make_params(True, eta, lam, prox=prox)
    if lane == "centralvr":
        have = tfused.centralvr_epoch(tA, tb, kind, tx, ttab, tg, to, fp)
    elif lane == "saga":
        have = tfused.saga_steps(tA, tb, kind, tx, ttab, tg, N * P, to, fp)
    else:
        xbar = tx[0].expand(P, -1)
        have = (tfused.svrg_steps(tA, tb, kind, xbar, ttab, tg, to, fp),)
    for w in range(P):
        args = [jnp.asarray(v[w]) for v in (A, b)]
        if lane == "centralvr":
            want = jfused.centralvr_epoch(
                *args, kind, jnp.asarray(x[w]), jnp.asarray(table[w]),
                jnp.asarray(gbar[w]), jnp.asarray(orders[w]), jfp)[:3]
        elif lane == "saga":
            want = jfused.saga_steps(
                *args, kind, jnp.asarray(x[w]), jnp.asarray(table[w]),
                jnp.asarray(gbar[w]), N * P, jnp.asarray(orders[w]), jfp)
        else:
            want = (jfused.svrg_steps(
                *args, kind, jnp.asarray(x[0]), jnp.asarray(table[w]),
                jnp.asarray(gbar[w]), jnp.asarray(orders[w]), jfp),)
        for h, r in zip(have, want):
            _close(h[w], r)


@pytest.mark.parametrize("prox", [None, "l1:0.05"], ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_fused_init_epoch_matches_the_sgd_epoch(kind, prox):
    """The init epoch as the CentralVR lane from a zero table and gbar
    (one vr_epoch call) against the plain SGD epoch, on permutations."""
    A, b, orders, _, _, _ = _inputs(kind, False, seed=3, steps=N)
    tA, tb, to = _torch(A, b, orders)
    eta, lam = 0.1, float(np.float32(1e-3))
    px = proxops.parse(prox) if prox else None
    fp = tfused.make_params(True, eta, lam, "cpu", prox=px)
    x0 = torch.zeros(P, D, dtype=torch.float64)
    have = distributed._local_sgd_epoch(tA, tb, lam, kind, x0, eta, to,
                                        prox=px, fused=fp)
    want = distributed._local_sgd_epoch(tA, tb, lam, kind, x0, eta, to,
                                        prox=px)
    for h, w in zip(have, want):
        _close(h, w)


def _refusal_cases():
    A, b, orders, x, table, gbar = _torch(*_inputs("logistic", False))
    good = dict(A=A, b=b, orders=orders, x=x, table=table, gbar=gbar)
    bad = {
        "float32": (TypeError, dict(A=A.float())),
        "int32 orders": (TypeError, dict(orders=orders.int())),
        "x shape": (ValueError, dict(x=x[:, :-1].contiguous())),
        "orders 1-d": (ValueError, dict(orders=orders[0].contiguous())),
        "A 2-d": (ValueError, dict(A=A[0])),
        "device": (ValueError, dict(gbar=gbar.to("meta"))),
        "non-contiguous": (ValueError, dict(
            table=torch.empty(N, P, dtype=torch.float64).t())),
        "index n": (ValueError, dict(orders=torch.full_like(orders, N))),
        "index -1": (ValueError, dict(orders=torch.full_like(orders, -1))),
    }
    return good, bad


@pytest.mark.parametrize("case", list(_refusal_cases()[1]))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    good, bad = _refusal_cases()
    err, change = bad[case]
    args = dict(good, **change)
    with pytest.raises(err):
        vr_epoch.vr_epoch(args["A"], args["b"], args["orders"], args["x"],
                          args["table"], args["gbar"], lane="saga",
                          kind="logistic", eta=0.1, decay=0.0, m=N)


@pytest.mark.parametrize("lane,kind", [("sarah", "logistic"),
                                       ("saga", "hinge")])
def test_wrapper_refuses_unknown_lanes_and_losses(lane, kind):
    good, _ = _refusal_cases()
    with pytest.raises(ValueError, match="lane|kind"):
        vr_epoch.vr_epoch(*good.values(), lane=lane, kind=kind, eta=0.1,
                          decay=0.0, m=N)


@pytest.mark.parametrize("p,d,want", [
    (1, 1, (32, 1, True, 512 + 8 * 4 * 1)),
    (1, 20, (32, 1, True, 512 + 8 * 4 * 20)),        # toy-logistic: a warp
    (1, 32, (32, 1, True, 512 + 8 * 4 * 32)),
    (1, 33, (64, 1, True, 512 + 8 * 4 * 33)),
    (1, 90, (96, 1, True, 512 + 8 * 4 * 90)),        # millionsong
    (1, 256, (256, 1, True, 512 + 8 * 4 * 256)),
    (1, 257, (256, 2, True, 512 + 8 * 4 * 257)),
    (8, 1000, (256, 4, True, 512 + 8 * 4 * 1000)),   # dist-toy-logistic
    (1, 1024, (256, 4, True, 512 + 8 * 4 * 1024)),
    (1, 1025, (512, 4, True, 512 + 8 * 4 * 1025)),
    (1, 2049, (512, 8, True, 512 + 8 * 4 * 2049)),
    (1, 4096, (512, 8, True, 512 + 8 * 4 * 4096)),   # the on-chip capacity
    (1, 4097, (1024, 0, False, 512)),                # state in global memory
    (3, 20000, (1024, 0, False, 512)),
])
def test_launch_plan_pins_every_branch(p, d, want):
    plan = vr_epoch.launch_plan(p, d)
    assert plan == vr_epoch.Plan(p, *want)
    assert plan.smem_bytes <= vr_epoch.SMEM_BYTES
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    if plan.on_chip:     # every coordinate owned by one thread
        assert plan.threads * plan.coords >= d
        assert plan.threads <= vr_epoch.MAX_REG_THREADS


def _solve(algo, orders, fused, **kw):
    import repro_torch
    from repro_torch.config import ConvexConfig
    p = kw.pop("p", 1)
    cfg = ConvexConfig(problem="logistic", n=12, d=6, workers=p)
    return repro_torch.solve(repro_torch.RunSpec(algo, p=p, fused=fused,
                                                 **kw),
                             cfg, device="cpu", orders=orders)


def _perms(rng, k, n):
    return np.stack([rng.permutation(n) for _ in range(k)])


# (algo, keywords, orders with one index out of range): each driver's
# draws and, for SVRG and D-SVRG, the anchors, whose range is tau
def _bad_orders():
    rng = np.random.default_rng(0)
    n, ns, R = 12, 12, 2
    late = _perms(rng, R, n)
    late[1, 3] = n
    neg = rng.integers(0, ns, (R * 2, 100))
    neg[0, 0] = -1
    return [
        ("centralvr", dict(rounds=R), (rng.permutation(n), late)),
        ("centralvr_sync", dict(rounds=R, p=2),
         (_perms(rng, 2, ns), np.stack([_perms(rng, 2, ns) + ns] * R))),
        ("saga", dict(rounds=R), late),
        ("dsaga", dict(rounds=R, p=2, tau=100), neg),
        ("svrg", dict(rounds=R, tau=5),
         (np.full((R, 5), n), None)),
        ("svrg", dict(rounds=R, snapshot="rand", tau=5),
         (rng.integers(0, n, (R, 5)), np.array([0, 5]))),
        ("dsvrg", dict(rounds=R, p=2, snapshot="rand", tau=5),
         (rng.integers(0, ns, (R, 2, 5)), np.array([5, 0]))),
    ]


@pytest.mark.parametrize("algo,kw,orders", _bad_orders(),
                         ids=[c[0] + ("-anchors" if "snapshot" in c[1]
                                      else "") for c in _bad_orders()])
def test_drivers_refuse_draws_out_of_range(algo, kw, orders):
    """Each run's draws are range-checked once where they come in, before
    anything runs, fused or not: the fused epochs launch without a check
    (and a sync) of their own. Random anchors run only unfused."""
    for fused in ((False,) if kw.get("snapshot") == "rand"
                  else (True, False)):
        with pytest.raises(ValueError, match="out of range"):
            _solve(algo, orders, fused, **dict(kw))


@pytest.mark.parametrize("algo,p", [("centralvr", 1), ("centralvr_sync", 2),
                                    ("centralvr_async", 2)])
def test_fused_init_refuses_init_orders_that_are_not_permutations(algo, p):
    """The fused init epoch reads back the table it writes, so it equals
    the SGD epoch only on permutations: with a repeated index it refuses,
    and the unfused run takes the same orders."""
    rng = np.random.default_rng(1)
    R, ns = 2, 12
    init = _perms(rng, p, ns)
    init[:, 1] = init[:, 0]
    per = np.stack([_perms(rng, p, ns) for _ in range(R * (
        p if algo == "centralvr_async" else 1))])
    if algo == "centralvr":
        orders = (init[0], per[:, 0])
    elif algo == "centralvr_sync":
        orders = (init, per)
    else:
        orders = (init, per[:, 0])
    with pytest.raises(ValueError, match="permutations"):
        _solve(algo, orders, True, rounds=R, p=p)
    res = _solve(algo, orders, False, rounds=R, p=p)
    assert np.isfinite(res.rels).all()


@pytest.mark.parametrize("algo,kw", [
    ("centralvr", {}), ("centralvr_sync", {"p": 2}), ("saga", {}),
    ("svrg", {}), ("centralvr_async", {"p": 2}),
    ("dsaga", {"p": 2, "tau": 10}), ("dsvrg", {"p": 2})])
def test_fused_runs_do_not_range_check_each_launch(monkeypatch, algo, kw):
    """The fused VR paths go through ``vr_epoch_in_range``: the wrapper's
    own range check (one sync a call) is never run on a driver's path."""
    def refuse(*args):
        raise AssertionError("a fused path range-checked a launch")
    monkeypatch.setattr(vr_epoch, "check_orders", refuse)
    before = vr_epoch.launches
    res = _solve(algo, None, True, rounds=2, **kw)
    assert vr_epoch.launches == before       # CPU tensors: no launch
    assert np.isfinite(res.rels).all()
