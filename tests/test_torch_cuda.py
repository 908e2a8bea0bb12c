"""Tests of the PyTorch port that need an NVIDIA card: the hand-written
kernels (K1 vr_update and its epoch route vr_epoch, the sparse driver's
lazy_epoch, K2 rmsnorm, K3 flash_attention, K4 ssd_scan) against their
plain versions, on the card, the fused convex solves, the sparse route
and the fused Mamba2 step, and the fused paths' refusal to fall back when
a kernel does not build.

Run them on a machine with a Hopper card (this file imports no jax, and
``--noconftest`` skips the suite's jax set-up):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.lazy_epoch import cases as lazy_cases
from repro_torch.kernels.vr_update import epoch as vr_epoch
from repro_torch.kernels.vr_update import kernel as vr_kernel
from repro_torch.kernels.vr_update import ref as vr_ref
from repro_torch.prox import operators as proxops

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


@pytest.mark.parametrize("prox", [None, "l1:0.05", "elasticnet:0.05:0.3",
                                  "box:-0.2:0.3"])
@pytest.mark.parametrize("saga", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_vr_update_kernel_matches_plain(device, dtype, tol, saga, prox):
    rng = np.random.default_rng(0)
    ts = [torch.from_numpy(rng.standard_normal((8, 1000))).to(device, dtype)
          for _ in range(5)]
    kw = dict(eta=0.3, m=5000, saga=saga, decay=2e-4,
              prox=proxops.parse(prox) if prox else None)
    before = vr_kernel.launches
    got = vr_kernel.vr_update(*ts, **kw)
    torch.cuda.synchronize()
    assert vr_kernel.launches == before + 1
    for w, h in zip(vr_ref.vr_update_ref(*ts, **kw), got):
        scale = 1.0 if dtype == torch.float64 else w.abs().max().item()
        assert (h - w).abs().max().item() <= tol * scale


@pytest.mark.parametrize("saga", [False, True])
def test_vr_update_kernel_stores_only_what_changes(device, saga):
    # table' is g itself, and gbar' is gbar itself without SAGA; the other
    # outputs are new tensors, or the inputs when in place
    rng = np.random.default_rng(1)
    ts = [torch.from_numpy(rng.standard_normal((8, 1000))).to(device)
          for _ in range(5)]
    kw = dict(eta=0.3, m=5000, saga=saga, decay=2e-4, prox=None)
    copies = [t.clone() for t in ts]
    want = vr_ref.vr_update_ref(*copies, **kw)
    got = vr_kernel.vr_update(*ts, **kw)
    assert got[1] is ts[1] and (got[3] is ts[3]) == (not saga)
    for t, c in zip(ts, copies):
        assert torch.equal(t, c)
    inplace = vr_kernel.vr_update(*ts, inplace=True, **kw)
    torch.cuda.synchronize()
    assert all(h is t for h, t in zip(inplace, (ts[0], ts[1], ts[4], ts[3])))
    for w, h, i in zip(want, got, inplace):
        assert torch.equal(h, w) and torch.equal(i, w)


def _loop_inputs(device, p, n=5000, d=1000, T=200, seed=0):
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((p, n, d)) / np.sqrt(d))
    b = torch.from_numpy(np.where(rng.random((p, n)) < 0.5, -1.0, 1.0))
    x = torch.from_numpy(0.1 * rng.standard_normal((p, d)))
    table = torch.from_numpy(0.3 * rng.standard_normal((p, n)))
    gbar = torch.from_numpy(0.01 * rng.standard_normal((p, d)))
    idx = torch.from_numpy(rng.integers(0, n, (p, T)))
    return [t.to(device) for t in (A, b, x, table, gbar, idx)]


@pytest.mark.parametrize("prox", [None, "l1:0.01"])
@pytest.mark.parametrize("p", [1, 8])
def test_saga_and_svrg_steps_on_the_card_match_unfused(device, p, prox):
    """vr_epoch's SAGA lane (gbar updated in the step, 1/m scaling) and
    its SVRG lane (snapshot residuals as g_old) on the convex path's
    shapes, (1, 1000) and (8, 1000) float64: one launch for the T steps,
    none of K1, fused within 1e-10 of the unfused bodies."""
    from repro_torch.core import distributed
    from repro_torch.core import fused as tfused
    A, b, x, table, gbar, idx = _loop_inputs(device, p)
    eta, lam = 0.05, float(np.float32(1e-4))
    px = proxops.parse(prox) if prox else None
    fp = tfused.make_params(True, eta, lam, device, prox=px)
    before = (vr_kernel.launches, vr_epoch.launches)
    have = tfused.saga_steps(A, b, "logistic", x, table, gbar, 5000 * p,
                             idx, fp)
    torch.cuda.synchronize()
    assert (vr_kernel.launches, vr_epoch.launches) == (before[0],
                                                       before[1] + 1)
    want = distributed._local_saga_steps(A, b, lam, "logistic", x, table,
                                         gbar, eta, 5000 * p, idx, prox=px)
    for h, w in zip(have, want):
        assert (h - w).abs().max().item() <= 1e-10
    xbar = x[0]
    g = gbar[0] + 2.0 * lam * xbar
    before = (vr_kernel.launches, vr_epoch.launches)
    have = distributed._svrg_anchors(A, b, lam, "logistic", xbar, g, eta,
                                     idx, fused=fp, prox=px)
    torch.cuda.synchronize()
    assert (vr_kernel.launches, vr_epoch.launches) == (before[0],
                                                       before[1] + 1)
    want = distributed._svrg_anchors(A, b, lam, "logistic", xbar, g, eta,
                                     idx, prox=px)
    assert (have - want).abs().max().item() <= 1e-10


# vr_epoch launches of one fused solve over R rounds: one per fused epoch
# or inner loop (the init epoch of Algorithms 1-3 included; dsvrg's p
# workers share one launch a round; the events of Algorithms 3 and 5 run
# one worker each); K1 launches none
VR_SOLVES = [
    ("centralvr", 1, {}, lambda R, p: R + 1),
    ("centralvr", 1, {"sampling": "uniform"}, lambda R, p: R + 1),
    ("centralvr_sync", 3, {}, lambda R, p: R + 1),
    ("centralvr_async", 3, {"speeds": (1.0, 2.0, 0.5)},
     lambda R, p: 1 + R * p),
    ("dsvrg", 3, {}, lambda R, p: R),
    ("dsaga", 3, {"tau": 10, "fetch": "stale"}, lambda R, p: R * p),
    ("dsaga", 3, {"tau": 10}, lambda R, p: R * p),
    ("svrg", 1, {}, lambda R, p: R),
    ("saga", 1, {}, lambda R, p: R),
]


@pytest.mark.parametrize("algo,p,kw,expected", VR_SOLVES,
                         ids=[f"{a}-{kw}" for a, _, kw, _ in VR_SOLVES])
def test_fused_solve_launches_vr_epoch_once_per_epoch_call(device, algo, p,
                                                           kw, expected):
    """Every VR algorithm through ``repro_torch.solve`` on the card, fused
    and unfused on the same seed: vr_epoch's launch count, K1's zero, and
    the agreement."""
    import repro_torch
    from repro_torch.config import ConvexConfig
    cfg = ConvexConfig(problem="logistic", n=40, d=24, workers=p)
    R = 3
    runs = {}
    for fused in (True, False):
        before = (vr_kernel.launches, vr_epoch.launches)
        runs[fused] = repro_torch.solve(repro_torch.RunSpec(
            algo, p=p, rounds=R, fused=fused, **kw), cfg)
        assert runs[fused].launches == {
            "vr_update": vr_kernel.launches - before[0],
            "vr_epoch": vr_epoch.launches - before[1], "lazy_epoch": 0}
    assert runs[True].launches == {"vr_update": 0,
                                   "vr_epoch": expected(R, p),
                                   "lazy_epoch": 0}
    assert runs[False].launches == {"vr_update": 0, "vr_epoch": 0,
                                    "lazy_epoch": 0}
    assert runs[True].device == torch.cuda.get_device_name(device)
    assert np.abs(runs[True].x - runs[False].x).max() <= 1e-10
    assert np.abs(runs[True].rels - runs[False].rels).max() <= 1e-10
    assert np.isfinite(runs[True].rels).all()


def _epoch_inputs(device, p, n, d, T, repeats, kind="logistic", seed=0,
                  offset=0):
    """A (p, n, d) rows of norm ~1 (``offset``: A starts that many float64
    elements into its buffer), labels, visit orders (permutations cut to T,
    or uniform draws that repeat indices), x, table, gbar."""
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(device=device, dtype=torch.float64)
    A = (torch.randn(p * n * d + offset, generator=g, **f64)
         / d ** 0.5)[offset:].view(p, n, d)
    b = (torch.randint(0, 2, (p, n), generator=g, device=device) * 2 - 1.0
         if kind == "logistic" else torch.randn(p, n, generator=g, **f64))
    if repeats:
        orders = torch.randint(0, n, (p, T), generator=g, device=device)
    else:
        orders = torch.stack([torch.randperm(n, generator=g, device=device)
                              for _ in range(p)])[:, :T].contiguous()
    x = 0.1 * torch.randn(p, d, generator=g, **f64)
    table = 0.3 * torch.randn(p, n, generator=g, **f64)
    gbar = 0.01 * torch.randn(p, d, generator=g, **f64)
    return A, b.to(torch.float64), orders, x, table, gbar


def _epoch_against_plain(inputs, **kw):
    """One vr_epoch launch against its plain version on the same CUDA
    inputs: every output within 1e-10 of its largest magnitude."""
    before = (vr_kernel.launches, vr_epoch.launches)
    have = vr_epoch.vr_epoch(*inputs, **kw)
    torch.cuda.synchronize()
    assert (vr_kernel.launches, vr_epoch.launches) == (before[0],
                                                       before[1] + 1)
    want = vr_ref.vr_epoch_ref(*inputs, **kw)
    for name, h, w in zip(("x", "table", "gbar", "acc"), have, want):
        if w is None:
            assert h is None
            continue
        assert torch.isfinite(h).all(), name
        err = (h - w).abs().max().item()
        assert err <= 1e-10 * w.abs().max().item(), (name, err)


# (p, n, d, T, repeats): the paths' shapes with T cut for the plain loop,
# a dense repeat (n 5: indices recur one and two steps apart), odd d, d
# at the on-chip capacity (512 threads of 8 coordinates) and a d above it
# (state in global memory)
EPOCH_SHAPES = [(8, 600, 1000, 300, False), (1, 800, 90, 400, True),
                (1, 300, 20, 400, True), (1, 5, 20, 200, True),
                (2, 200, 999, 200, True), (1, 40, 4096, 40, True),
                (1, 50, 20000, 60, True)]


@pytest.mark.parametrize("shape", EPOCH_SHAPES, ids=str)
@pytest.mark.parametrize("lane", ["centralvr", "saga", "svrg"])
def test_vr_epoch_kernel_matches_plain(device, lane, shape):
    p, n, d, T, repeats = shape
    _epoch_against_plain(
        _epoch_inputs(device, p, n, d, T, repeats), lane=lane,
        kind="logistic", eta=0.05, decay=2e-4, m=n * p,
        prox=proxops.parse("l1:0.001") if d % 2 else None)


@pytest.mark.parametrize("prox", [None, "l1:0.05", "elasticnet:0.05:0.3",
                                  "box:-0.2:0.3"], ids=str)
@pytest.mark.parametrize("kind", ["logistic", "ridge", "huber@0.5",
                                  "pseudo_huber"])
def test_vr_epoch_kernel_losses_and_proxes_match_plain(device, kind, prox):
    _epoch_against_plain(
        _epoch_inputs(device, 2, 300, 90, 300, True, kind=kind, seed=1),
        lane="saga", kind=kind, eta=0.05, decay=2e-4, m=600,
        prox=proxops.parse(prox) if prox else None)


def test_vr_epoch_kernel_reads_misaligned_rows(device):
    """A one float64 into its buffer: rows 8-byte but not 16-byte aligned,
    which the kernel's 8-byte cp.async copies take as they are."""
    inputs = _epoch_inputs(device, 2, 300, 1000, 200, True, offset=1)
    assert inputs[0].data_ptr() % 16 == 8
    _epoch_against_plain(inputs, lane="centralvr", kind="logistic",
                         eta=0.05, decay=2e-4, m=600)


def test_fused_solve_raises_when_vr_epoch_does_not_build(device,
                                                         monkeypatch,
                                                         tmp_path):
    """fused=True on the card launches vr_epoch or raises: a failed build
    is an error, never a fall back to the plain version or to K1."""
    import repro_torch
    from repro_torch.config import ConvexConfig
    from repro_torch.kernels import build

    bad = tmp_path / "vr_epoch_broken.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(vr_epoch, "SOURCE", bad)
    monkeypatch.setattr(vr_epoch, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    before = (vr_kernel.launches, vr_epoch.launches)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        repro_torch.solve(repro_torch.RunSpec("saga", rounds=1, fused=True),
                          ConvexConfig(problem="logistic", n=40, d=24))
    assert (vr_kernel.launches, vr_epoch.launches) == before


# ---------------------------------------------------------------------------
# vr_epoch's tracked epoch, and the sparse driver's lazy_epoch
# ---------------------------------------------------------------------------

def test_tracked_fused_epoch_matches_unfused_in_one_launch(device):
    """track_iterates on the fused route: one vr_epoch launch an epoch
    (the kernel's tracked instantiation stores the iterate before each
    step), against the unfused tracked epoch at 1e-10; untracked, still
    one launch an epoch call."""
    from repro_torch.core import centralvr, convex
    from repro_torch.core import fused as tfused
    gen = torch.Generator(device=device).manual_seed(3)
    prob = convex.make_logistic_data(gen, 500, 20)
    eta = convex.auto_eta(prob)
    fp = tfused.make_params(True, eta, prob.lam, device)
    init, per = centralvr.draw_orders(gen, prob.n, 2)
    st = centralvr.init_state(prob, eta, init)
    for order in per:
        before = (vr_kernel.launches, vr_epoch.launches)
        fst, ftraj = centralvr.epoch(prob, st, eta, order,
                                     track_iterates=True, fused=fp)
        torch.cuda.synchronize()
        assert (vr_kernel.launches, vr_epoch.launches) == (before[0],
                                                           before[1] + 1)
        ust, utraj = centralvr.epoch(prob, st, eta, order,
                                     track_iterates=True)
        assert ftraj.shape == (prob.n, prob.d)
        assert torch.equal(ftraj[0], st.x)
        assert (ftraj - utraj).abs().max().item() <= 1e-10
        for h, w in zip(fst, ust):
            assert (h - w).abs().max().item() <= 1e-10
        before = vr_epoch.launches
        plain = centralvr.epoch(prob, st, eta, order, fused=fp)
        assert vr_epoch.launches == before + 1
        assert torch.equal(plain.x, fst.x)
        st = ust


@pytest.mark.parametrize("case", lazy_cases.CASES,
                         ids=lambda c: c.label.replace(" ", "-"))
def test_lazy_epoch_kernel_matches_plain(device, case):
    """chip_smoke.py's phase 5b (a) cases: one launch, every output within
    1e-10 of its largest magnitude, the inputs left as they were."""
    from repro_torch.kernels.lazy_epoch import kernel as lazy_kernel
    from repro_torch.kernels.lazy_epoch import ref as lazy_ref
    args, kw = lazy_cases.inputs(case, device)
    before = lazy_kernel.launches
    have = lazy_kernel.lazy_epoch(*args, **kw)
    torch.cuda.synchronize()
    assert lazy_kernel.launches == before + 1
    want = lazy_ref.lazy_epoch_ref(*args, **kw)
    for h, wt in zip(have, want):
        assert bool(torch.isfinite(h).all())
        assert (h - wt).abs().max().item() <= 1e-10 * wt.abs().max().item()
    assert torch.equal(args[4], lazy_cases.inputs(case, device)[0][4])


def test_sparse_route_launches_lazy_epoch_and_never_its_plain_version(
        device, monkeypatch):
    """sampling="sparse" on the card: one lazy_epoch launch an epoch call
    (init included), no vr_epoch, no K1, the plain version never called,
    and the dense fused route's answer within 1e-10."""
    import repro_torch
    from repro_torch.core import centralvr
    from repro_torch.kernels.lazy_epoch import kernel as lazy_kernel
    from repro_torch.kernels.lazy_epoch import ref as lazy_ref
    from repro_torch.prox import lazy

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the card")

    gen = torch.Generator(device=device).manual_seed(1)
    prob = lazy.make_sparse_data(gen, 300, 500, 6, kind="logistic")
    R = 4
    orders = centralvr.draw_orders(gen, prob.n, R)
    monkeypatch.setattr(lazy_ref, "lazy_epoch_ref", refuse)
    before = lazy_kernel.launches
    sparse = repro_torch.solve(repro_torch.RunSpec(
        "centralvr", rounds=R, sampling="sparse", prox="l1:1e-4"), prob,
        orders=orders)
    assert lazy_kernel.launches == before + R + 1
    assert sparse.launches == {"vr_update": 0, "vr_epoch": 0,
                               "lazy_epoch": R + 1}
    dense = repro_torch.solve(repro_torch.RunSpec(
        "centralvr", rounds=R, fused=True, prox="l1:1e-4"), prob,
        orders=orders)
    assert dense.launches == {"vr_update": 0, "vr_epoch": R + 1,
                              "lazy_epoch": 0}
    assert np.abs(sparse.x - dense.x).max() <= 1e-10
    assert np.abs(sparse.rels - dense.rels).max() <= 1e-10 * np.abs(
        dense.rels).max()
    assert sparse.rels[-1] < sparse.rels[0]


def test_sparse_route_raises_when_lazy_epoch_does_not_build(device,
                                                            monkeypatch,
                                                            tmp_path):
    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.kernels.lazy_epoch import kernel as lazy_kernel
    from repro_torch.prox import lazy

    bad = tmp_path / "lazy_epoch_broken.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(lazy_kernel, "SOURCE", bad)
    monkeypatch.setattr(lazy_kernel, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    prob = lazy.make_sparse_data(torch.Generator(device=device).manual_seed(2),
                                 40, 30, 3)
    before = lazy_kernel.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        repro_torch.solve(repro_torch.RunSpec("centralvr", rounds=1,
                                              sampling="sparse"), prob)
    assert lazy_kernel.launches == before


# ---------------------------------------------------------------------------
# K2 RMSNorm and K3 flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d,dtype,sdtype,offset", [
    (1024, 3584, torch.bfloat16, torch.bfloat16, 0),   # the slice's shape
    (1024, 3584, torch.float32, torch.float32, 0),
    (37, 3584, torch.bfloat16, torch.float32, 0),      # ragged rows, f32 scale
    (5, 128, torch.bfloat16, torch.bfloat16, 0),
    (8192, 768, torch.bfloat16, torch.bfloat16, 0),    # the Mamba2 step's
    (64, 1001, torch.bfloat16, torch.bfloat16, 0),     # width not 8k: the loop
    (16, 1024, torch.bfloat16, torch.bfloat16, 1),     # x off alignment: loop
    (4, 12272, torch.float32, torch.float32, 0),       # MAX_D: the loop
    (8, 4096, torch.float32, torch.bfloat16, 0),       # 8 warps a row
])
def test_rmsnorm_kernel_matches_plain(device, rows, d, dtype, sdtype,
                                      offset):
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    g = torch.Generator(device=device).manual_seed(0)
    # offset: x starts that many elements into its buffer
    x = torch.randn(rows * d + offset, generator=g, device=device).to(
        dtype)[offset:].view(rows, d)
    s = torch.randn(d, generator=g, device=device).to(sdtype)
    before = rms_kernel.launches
    y = rms_kernel.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rms_kernel.launches == before + 1
    want = rms_ref.rmsnorm_ref(x, s)
    # float32: summation order only; bf16: one rounding of the output
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (1, 1024, 28, 4, 128, None),    # the slice's shape
    (1, 1024, 28, 4, 128, 200),     # sliding window
    (2, 200, 4, 2, 32, None),       # S not a multiple of the block
    (1, 256, 4, 4, 64, None),       # H = KV, no grouping
    (1, 100, 4, 2, 32, 16),
    (2, 200, 28, 4, 128, None),     # B 2, ragged S: the batch boundary
    (2, 200, 28, 4, 64, None),      # under TMA's zero fill
    (1, 2048, 28, 4, 128, None),
    (1, 2048, 28, 4, 128, 200),     # a window at S 2048
])
def test_flash_kernel_matches_plain(device, B, S, H, KV, hd, window):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=device)
               .to(torch.bfloat16) for n in (H, KV, KV))
    before = fa_kernel.launches
    out = fa_kernel.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + 1
    want = fa_ref.flash_attention_ref(q, k, v, window=window)
    # bf16 output, float32 sums in another order: about one bf16 ulp
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_fused_step_raises_when_a_kernel_does_not_build(device,
                                                        monkeypatch,
                                                        tmp_path):
    """fused=True on the card launches the kernels or raises: a failed
    build is an error, never a fall back to the plain versions."""
    import dataclasses

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.train import step as tstep

    bad = tmp_path / "rmsnorm_broken.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(rms_kernel, "SOURCE", bad)
    monkeypatch.setattr(rms_kernel, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    cfg = get_arch("qwen2-7b").reduced()
    tcfg = TrainConfig(seq_len=64, global_batch=2, microbatch=1,
                       optimizer="sgd", learning_rate=0.1, vr="centralvr",
                       vr_table_size=2)
    run, meta = tstep.make_epoch_runner(cfg, tcfg, 1, fused=True,
                                        device=device)
    state = tstep.init_train_state(cfg, tcfg, 1, device=device)
    before = rms_kernel.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        run(state)
    assert rms_kernel.launches == before
    assert meta["fused"] is True and dataclasses.is_dataclass(state)


# ---------------------------------------------------------------------------
# K1's bfloat16 lane, K3 in float32 and at hd 256, K4 SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("old_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("saga", [False, True])
def test_vr_update_bf16_lane_matches_plain(device, saga, old_dtype):
    """bfloat16 state, float32 g (and g_old bf16, a table row, or float32,
    SVRG's snapshot gradient): float32 arithmetic in the same order as the
    plain version, each result rounded to bfloat16 once, so at most one
    bf16 ulp apart."""
    g = torch.Generator(device=device).manual_seed(3)
    shape = (2, 1 << 20)
    x, gbar, gtilde = (torch.randn(shape, generator=g, device=device)
                       .to(torch.bfloat16) for _ in range(3))
    gf = torch.randn(shape, generator=g, device=device)
    g_old = torch.randn(shape, generator=g, device=device).to(old_dtype)
    kw = dict(eta=0.1, m=2, saga=saga)
    want = vr_ref.vr_update_ref(x, gf, g_old, gbar, gtilde, **kw)
    before = vr_kernel.launches
    got = vr_kernel.vr_update(x, gf, g_old, gbar, gtilde, **kw)
    torch.cuda.synchronize()
    assert vr_kernel.launches == before + 1
    for w, h in zip(want, got):
        assert h.dtype == w.dtype
        tol = 2.0 ** -8 * w.float().abs().max().item()
        assert (h.float() - w.float()).abs().max().item() <= tol


@pytest.mark.parametrize("B,S,H,KV,hd,window,dtype", [
    (1, 1024, 28, 4, 128, None, torch.float32),   # the Qwen2 slice in f32
    (2, 200, 4, 2, 64, None, torch.float32),
    (1, 300, 4, 1, 256, 64, torch.float32),       # hd 256, window, ragged
    (1, 1024, 10, 1, 256, None, torch.bfloat16),  # recurrentgemma-2b's
    (1, 200, 4, 2, 256, 16, torch.bfloat16),
])
def test_flash_kernel_float32_and_hd256_match_plain(device, B, S, H, KV, hd,
                                                    window, dtype):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=device)
               .to(dtype) for n in (H, KV, KV))
    before = fa_kernel.launches
    out = fa_kernel.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + 1 and out.dtype == dtype
    want = fa_ref.flash_attention_ref(q, k, v, window=window)
    # float32: full float32 products, sums in another order; bf16: about
    # one bf16 ulp of the output
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def _ssd_inputs(device, B, S, H, P, N, seed=0, dt_min=0.0):
    """dt = dt_min + softplus(normal): dt_min 4 gives fast-decaying heads
    (la <= -4 h per step for head h, so exp(L) underflows in a chunk)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g, device=device)
    dt = dt_min + torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device=device))
    A_log = torch.arange(1, H + 1, device=device, dtype=torch.float32).log()
    Bc = torch.randn(B, S, N, generator=g, device=device)
    Cc = torch.randn(B, S, N, generator=g, device=device)
    return x, dt, A_log, Bc, Cc


def _ssd_plain(x, dt, A_log, Bc, Cc, chunk):
    """K4's flat plain version on the model-layout inputs."""
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    B, S, H, P = x.shape
    la = -torch.exp(A_log)[None, None, :] * dt
    return ssd_ref.ssd_scan_ref(
        la.transpose(1, 2).reshape(B * H, S),
        (x * dt[..., None]).transpose(1, 2).reshape(B * H, S, P), Bc, Cc,
        chunk=chunk).reshape(B, H, S, P).transpose(1, 2)


@pytest.mark.parametrize("B,S,H,P,N,chunk,dt_min", [
    (4, 2048, 24, 64, 128, 64, 0.0),    # Mamba2-130M's training shape
    (4, 2000, 24, 64, 128, 64, 0.0),    # S not a multiple of the chunk
    (4, 256, 16, 16, 16, 8, 0.0),       # mamba2-130m.reduced()
    (1, 40, 3, 40, 24, 16, 0.0),        # P not a multiple of the tile
    (2, 512, 24, 64, 128, 64, 4.0),     # fast-decaying heads: exp(L) -> 0
    (2, 512, 4, 64, 128, 32, 0.0),      # chunk 32
    (2, 64, 4, 64, 128, 64, 0.0),       # a single chunk
    (2, 40, 4, 64, 128, 64, 0.0),       # S below the chunk
    (1, 1024, 1, 64, 128, 64, 0.0),     # B 1, H 1: one chain of chunks
    (1, 256, 2, 128, 64, 64, 0.0),      # P 128: two tiles of columns
])
def test_ssd_scan_kernel_matches_plain(device, B, S, H, P, N, chunk, dt_min):
    """The model-layout entry (the block's) against the flat plain
    version on the same inputs, within the reference's kernel tolerance
    (tests/test_kernels.py)."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    x, dt, A_log, Bc, Cc = _ssd_inputs(device, B, S, H, P, N, dt_min=dt_min)
    before = ssd_kernel.launches
    y = ssd_kernel.ssd_scan(x, dt, A_log, Bc, Cc, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1
    want = _ssd_plain(x, dt, A_log, Bc, Cc, chunk)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    la = -torch.exp(A_log)[None, None, :] * dt
    flat = ssd_kernel.ssd_scan_flat(
        la.transpose(1, 2).reshape(B * H, S).contiguous(),
        (x * dt[..., None]).transpose(1, 2).reshape(B * H, S, P)
        .contiguous(), Bc, Cc, chunk=chunk)
    torch.testing.assert_close(flat.reshape(B, H, S, P).transpose(1, 2), y,
                               rtol=1e-5, atol=1e-5)


def test_ssd_scan_in_a_cuda_graph_matches_plain_on_every_replay(device):
    """ssd_scan captured in a CUDA graph, replayed twice on changed inputs:
    the graph replays the zeroing of the look-back ticket and flags, so
    each replay agrees with the plain version on its own inputs."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, P, N, chunk = 2, 512, 24, 64, 128, 64
    static = _ssd_inputs(device, B, S, H, P, N, seed=7)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd_kernel.ssd_scan(*static, chunk=chunk)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ssd_kernel.ssd_scan(*static, chunk=chunk)
    for seed in (8, 9):
        fresh = _ssd_inputs(device, B, S, H, P, N, seed=seed,
                            dt_min=4.0 if seed == 9 else 0.0)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        before = ssd_kernel.launches
        graph.replay()
        torch.cuda.synchronize()
        assert ssd_kernel.launches == before     # a replay calls no wrapper
        torch.testing.assert_close(out, _ssd_plain(*fresh, chunk),
                                   rtol=1e-4, atol=1e-4)


def test_fused_mamba2_step_launches_k4_and_matches_unfused(device):
    """mamba2-130m.reduced() on the card: one fused epoch launches K4
    (L + L) * A * W times per step and agrees with the unfused epoch."""
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.train import step as tstep
    cfg = get_arch("mamba2-130m").reduced()
    tcfg = TrainConfig(seq_len=64, global_batch=4, microbatch=1,
                       optimizer="sgd", learning_rate=0.1, vr="centralvr",
                       vr_table_size=2)
    losses = {}
    for fused in (True, False):
        run, meta = tstep.make_epoch_runner(cfg, tcfg, 2, fused=fused,
                                            device=device)
        state = tstep.init_train_state(cfg, tcfg, 2, device=device)
        before = ssd_kernel.launches
        state, losses[fused] = run(state)
        torch.cuda.synchronize()
        launched = ssd_kernel.launches - before
        assert launched == (2 * 2 * cfg.num_layers * meta["accum"] * 2
                            if fused else 0)
    torch.testing.assert_close(losses[True], losses[False], rtol=2.0 ** -7,
                               atol=0)


@pytest.mark.parametrize("dtype,param_dtype", [("float32", "float32"),
                                               ("bfloat16", "bfloat16")])
def test_fused_lm_epoch_in_float32_and_with_bf16_masters(device, dtype,
                                                         param_dtype):
    """qwen2-7b.reduced() on the card with float32 compute (K3's float32
    path inside the trainer), and with bfloat16 masters (K1's bfloat16
    lane): one fused epoch launches every kernel and agrees with the
    unfused epoch."""
    import dataclasses

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.train import step as tstep
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("qwen2-7b").reduced(), dtype=dtype,
                              param_dtype=param_dtype)
    tcfg = TrainConfig(seq_len=64, global_batch=2, microbatch=1,
                       optimizer="sgd", learning_rate=0.1, vr="centralvr",
                       vr_table_size=2)
    out = {}
    for fused in (True, False):
        run, _ = tstep.make_epoch_runner(cfg, tcfg, 1, fused=fused,
                                         device=device)
        state = tstep.init_train_state(cfg, tcfg, 1, device=device)
        before = (vr_kernel.launches, fa_kernel.launches)
        state, losses = run(state)
        torch.cuda.synchronize()
        launched = (vr_kernel.launches - before[0],
                    fa_kernel.launches - before[1])
        assert launched == ((2, 16) if fused else (0, 0))
        assert state.params.dtype == getattr(torch, param_dtype)
        assert state.grad.dtype == torch.float32
        out[fused] = (losses, state.params.float())
    # float32: the kernels' float32 sums in another order; bf16: two bf16
    # ulps (bf16 compute, and bf16 rounding flips of the masters)
    if dtype == "float32":
        torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-5,
                                   atol=0)
        torch.testing.assert_close(out[True][1], out[False][1], rtol=1e-4,
                                   atol=1e-5)
    else:
        torch.testing.assert_close(out[True][0], out[False][0],
                                   rtol=2.0 ** -7, atol=0)
        diff = (out[True][1] - out[False][1]).norm()
        assert diff <= 2.0 ** -7 * out[False][1].norm()
