"""Tests of the PyTorch port that need an NVIDIA card: the hand-written
kernels against their plain versions, on the card.

Run them on a machine with a Hopper card (this file imports no jax, and
``--noconftest`` skips the suite's jax set-up):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips.
"""
import numpy as np
import pytest
import torch

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
