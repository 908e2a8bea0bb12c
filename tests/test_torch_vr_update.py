"""K1 (fused VR update) of the PyTorch port against the JAX reference.

The port's wrapper runs the kernel's plain version for CPU tensors; here
it is held, on the same seeded numpy inputs, against the reference's
oracle ``vr_update_ref`` composed with ``prox.operators.apply`` (the
reference oracle takes no prox) and against the Pallas kernel itself in
interpret mode. The CUDA kernel against the plain version on the card is
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vr_update import kernel as jax_kernel
from repro.kernels.vr_update import ref as jax_ref
from repro.prox import operators as jax_prox
from repro_torch.kernels.vr_update import kernel as vr_kernel
from repro_torch.kernels.vr_update import ref as vr_ref
from repro_torch.prox import operators as proxops

torch.set_num_threads(1)

# float64 elementwise arithmetic in the same order: a few ulps
TOL = 1e-12
PROXES = [None, "l1:0.05", "elasticnet:0.05:0.3", "box:-0.2:0.3"]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(5)]


def _port(arrays, **kw):
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    prox = kw.pop("prox")
    return vr_kernel.vr_update(*ts, prox=proxops.parse(prox) if prox
                               else None, **kw)


@pytest.mark.parametrize("prox", PROXES)
@pytest.mark.parametrize("decay", [0.0, 2e-4])
@pytest.mark.parametrize("saga", [False, True])
def test_plain_matches_reference_oracle(saga, decay, prox):
    arrays = _inputs((2, 13))
    kw = dict(eta=0.7, m=13, saga=saga, decay=decay)
    xo, tbl, gto, gbo = jax_ref.vr_update_ref(*map(jnp.asarray, arrays),
                                              **kw)
    if prox is not None:
        xo = jax_prox.apply(prox, xo, kw["eta"])
    got = _port(arrays, prox=prox, **kw)
    for want, have in zip((xo, tbl, gto, gbo), got):
        np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("prox", PROXES)
def test_plain_matches_pallas_interpret(prox):
    """The Pallas kernel (interpret mode) on a flat tile-multiple input:
    same epilogue constants, same products (g*inv_m)."""
    arrays = _inputs((jax_kernel.TILE,), seed=1)
    kw = dict(eta=0.3, m=37, saga=True, decay=2e-4)
    want = jax_kernel.vr_update_flat(
        *map(jnp.asarray, arrays), prox=jax_prox.parse(prox) if prox
        else None, interpret=True, **kw)
    got = _port(arrays, prox=prox, **kw)
    for w, h in zip(want, got):
        np.testing.assert_allclose(h.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("saga", [False, True])
def test_inplace_matches_out_of_place(saga):
    arrays = _inputs((3, 7), seed=2)
    kw = dict(eta=0.1, m=7, saga=saga, decay=1e-3, prox="l1:0.01")
    want = _port(arrays, **kw)
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    kw["prox"] = proxops.parse(kw["prox"])
    got = vr_kernel.vr_update(*ts, inplace=True, **kw)
    assert got[0] is ts[0] and got[1] is ts[1] and got[2] is ts[4]
    assert got[3] is ts[3]
    for w, h in zip(want, got):
        torch.testing.assert_close(h, w, rtol=0, atol=0)


def test_cpu_tensors_run_the_plain_version_uncounted():
    before = vr_kernel.launches
    _port(_inputs((1, 5)), eta=0.1, m=5, prox=None)
    assert vr_kernel.launches == before


@pytest.mark.parametrize("bad,err", [
    ("dtype", TypeError), ("int", TypeError), ("shape", ValueError),
    ("strided", ValueError), ("device", ValueError),
])
def test_wrapper_refuses_bad_operands(bad, err):
    ts = [torch.zeros(2, 6, dtype=torch.float64) for _ in range(5)]
    if bad == "dtype":
        ts[2] = ts[2].float()
    elif bad == "int":
        ts = [t.long() for t in ts]
    elif bad == "shape":
        ts[3] = torch.zeros(2, 5, dtype=torch.float64)
    elif bad == "strided":
        ts[1] = torch.zeros(6, 2, dtype=torch.float64).T
    elif bad == "device":
        ts = [t.to("meta") for t in ts]
    with pytest.raises(err):
        vr_kernel.vr_update(*ts, eta=0.1, m=6)


def test_non_elementwise_prox_cannot_fuse():
    with pytest.raises(ValueError, match="non-elementwise"):
        vr_ref.epilogue_constants(proxops.parse("group_l2:0.1:2"), 0.5)


def test_kernel_source_names_its_tpu_kernel_and_target():
    src = vr_kernel.SOURCE.read_text()
    assert "src/repro/kernels/vr_update/kernel.py" in src
    assert "_vr_update_kernel" in src
    assert "compute_90a,code=sm_90a" in " ".join(vr_kernel.NVCC_FLAGS)
    assert 'extern "C"' in src and "torch/extension.h" not in src
