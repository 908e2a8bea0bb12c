"""The Mamba2 slice of the PyTorch port against the JAX reference: K4 (the
SSD chunk scan) in its plain version, the chunked and naive SSD forms, the
SSM block, the params conversion, Mamba2-130M's config, and
``mamba2-130m.reduced()`` training through ``make_epoch_runner`` for every
vr mode, W in {1, 2}, fused and unfused.

Everything runs on the CPU with inputs made from a seed with numpy, or
with the reference's params and tokens fed to the port. On the CPU the K4
wrapper runs its plain version; ``test_torch_cuda.py`` holds the CUDA
kernel against it on the card.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch
from repro.kernels.ssd_scan import ops as jssd_ops
from repro.kernels.ssd_scan import ref as jssd_ref
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.config import TrainConfig, get_arch
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.vr_update import kernel as vr_kernel
from repro_torch.launch import train as launch_train
from repro_torch.models import kernel_ctx, model, ssm
from repro_torch.train import step as tstep

from torch_lm_common import (LM_TOL, assert_trees_close, cfgs, port_run,
                             reference_run, train_kw)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCH = "mamba2-130m"


def _inputs(seed, B, S, H, P, N, h0=False, a_log="arange"):
    """x, dt (softplus of a normal), A_log, Bc, Cc [, h0] as float32 numpy
    arrays, the reference's test distributions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A_log = (np.log(np.arange(1, H + 1)) if a_log == "arange"
             else np.zeros(H)).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    out = [x, dt, A_log, Bc, Cc]
    if h0:
        out.append(rng.standard_normal((B, H, P, N)).astype(np.float32))
    return out


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# K4: the SSD chunk scan, plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("B,S,H,P,N", [(2, 32, 3, 8, 16), (1, 24, 2, 4, 8)])
def test_ssd_scan_plain_matches_reference_kernel(chunk, B, S, H, P, N):
    """The model-layout entry on CPU tensors (K4's plain version) against
    the reference's Pallas kernel in interpret mode, at the shapes of
    tests/test_kernels.py and within its tolerance."""
    ins = _inputs(0, B, S, H, P, N)
    want = jssd_ops.ssd_scan(*_j(ins), chunk=chunk, interpret=True)
    before = ssd_kernel.launches
    got = ssd_kernel.ssd_scan(*_t(ins), chunk=chunk)
    assert ssd_kernel.launches == before        # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("S", [9, 13, 17, 23, 31, 40])
def test_ssd_scan_plain_matches_reference_kernel_ragged(S):
    """S not a multiple of the chunk: the padded tail is inert."""
    ins = _inputs(S, 1, S, 2, 4, 8, a_log="zeros")
    want = jssd_ops.ssd_scan(*_j(ins), chunk=8, interpret=True)
    got = ssd_kernel.ssd_scan(*_t(ins), chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_ssd_scan_flat_plain_matches_reference_oracle():
    """The flat signature (la (BH, S), x (BH, S, P), B/C shared by the H
    heads of a row) against the reference's ``ssd_scan_ref``."""
    rng = np.random.default_rng(3)
    B, H, S, P, N = 2, 3, 32, 8, 16
    la = -np.logaddexp(rng.standard_normal((B * H, S)), 0).astype(np.float32)
    x = rng.standard_normal((B * H, S, P)).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    want = jssd_ref.ssd_scan_ref(*_j([la, x, Bc, Cc]), chunk=8)
    got = ssd_kernel.ssd_scan_flat(*_t([la, x, Bc, Cc]), chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # the model-layout entry is the flat one after ops.py's transposes
    ins = _inputs(4, B, S, H, P, N)
    x4, dt, A_log, Bm, Cm = _t(ins)
    la4 = (-torch.exp(A_log)[None, None, :] * dt).transpose(1, 2)
    xf = (x4 * dt[..., None]).transpose(1, 2)
    flat = ssd_ref.ssd_scan_ref(la4.reshape(B * H, S),
                                xf.reshape(B * H, S, P), Bm, Cm, chunk=8)
    torch.testing.assert_close(
        ssd_kernel.ssd_scan(x4, dt, A_log, Bm, Cm, chunk=8),
        flat.reshape(B, H, S, P).transpose(1, 2), rtol=0, atol=0)


def test_ssd_scan_wrapper_checks_its_operands():
    x, dt, A_log, Bc, Cc = _t(_inputs(0, 1, 16, 2, 4, 8))
    with pytest.raises(ValueError, match=r"x must be \(B, S, H, P\)"):
        ssd_kernel.ssd_scan(x, dt[:, :8], A_log, Bc, Cc)
    with pytest.raises(ValueError, match="shapes do not agree"):
        ssd_kernel.ssd_scan_flat(torch.zeros(3, 16), torch.zeros(3, 16, 4),
                                 torch.zeros(2, 16, 8), torch.zeros(2, 16, 8),
                                 chunk=8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ssd_kernel.ssd_scan(*(t.to("meta") for t in (x, dt, A_log, Bc, Cc)))
    with pytest.raises(ValueError, match="chunk 128"):
        ssd_kernel.check_supported(128, 64, 64)
    with pytest.raises(ValueError, match="state size 256"):
        ssd_kernel.check_supported(64, 256, 64)
    with pytest.raises(ValueError, match="state size 18"):
        ssd_kernel.check_supported(64, 18, 64)
    with pytest.raises(ValueError, match="head size 6"):
        ssd_kernel.check_supported(64, 128, 6)
    ssd_kernel.check_supported(64, 128, 64)
    cfg = get_arch(ARCH)
    tstep._check_kernel_shapes(cfg)
    with pytest.raises(ValueError, match="chunk 128"):
        tstep._check_kernel_shapes(dataclasses.replace(cfg, ssm_chunk=128))


def _tf32_rna(a):
    """Round a float32 tensor's mantissa to TF32's 10 bits, to nearest
    with ties away from zero (cvt.rna.tf32.f32 on finite values)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel forms it: each operand split into hi =
    rna(v) and lo = rna(v - hi), the sum hi lo + lo hi + hi hi (each
    product of two TF32 values is exact in float32)."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def _mm_1xtf32(a, b):
    """a @ b in a single pass of TF32: both operands rounded once."""
    return _tf32_rna(a) @ _tf32_rna(b)


def _ssd_scan_products(la, x, Bc, Cc, chunk, mm):
    """The plain version (ref.ssd_scan_ref) with every product of a chunk
    (C B^T, w x, C h^T, x^T (B * d)) taken by ``mm``."""
    BH, S = la.shape
    H = BH // Bc.shape[0]
    rows = torch.arange(BH) // H
    Bm, Cm = Bc[rows], Cc[rows]
    Q, P, N = chunk, x.shape[-1], Bm.shape[-1]
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    h = torch.zeros(BH, P, N)
    ys = []
    for c0 in range(0, S, Q):
        sl = slice(c0, c0 + Q)
        L = torch.cumsum(la[:, sl].double(), -1).float()
        Bq, Cq, xq = Bm[:, sl], Cm[:, sl], x[:, sl]
        decay = torch.exp(torch.clamp(L[:, :, None] - L[:, None, :],
                                      max=0.0))
        w = torch.where(causal, mm(Cq, Bq.transpose(1, 2)) * decay, 0.0)
        ys.append(mm(w, xq) + torch.exp(L)[..., None]
                  * mm(Cq, h.transpose(1, 2)))
        tot = L[:, -1:]
        h = (h * torch.exp(tot)[..., None]
             + mm(xq.transpose(1, 2), Bq * torch.exp(tot - L)[..., None]))
    return torch.cat(ys, 1)


def _flat_inputs(seed, B, S, heads, P, N, dt_min):
    """Flat la (B*H, S), x (B*H, S, P), Bc, Cc (B, S, N) as the model forms
    them, for the given A = -heads: dt = dt_min + softplus(normal)."""
    rng = np.random.default_rng(seed)
    H = len(heads)
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    dt = torch.from_numpy((dt_min + np.logaddexp(
        rng.standard_normal((B, S, H)), 0)).astype(np.float32))
    la = -torch.tensor(heads, dtype=torch.float32)[None, None, :] * dt
    xdt = x * dt[..., None]
    Bc = torch.from_numpy(rng.standard_normal((B, S, N)).astype(np.float32))
    Cc = torch.from_numpy(rng.standard_normal((B, S, N)).astype(np.float32))
    return (la.transpose(1, 2).reshape(B * H, S),
            xdt.transpose(1, 2).reshape(B * H, S, P), Bc, Cc)


@pytest.mark.parametrize("B,S,heads,P,N,chunk,dt_min", [
    (2, 64, (1, 6, 11, 16), 16, 16, 8, 0.0),         # the reduced config
    (1, 256, (1, 8, 16, 24), 64, 128, 64, 0.0),      # a full-width slice
    (1, 256, (1, 8, 16, 24), 64, 128, 64, 4.0),      # with fast heads
])
def test_ssd_3xtf32_products_hold_the_tolerance_and_one_pass_does_not(
        B, S, heads, P, N, chunk, dt_min):
    """K4's arithmetic, emulated: with every chunk product in 3xTF32 the
    scan stays within the kernel tolerance (1e-4 abs + rel) of the
    float32 plain version, at the reduced shape and at Mamba2-130M's widths
    (heads up to A = -24, fast ones with dt >= 4); with one pass of TF32 it
    does not, so the tolerance tells the two apart."""
    la, x, Bc, Cc = _flat_inputs(11, B, S, heads, P, N, dt_min)
    want = ssd_ref.ssd_scan_ref(la, x, Bc, Cc, chunk=chunk)
    plain = _ssd_scan_products(la, x, Bc, Cc, chunk, torch.matmul)
    torch.testing.assert_close(plain, want, rtol=1e-6, atol=1e-5)
    three = _ssd_scan_products(la, x, Bc, Cc, chunk, _mm_3xtf32)
    one = _ssd_scan_products(la, x, Bc, Cc, chunk, _mm_1xtf32)

    def excess(got):
        return ((got - want).abs() - 1e-4 * (1 + want.abs())).max().item()
    assert torch.isfinite(three).all()
    assert excess(three) <= 0
    assert excess(one) > 0


def test_tf32_rounding_is_nearest_with_ties_away():
    a = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -11 - 2 ** -20, 0.0,
                      1e-40], dtype=torch.float32)
    got = _tf32_rna(a)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 1.0, 0.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(got[:6], want[:6])
    assert got[6].item() == pytest.approx(1e-40, rel=2 ** -10)
    # hi + lo keeps 22 of a normal float's 24 bits: lo is rounded too
    normal = a[:6]
    hi = _tf32_rna(normal)
    lo = _tf32_rna(normal - hi)
    assert ((hi + lo - normal).abs() <= 2 ** -22 * normal.abs()).all()
    assert ((hi - normal).abs() > 2 ** -12 * normal.abs()).any()


@pytest.mark.parametrize("B,S,H,P,N,chunk,want", [
    # Mamba2-130M's training shape: 4 groups of 6 heads, 32 chunks
    (4, 2048, 24, 64, 128, 64, (32, 6, 4, 1, 512, 31 * 96, 2 * 96 * 8192)),
    (4, 2000, 24, 64, 128, 64, (32, 6, 4, 1, 512, 31 * 96, 2 * 96 * 8192)),
    # mamba2-130m.reduced(): 16 heads as 6, 6, 4
    (4, 256, 16, 16, 16, 8, (32, 6, 3, 1, 384, 31 * 64, 2 * 64 * 256)),
    (1, 40, 3, 40, 24, 16, (3, 3, 1, 1, 3, 2 * 3, 2 * 3 * 960)),
    (2, 512, 4, 64, 128, 32, (16, 4, 1, 1, 32, 15 * 8, 2 * 8 * 8192)),
    (2, 128, 4, 64, 128, 64, (2, 4, 1, 1, 4, 8, 8 * 8192)),  # one slot
    (2, 64, 4, 64, 128, 64, (1, 4, 1, 1, 2, 0, 0)),          # one chunk
    (2, 40, 4, 64, 128, 64, (1, 4, 1, 1, 2, 0, 0)),          # S < chunk
    (1, 1024, 1, 64, 128, 64, (16, 1, 1, 1, 16, 15, 2 * 8192)),
    (1, 256, 7, 128, 16, 64, (4, 4, 2, 2, 16, 3 * 14, 2 * 7 * 2048)),
    (1, 256, 13, 68, 16, 64, (4, 5, 3, 2, 24, 3 * 26, 2 * 13 * 1088)),
])
def test_ssd_launch_plan_pins_every_branch(B, S, H, P, N, chunk, want):
    """The grid and scratch of K4's launch: chunks, heads per block, head
    groups, P tiles, blocks, look-back flags, state floats (two slots of
    (B, H, P, N) from three chunks on, one with two, none with one)."""
    plan = ssd_kernel.launch_plan(B, S, H, P, N, chunk)
    assert tuple(plan[k] for k in ("chunks", "heads_per_block",
                                   "head_groups", "p_tiles", "blocks",
                                   "flags", "state_floats")) == want
    # the groups cover every head, and none is empty
    hpb, groups = plan["heads_per_block"], plan["head_groups"]
    assert hpb <= ssd_kernel.HEADS_PER_BLOCK
    assert (groups - 1) * hpb < H <= groups * hpb


def test_ssd_source_constants_match_the_wrapper():
    """The wrapper's limits and P tile are the kernel source's."""
    import re
    src = ssd_kernel.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kPT") == ssd_kernel.P_TILE
    assert const("kMaxQ") == ssd_kernel.MAX_CHUNK
    assert const("kMaxN") == ssd_kernel.MAX_STATE
    # the kernel derives the plan's groups and tiles as launch_plan does
    assert "G = (H + hpb - 1) / hpb" in src
    assert "PT = (P + kPT - 1) / kPT" in src


def test_kernels_package_exports_the_model_layout_entry():
    from repro_torch import kernels
    assert kernels.__getattr__("ssd_scan") is ssd_kernel.ssd_scan
    with pytest.raises(AttributeError):
        kernels.__getattr__("no_such_kernel")


# ---------------------------------------------------------------------------
# the chunked and naive SSD forms, and the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nonzero_h0", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_reference(chunk, nonzero_h0):
    """Every chunk's dual form at once and one decay product between
    chunks, against the reference's scan over chunks (S = 37: ragged)."""
    ins = _inputs(5, 2, 37, 3, 8, 16, h0=True)
    if not nonzero_h0:
        ins[-1] = np.zeros_like(ins[-1])
    y_want, h_want = jssm._ssd_chunked(*_j(ins), chunk)
    y, h = ssm._ssd_chunked(*_t(ins), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("nonzero_h0", [False, True])
def test_ssd_naive_matches_reference_and_the_chunked_form(nonzero_h0):
    ins = _inputs(6, 2, 24, 3, 4, 8, h0=True)
    if not nonzero_h0:
        ins[-1] = np.zeros_like(ins[-1])
    y_want, h_want = jssm.ssd_naive(*_j(ins))
    y, h = ssm.ssd_naive(*_t(ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=1e-5,
                               rtol=1e-5)
    y_c, h_c = ssm._ssd_chunked(*_t(ins), 8)
    np.testing.assert_allclose(y_c.numpy(), y.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h_c.numpy(), h.numpy(), atol=1e-4, rtol=1e-4)


def test_segsum_decay_masks_before_the_exp():
    """Large log-decays: no inf or nan reaches the state or its gradient
    (the upper triangle is masked before the exp, as the reference masks
    min(L_i - L_j, 0))."""
    ins = _t(_inputs(7, 1, 32, 2, 4, 8, h0=True))
    ins[2] = torch.tensor([6.0, 8.0])          # a = -exp(A_log): -403, -2981
    ins = [t.requires_grad_() for t in ins]
    y, h = ssm._ssd_chunked(*ins, 8)
    (y.sum() + h.sum()).backward()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert all(torch.isfinite(t.grad).all() for t in ins)


def _block_params(cfg_dtype="float32"):
    jcfg, cfg = cfgs(dtype=cfg_dtype, arch=ARCH)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params


@pytest.mark.parametrize("fused", [False, True])
def test_apply_ssm_train_matches_reference(fused):
    """One SSM block (params from ``convert``), forward and gradients,
    against the reference's; fused, the scan is K4's plain version with
    the chunked form's autograd."""
    jcfg, cfg, params = _block_params()
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                params["layers"]["stack"][0]["mixer"])
    u = np.random.default_rng(8).standard_normal((2, 20, cfg.d_model))
    u = u.astype(np.float32)
    want, jgrads = jax.value_and_grad(
        lambda p, u: jssm.apply_ssm_train(p, jcfg, u).sum(), (0, 1))(
        jp, jnp.asarray(u))
    tp = convert.lm_params_from_jax(params, cfg)["layers"][0]["mixer"]
    tp = model.tree_map(lambda t: t.requires_grad_(), tp)
    tu = torch.from_numpy(u).requires_grad_()
    before = ssd_kernel.launches
    with kernel_ctx.scope(fused):
        y = ssm.apply_ssm_train(tp, cfg, tu)
        y.sum().backward()
    assert ssd_kernel.launches == before
    np.testing.assert_allclose(y.sum().item(), float(want), **LM_TOL)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(jgrads[1]),
                               rtol=LM_TOL["rtol"],
                               atol=LM_TOL["rtol"] * np.abs(jgrads[1]).max())
    for k in tp:
        g = np.asarray(jgrads[0][k])
        np.testing.assert_allclose(tp[k].grad.numpy(), g, rtol=LM_TOL["rtol"],
                                   atol=LM_TOL["rtol"] * np.abs(g).max())


@pytest.mark.parametrize("remat", ["none", "block", "dots"])
def test_mamba2_loss_and_grads_match_reference(remat):
    jcfg, cfg, params = _block_params()
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0,
                              jcfg.vocab_size)
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {"tokens": toks},
                                 remat=remat))(params)
    tree = model.tree_map(lambda t: t.requires_grad_(),
                          convert.lm_params_from_jax(params, cfg))
    got = model.loss_fn(tree, cfg, {"tokens": convert.tokens_from_jax(toks)},
                        remat=remat)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), **LM_TOL)

    def check(a, b):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=LM_TOL["rtol"],
                                   atol=LM_TOL["rtol"] * np.abs(b).max())
    model.tree_zip(check, model.tree_map(lambda t: t.grad, tree),
                   convert.lm_params_from_jax(grads, cfg))


def test_mamba2_bf16_loss_matches_reference():
    """bfloat16 compute (A_log, D and dt_bias cast too, as the reference
    casts every float leaf): the loss agrees to a bf16 ulp."""
    jcfg, cfg, params = _block_params("bfloat16")
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0,
                              jcfg.vocab_size)
    want = jmodel.loss_fn(params, jcfg, {"tokens": toks})
    got = model.loss_fn(convert.lm_params_from_jax(params, cfg), cfg,
                        {"tokens": convert.tokens_from_jax(toks)})
    np.testing.assert_allclose(got.item(), float(want), rtol=4e-3)


# ---------------------------------------------------------------------------
# config, params, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_the_reference_config(reduced):
    ref, port = jget_arch(ARCH), get_arch(ARCH)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.layer_kinds() == ref.layer_kinds() == ("ssm",) * \
        port.num_layers


def test_param_layout_holds_the_reference_leaves():
    """The layout's leaves are the reference's ``init_params`` leaves, in
    number and size: 128,983,488 at full width. ``param_count()`` (the
    reference's formula, kept as it is) counts a second norm per block and
    no conv bias for ssm blocks, 1,024 fewer per layer."""
    full = model.ParamLayout(get_arch(ARCH))
    assert full.n == 128_983_488
    assert get_arch(ARCH).param_count() == full.n - 24 * 1024
    jcfg, cfg, params = _block_params()
    leaves = jax.tree_util.tree_leaves(params)
    assert model.ParamLayout(cfg).n == sum(np.asarray(a).size
                                           for a in leaves)


def test_lm_params_from_jax_carries_the_ssm_blocks():
    jcfg, cfg, params = _block_params()
    tree = convert.lm_params_from_jax(params, cfg)
    stack = params["layers"]["stack"][0]["mixer"]
    assert len(tree["layers"]) == cfg.num_layers
    for i, layer in enumerate(tree["layers"]):
        assert set(layer) == {"norm1", "mixer"}
        for k, t in layer["mixer"].items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(stack[k][i]))
        for k in ("A_log", "D", "dt_bias"):
            assert layer["mixer"][k].dtype == torch.float32
    np.testing.assert_allclose(tree["layers"][0]["mixer"]["A_log"].numpy(),
                               np.log(np.arange(1, 17)), rtol=1e-6)
    layout = model.ParamLayout(cfg)
    flat = layout.load_(torch.empty(layout.n), tree)
    model.tree_zip(lambda a, b: np.testing.assert_array_equal(
        a.numpy(), b.numpy()), layout.views(flat), tree)


def test_init_params_draws_the_reference_kinds():
    """The port's own init: A_log = log(1..H), D = 1, dt_bias = 0, conv_b
    = 0, norm = 1, conv_w ~ N(0, 0.1^2), dense weights ~ N(0, 1/fan_in)."""
    cfg = get_arch(ARCH).reduced()
    layout = model.ParamLayout(cfg)
    tree = layout.views(layout.init_(torch.empty(layout.n),
                                     torch.Generator().manual_seed(0)))
    mix = tree["layers"][1]["mixer"]
    H = ssm.dims(cfg)[1]
    torch.testing.assert_close(mix["A_log"],
                               torch.arange(1, H + 1.0).log())
    assert torch.all(mix["D"] == 1) and torch.all(mix["dt_bias"] == 0)
    assert torch.all(mix["conv_b"] == 0) and torch.all(mix["norm"] == 1)
    assert abs(mix["conv_w"].std().item() - 0.1) < 0.02
    assert abs(mix["in_proj"].std().item() * cfg.d_model ** 0.5 - 1) < 0.05
    assert "head" in tree and tree["head"] == {}       # tied embeddings


def test_bf16_masters_round_the_reference_f32_leaves():
    """With param_dtype="bfloat16" the reference keeps A_log, D and
    dt_bias in float32; the port's flat master buffer has one dtype, so
    they are bfloat16 there: D = 1 and dt_bias = 0 exactly, A_log =
    log(1..H) rounded to bfloat16 (at most 2**-8 relative). That is the
    one difference, and the loss moves by less than a bf16 ulp."""
    jcfg, cfg = cfgs(arch=ARCH, param_dtype="bfloat16")
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jmix = params["layers"]["stack"][0]["mixer"]
    assert jmix["A_log"].dtype == jnp.float32
    assert jmix["in_proj"].dtype == jnp.bfloat16
    layout = model.ParamLayout(cfg)
    flat = layout.load_(torch.empty(layout.n, dtype=torch.bfloat16),
                        convert.lm_params_from_jax(params, cfg))
    tree = layout.views(flat)
    a_log = tree["layers"][0]["mixer"]["A_log"]
    want = np.asarray(jmix["A_log"][0])
    assert a_log.dtype == torch.bfloat16
    err = np.abs(a_log.float().numpy() - want)
    assert err.max() > 0 and np.all(err <= 2.0 ** -8 * np.abs(want))
    assert torch.all(tree["layers"][0]["mixer"]["D"] == 1)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0,
                              jcfg.vocab_size)
    want_loss = jmodel.loss_fn(params, jcfg, {"tokens": toks})
    got = model.loss_fn(tree, cfg, {"tokens": convert.tokens_from_jax(toks)})
    np.testing.assert_allclose(got.item(), float(want_loss), rtol=2.0 ** -8)


# ---------------------------------------------------------------------------
# training through the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("vr", ["centralvr", "svrg", "saga"])
def test_epoch_runner_matches_reference(vr, W, fused):
    """Two epochs of ``mamba2-130m.reduced()`` on the reference's params
    and tokens against the reference's unfused runner (which scans with
    ``_ssd_chunked``); with fused=True the K1/K2/K4 plain versions run on
    these CPU tensors and launch nothing."""
    _, cfg = cfgs(arch=ARCH)
    p0, toks, want_losses, want_params = reference_run(vr, W, False,
                                                       arch=ARCH)
    before = (vr_kernel.launches, rms_kernel.launches, ssd_kernel.launches)
    state, losses, meta = port_run(vr, W, fused, p0, toks, arch=ARCH)
    assert (vr_kernel.launches, rms_kernel.launches,
            ssd_kernel.launches) == before
    assert meta["fused"] is fused
    np.testing.assert_allclose(losses, want_losses, **LM_TOL)
    for w in range(W):
        assert_trees_close(state.param_tree(w),
                           convert.lm_params_from_jax(want_params[w], cfg),
                           **LM_TOL)
    if W > 1:
        torch.testing.assert_close(state.params[0], state.params[1],
                                   rtol=0, atol=0)


def test_fused_epoch_runner_matches_reference_fused():
    """fused=True against the reference's fused runner (its K1 and K2 in
    Pallas interpret mode; it scans with ``_ssd_chunked``, the port with
    K4's plain version) at W = 2."""
    _, cfg = cfgs(arch=ARCH)
    p0, toks, want_losses, want_params = reference_run("centralvr", 2, True,
                                                       arch=ARCH)
    state, losses, _ = port_run("centralvr", 2, True, p0, toks, arch=ARCH)
    np.testing.assert_allclose(losses, want_losses, **LM_TOL)
    for w in range(2):
        assert_trees_close(state.param_tree(w),
                           convert.lm_params_from_jax(want_params[w], cfg),
                           **LM_TOL)


def test_fused_step_calls_each_kernel_as_the_chip_run_counts(monkeypatch):
    """Per step with fused=True and remat="block" (L layers, A
    microbatches, W workers): K2 (L + 1 + L) * A * W times (norm1 of each
    block, the final norm, and norm1 again in each block's recompute),
    K4 (L + L) * A * W, K3 never, K1 once — the counts chip_smoke.py holds
    the card to. Counted here at the wrappers, which run their plain
    versions."""
    calls = {"rmsnorm": 0, "flash_attention": 0, "ssd_scan": 0,
             "vr_update": 0}

    def counting(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapper)
    for module, name in ((rms_kernel, "rmsnorm"),
                         (fa_kernel, "flash_attention"),
                         (ssd_kernel, "ssd_scan"),
                         (vr_kernel, "vr_update")):
        counting(module, name)
    _, cfg = cfgs(arch=ARCH)
    W = 2
    tcfg = TrainConfig(**dict(train_kw("centralvr", W), global_batch=8))
    run, meta = tstep.make_epoch_runner(cfg, tcfg, W, fused=True,
                                        device="cpu")
    run(tstep.init_train_state(cfg, tcfg, W, device="cpu"))
    L, A, steps = cfg.num_layers, meta["accum"], 2
    assert A == 4
    assert calls == {"rmsnorm": (2 * L + 1) * A * W * steps,
                     "flash_attention": 0,
                     "ssd_scan": 2 * L * A * W * steps,
                     "vr_update": steps}


def test_launcher_trains_mamba2_on_the_cpu(capsys):
    launch_train.main(["--arch", ARCH, "--reduced", "--steps", "4",
                       "--vr-table-size", "2", "--num-workers", "2",
                       "--seq-len", "16", "--global-batch", "4",
                       "--microbatch", "1", "--optimizer", "sgd",
                       "--lr", "0.1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 4 steps" in out and "nan" not in out


def test_fused_mamba2_step_loads_neither_jax_nor_the_reference():
    """In a fresh process: one fused epoch of mamba2-130m.reduced() on the
    CPU, then neither jax nor ``repro`` is loaded, and K4's module is."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "from repro_torch.config import TrainConfig, get_arch\n"
        "from repro_torch.train import step\n"
        "cfg = get_arch('mamba2-130m').reduced()\n"
        "tcfg = TrainConfig(seq_len=16, global_batch=2, microbatch=1, "
        "optimizer='sgd', learning_rate=0.1, vr='centralvr', "
        "vr_table_size=2)\n"
        "run, _ = step.make_epoch_runner(cfg, tcfg, 1, fused=True, "
        "device='cpu')\n"
        "run(step.init_train_state(cfg, tcfg, 1, device='cpu'))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.kernels.ssd_scan.kernel' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
