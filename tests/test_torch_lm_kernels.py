"""K2 (RMSNorm) and K3 (flash attention) of the PyTorch port, and the LM
path that runs them, against the JAX reference.

On the CPU the port's kernel wrappers run their plain versions; these are
held, on the same seeded inputs, against the reference's oracles and its
Pallas kernels in interpret mode, at the tolerances of
``tests/test_kernels.py``. The fused LM path (``kernel_ctx`` on, fused VR
step) is held against the reference's fused path at ``LM_TOL`` of
``tests/test_fused_agreement.py``, for the slice's Qwen2-7B blocks and
for the dense block's other options (layernorm, gelu, softcap, padded
heads, qk-norm, windows, tied embeddings). The CUDA kernels against their
plain versions on the card are ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as fa_ops
from repro.kernels.flash_attention import ref as fa_ref
from repro.kernels.rmsnorm import ops as rms_ops
from repro.kernels.rmsnorm import ref as rms_ref
from repro.models import kernel_ctx as jkernel_ctx
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_plain
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.models import kernel_ctx
from repro_torch.models import model

from torch_lm_common import (LM_TOL, assert_trees_close, cfgs, port_run,
                             reference_run)

torch.set_num_threads(1)

BF16 = jnp.bfloat16


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype):
    """A reference array as a torch tensor of ``dtype`` (through float32,
    which holds every bfloat16 value exactly)."""
    return torch.from_numpy(np.array(_np(a))).to(dtype)


def _dtypes(jdt):
    return torch.float32 if jdt == jnp.float32 else torch.bfloat16


# ---------------------------------------------------------------------------
# K2: RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, BF16])
@pytest.mark.parametrize("shape", [(4, 8, 64), (3, 128), (1, 1, 256),
                                   (7, 33)])
def test_rmsnorm_plain_matches_reference_oracle(shape, dtype):
    x = jax.random.normal(jax.random.PRNGKey(0), shape,
                          jnp.float32).astype(dtype)
    s = jax.random.normal(jax.random.PRNGKey(1), (shape[-1],), jnp.float32)
    want = rms_ref.rmsnorm_ref(x.reshape(-1, shape[-1]), s).reshape(shape)
    got = rms_kernel.rmsnorm(_t(x, _dtypes(dtype)), _t(s, torch.float32))
    tol = 1e-6 if dtype == jnp.float32 else 2e-2
    assert got.dtype == _dtypes(dtype) and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, BF16])
@pytest.mark.parametrize("shape", [(2, 16, 128), (300, 64), (5, 40)])
def test_rmsnorm_plain_matches_pallas_interpret(shape, dtype):
    x = jax.random.normal(jax.random.PRNGKey(2), shape,
                          jnp.float32).astype(dtype)
    s = (1.0 + 0.1 * jax.random.normal(jax.random.PRNGKey(3),
                                       (shape[-1],))).astype(dtype)
    want = rms_ops.rmsnorm(x, s, interpret=True)
    before = rms_kernel.launches
    got = rms_kernel.rmsnorm(_t(x, _dtypes(dtype)), _t(s, _dtypes(dtype)))
    assert rms_kernel.launches == before      # CPU: the plain version
    tol = 1e-6 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


def test_rmsnorm_wrapper_checks_its_operands():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="scale has shape"):
        rms_kernel.rmsnorm(x, torch.ones(7))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rms_kernel.rmsnorm(x.to("meta"), torch.ones(8, device="meta"))


@pytest.mark.parametrize("d,itemsize,addresses,want", [
    (768, 2, (0, 0, 0), (4, 1)),           # the Mamba2 step: a warp a row
    (3584, 2, (0, 1 << 20, 4096), (4, 4)),  # the Qwen2 step: 4 warps a row
    (8, 2, (0, 0, 0), (1, 1)),             # one vector, one lane
    (256, 2, (0, 0, 0), (1, 1)),           # 32 vectors: one a lane
    (512, 2, (0, 0, 0), (2, 1)),
    (1536, 2, (0, 0, 0), (4, 2)),          # 192 vectors: 2 warps
    (1004, 4, (0, 0, 0), (4, 2)),          # float32, 251 vectors
    (3584, 4, (0, 0, 0), (4, 8)),          # float32: 896 vectors, 8 warps
    (8192, 2, (0, 0, 0), (4, 8)),          # bf16 at the plans' edge
    (4096, 4, (0, 0, 0), (4, 8)),          # float32 at the plans' edge
    (8200, 2, (0, 0, 0), (0, 0)),          # wider than 8 warps hold
    (12272, 4, (0, 0, 0), (0, 0)),         # MAX_D in float32
    (1001, 2, (0, 0, 0), (0, 0)),          # bytes not a multiple of 16
    (1024, 2, (2, 0, 0), (0, 0)),          # x one element off alignment
    (1024, 2, (0, 8, 0), (0, 0)),          # scale off alignment
    (1024, 2, (0, 0, 4), (0, 0)),          # y off alignment
])
def test_rmsnorm_vector_plan_picks_each_path(d, itemsize, addresses, want):
    """K2's launch path: the vector body's (vectors a lane holds, warps a
    row spans), or (0, 0) for the row-per-block loop; every plan it picks
    is compiled, covers the row, and takes the fewest warps that keep a
    lane at 4 vectors or fewer."""
    got = rms_kernel.vector_plan(d, itemsize, *addresses)
    assert got == want
    if got != (0, 0):
        vpl, wpr = got
        assert got in rms_kernel.PLANS
        vecs = d * itemsize // rms_kernel.VEC_BYTES
        assert 32 * wpr * vpl >= vecs
        fewer = [w for w in rms_kernel.WARPS_PER_ROW if w < wpr]
        assert all(vecs > 4 * 32 * w for w in fewer)


def test_rmsnorm_source_instantiates_every_plan():
    """csrc/rmsnorm.cu's launch switch compiles exactly the wrapper's
    PLANS (and the loop, (0, 0))."""
    import re
    src = rms_kernel.SOURCE.read_text()
    cases = re.findall(r"case (\d+) \* 16 \+ (\d+):\s*return launch_rows<"
                       r"T, S, (\d+), (\d+)>", src)
    assert all((a, b) == (c, d) for a, b, c, d in cases)
    assert {(int(a), int(b)) for a, b, _, _ in cases} == set(
        rms_kernel.PLANS)
    assert "vpl == 0 && wpr == 0" in src


@pytest.mark.parametrize("x,scale,error,match", [
    (torch.ones(4, 8, dtype=torch.float16), torch.ones(8), TypeError,
     "float32 or bfloat16"),
    (torch.ones(4, 8), torch.ones(8, dtype=torch.float64), TypeError,
     "float32 or bfloat16"),
    (torch.ones(8, 4).t(), torch.ones(8), ValueError, "contiguous"),
    (torch.ones(4, 16), torch.ones(32)[::2], ValueError, "contiguous"),
    (torch.ones(2, 12273), torch.ones(12273), ValueError, "outside"),
    (torch.ones(2, 0), torch.ones(0), ValueError, "outside"),
])
def test_rmsnorm_launch_refuses_what_it_refused(x, scale, error, match):
    """The kernel's checks (``check_launch``, reached with CUDA tensors):
    the same errors as before the vector body, for the same operands."""
    with pytest.raises(error, match=match):
        rms_kernel.check_launch(x, scale)


@pytest.mark.parametrize("d", [1, 7, 768, 1001, 3584, 8200, 12272])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_launch_takes_every_width_up_to_max_d(d, dtype):
    """Every width 1..MAX_D (12,272) is taken, whichever path runs it."""
    assert rms_kernel.MAX_D == 12272
    rms_kernel.check_launch(torch.ones(2, d, dtype=dtype),
                            torch.ones(d, dtype=dtype))


# ---------------------------------------------------------------------------
# K3: flash attention
# ---------------------------------------------------------------------------

def _qkv(seed, B, S, H, KV, hd, dtype=jnp.float32):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(ks[0], (B, S, H, hd), jnp.float32).astype(dtype)
    k = jax.random.normal(ks[1], (B, S, KV, hd), jnp.float32).astype(dtype)
    v = jax.random.normal(ks[2], (B, S, KV, hd), jnp.float32).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [jnp.float32, BF16])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 64, 2, 2, 16),     # MHA
    (2, 64, 4, 2, 32),     # GQA group 2
    (1, 128, 8, 1, 16),    # MQA
    (1, 100, 4, 2, 16),    # ragged S (padding path)
])
def test_flash_plain_matches_naive_reference(B, S, H, KV, hd, dtype):
    q, k, v = _qkv(0, B, S, H, KV, hd, dtype)
    want = fa_ref.flash_attention_naive(
        q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32))
    td = _dtypes(dtype)
    got = fa_kernel.flash_attention(_t(q, td), _t(k, td), _t(v, td))
    tol = 2e-5 if dtype == jnp.float32 else 2e-2
    assert got.dtype == td and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("window", [None, 8, 32])
@pytest.mark.parametrize("S,H,KV", [(96, 4, 2), (70, 4, 1), (64, 2, 2)])
def test_flash_plain_matches_pallas_interpret(S, H, KV, window):
    """GQA, sliding window and ragged S against the Pallas kernel."""
    q, k, v = _qkv(1, 1, S, H, KV, 16)
    want = fa_ops.flash_attention(q, k, v, window=window, q_blk=32,
                                  kv_blk=32, interpret=True)
    got = fa_kernel.flash_attention(_t(q, torch.float32),
                                    _t(k, torch.float32),
                                    _t(v, torch.float32), window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("window", [None, 8])
def test_chunked_and_naive_match_the_reference_forms(window):
    from repro.models import attention as jattn
    q, k, v = _qkv(2, 2, 64, 4, 2, 16)
    tq, tk, tv = (_t(a, torch.float32) for a in (q, k, v))
    np.testing.assert_allclose(
        fa_plain.chunked_attention(tq, tk, tv, window=window, q_chunk=16,
                                   kv_chunk=32).numpy(),
        _np(jattn.chunked_attention(q, k, v, window=window, q_chunk=16,
                                    kv_chunk=32)), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(
        fa_plain.naive_attention(tq, tk, tv, window=window).numpy(),
        _np(jattn.naive_attention(q, k, v, window=window)), atol=2e-5,
        rtol=1e-4)


def test_flash_block_table_follows_the_kernel_source():
    """ref.BLOCKS, the plain version's (query block, key block) by dtype
    and head size, is the table of launch_hd<bf16> / launch_hd<float> in
    csrc/flash_attention.cu."""
    import re
    src = fa_kernel.SOURCE.read_text()
    table = {}
    for dtype, launch in ((torch.bfloat16, "launch_bf16"),
                          (torch.float32, "launch_f32")):
        cases = re.findall(rf"case (\d+): return {launch}<(\d+), (\d+), "
                           rf"(\d+)>", src)
        assert all(hd == hd2 for hd, hd2, _, _ in cases)
        table[dtype] = {int(hd): (int(bq), int(bk))
                        for hd, _, bq, bk in cases}
    assert table == fa_plain.BLOCKS
    assert set(table[torch.bfloat16]) == set(fa_kernel.HEAD_DIMS)
    for dtype, hd, want in ((torch.bfloat16, 128, (128, 64)),
                            (torch.bfloat16, 256, (64, 64)),
                            (torch.float32, 256, (64, 32)),
                            (torch.float64, 16, (64, 64)),
                            (torch.bfloat16, 512, (64, 64))):
        assert fa_plain.blocks(dtype, hd) == want


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("table", [torch.bfloat16, torch.float32])
def test_flash_plain_at_kernel_blocks_matches_pallas_interpret(table, hd,
                                                               window):
    """The plain version chunked by the kernel's blocks (bf16's 128 / 64
    and float32's 64 / 64 at these head sizes), in float32, against the
    Pallas kernel at the same blocks in interpret mode; GQA, a ragged S
    and a window."""
    q_blk, kv_blk = fa_plain.BLOCKS[table][hd]
    q, k, v = _qkv(3, 1, 200, 4, 2, hd)
    want = fa_ops.flash_attention(q, k, v, window=window, q_blk=q_blk,
                                  kv_blk=kv_blk, interpret=True)
    got = fa_plain.flash_attention_ref(
        _t(q, torch.float32), _t(k, torch.float32), _t(v, torch.float32),
        window=window, block=(q_blk, kv_blk))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=1e-4)


def test_flash_wrapper_checks_its_operands():
    q, k = torch.ones(1, 8, 4, 16), torch.ones(1, 8, 3, 16)
    with pytest.raises(ValueError, match="not a multiple"):
        fa_kernel.flash_attention(q, k, k)
    k = torch.ones(1, 8, 2, 16)
    with pytest.raises(ValueError, match="window"):
        fa_kernel.flash_attention(q, k, k, window=0)
    with pytest.raises(TypeError, match="float64"):
        fa_kernel.flash_attention(q, k, k.double())


# ---------------------------------------------------------------------------
# The fused LM path (kernel_ctx on) against the reference's fused path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "block"])
def test_fused_loss_and_grads_match_reference_fused(remat):
    jcfg, cfg = cfgs()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0,
                              jcfg.vocab_size)
    with jkernel_ctx.scope(True, interpret=True):
        loss, grads = jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jcfg, {"tokens": toks},
                                     remat=remat))(params)
    tree = model.tree_map(lambda t: t.requires_grad_(),
                          convert.lm_params_from_jax(params, cfg))
    with kernel_ctx.scope(True):
        got = model.loss_fn(tree, cfg, {"tokens": convert.tokens_from_jax(
            toks)}, remat=remat)
        got.backward()
    np.testing.assert_allclose(got.item(), float(loss), **LM_TOL)
    assert_trees_close(model.tree_map(lambda t: t.grad, tree),
                       convert.lm_params_from_jax(grads, cfg), **LM_TOL)
    assert not kernel_ctx.active()


VARIANTS = {
    # layernorm, gelu MLP with biases, logit softcap, tied embeddings
    "layernorm-gelu-softcap": dict(norm_type="layernorm", mlp_type="gelu",
                                   mlp_bias=True, attn_logit_softcap=30.0,
                                   tie_embeddings=True),
    # padded (inert) heads, qk-norm, a sliding window
    "padded-qknorm-window": dict(pad_heads_to=6, qk_norm=True,
                                 sliding_window=8),
}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_layer_variants_match_reference(variant, fused):
    """The other layer options of the dense block (the qwen2-7b slice
    uses none of them), fused (kernel_ctx on) and unfused."""
    from repro.config import ModelConfig as JModelConfig
    from repro_torch.config import ModelConfig

    kw = dict(name="variant", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=128, dtype="float32", **VARIANTS[variant])
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0, 128)
    with jkernel_ctx.scope(fused, interpret=True):
        loss, grads = jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jcfg, {"tokens": toks}))(params)
    tree = model.tree_map(lambda t: t.requires_grad_(),
                          convert.lm_params_from_jax(params, cfg))
    with kernel_ctx.scope(fused):
        got = model.loss_fn(tree, cfg,
                            {"tokens": convert.tokens_from_jax(toks)})
        got.backward()
    np.testing.assert_allclose(got.item(), float(loss), **LM_TOL)

    # a gradient entry is a sum of many terms that cancel, so its error is
    # held to the leaf's scale: LM_TOL's rtol, as an absolute error of
    # the leaf's largest entry
    def check(a, b):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=LM_TOL["rtol"],
                                   atol=LM_TOL["rtol"] * np.abs(b).max())
    model.tree_zip(check, model.tree_map(lambda t: t.grad, tree),
                   convert.lm_params_from_jax(grads, cfg))


@pytest.mark.parametrize("W", [1, 2])
def test_fused_epoch_runner_matches_reference_fused(W):
    """fused=True on CPU tensors (the K2/K3 plain versions in the forward,
    the K1 plain version as the VR step) against the reference's fused
    runner (Pallas interpret mode) on the main path's algorithm, two
    epochs. Every vr mode, fused and unfused, is held against the
    reference in tests/test_torch_lm.py."""
    _, cfg = cfgs()
    p0, toks, want_losses, want_params = reference_run("centralvr", W, True)
    state, losses, meta = port_run("centralvr", W, True, p0, toks)
    assert meta["fused"] is True and state.step == 4
    np.testing.assert_allclose(losses, want_losses, **LM_TOL)
    for w in range(W):
        assert_trees_close(state.param_tree(w),
                           convert.lm_params_from_jax(want_params[w], cfg),
                           **LM_TOL)
