"""Every arch of the zoo in the PyTorch port against the JAX reference: the
ten configs, the params layout and count, RecurrentGemma's tail and local
window, the vision frontend stub and the loss's mask over its positions,
the fused epoch runner for the MoE archs and RecurrentGemma, and the
launcher. ``test_torch_archs_grads.py`` holds the loss and gradients of
the eight archs beyond Qwen2-7B and Mamba2-130M,
``test_torch_archs_runner.py`` their unfused epoch runner.

Everything runs on the CPU in float32 with the reference's params and
tokens fed to the port (randomness is data). The fused path's kernels run
their plain versions here.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.config import get_arch as jget_arch
from repro.config import list_archs as jlist_archs
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.config import get_arch, list_archs
from repro_torch.data import synthetic
from repro_torch.launch import train as launch_train
from repro_torch.models import model

from torch_lm_common import (LM_TOL, NEW_ARCHS, assert_trees_close, cfgs,
                             check_runner, loss_and_grads)

torch.set_num_threads(1)

FUSED_ARCHS = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "recurrentgemma-2b")


# ---------------------------------------------------------------------------
# configs and the params layout
# ---------------------------------------------------------------------------

def test_the_port_registers_every_arch_of_the_reference():
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert list_archs() == jlist_archs()
    assert set(NEW_ARCHS) | {"qwen2-7b", "mamba2-130m"} == set(list_archs())


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", jconfigs.ASSIGNED_ARCHS)
def test_config_is_the_reference_config(arch, reduced):
    ref, port = jget_arch(arch), get_arch(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.layer_kinds() == ref.layer_kinds()
    assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED_ARCHS)
def test_layout_holds_the_reference_params(arch):
    """The port's flat layout has as many parameters as the reference's
    init on every reduced arch, and takes a tree of the reference's leaf
    shapes leaf for leaf (``load_`` checks every shape)."""
    jcfg, cfg = cfgs(arch=arch)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    layout = model.ParamLayout(cfg)
    assert layout.n == jmodel.param_count_actual(shapes)
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    layout.load_(torch.empty(layout.n),
                 convert.lm_params_from_jax(zeros, cfg))
    assert ("frontend_proj" in layout.tree) == (cfg.frontend is not None)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_recurrentgemma_tail_and_window_match_reference():
    """Five layers: one super-block (rec, rec, local) and the two-layer
    rec tail, as the 26-layer model ends; seq 32 past the reduced local
    window of 16, so the window masks."""
    _, cfg = cfgs(arch="recurrentgemma-2b")
    assert cfg.local_window == 16
    got, want, g_port, g_ref = loss_and_grads("recurrentgemma-2b", "block",
                                               num_layers=5, seq=32)
    np.testing.assert_allclose(got, want, **LM_TOL)
    assert_trees_close(g_port, g_ref, **LM_TOL)
    assert dataclasses.replace(cfg, num_layers=5).layer_kinds() == (
        "rec", "rec", "local", "rec", "rec")


def test_frontend_positions_are_left_out_of_the_loss():
    """internvl2: the projected embeddings come first and the loss is the
    next-token cross-entropy over the text positions alone; without
    embeddings the model runs on the tokens. The stub's own draws: the
    reference's shape and statistics, None for musicgen (no frontend
    tokens)."""
    _, cfg = cfgs(arch="internvl2-26b")
    tree = model.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = synthetic.microbatch_tokens(cfg, 0, 0, 0, 2, 12)
    fe = synthetic.frontend_embeds(cfg, 0, 2)
    assert fe.shape == (2, cfg.frontend_tokens, cfg.d_model)
    assert torch.equal(fe, synthetic.frontend_embeds(cfg, 0, 2))
    assert abs(float(fe.pow(2).mean()) - 0.5) < 0.1   # 0.5 b + 0.5 roll(b)
    batch = {"tokens": toks, "frontend_embeds": fe}
    logits, aux = model.forward(tree, cfg, batch)
    n_f = cfg.frontend_tokens
    assert logits.shape == (2, n_f + 12, cfg.vocab_size) and aux == 0.0
    logp = torch.log_softmax(logits[:, n_f:-1], -1)
    want = -torch.gather(logp, -1, toks[:, 1:, None])[..., 0].mean()
    assert float(model.loss_fn(tree, cfg, batch)) == pytest.approx(
        float(want), rel=1e-6)
    text_only = model.forward(tree, cfg, {"tokens": toks})[0]
    assert text_only.shape == (2, 12, cfg.vocab_size)
    _, music = cfgs(arch="musicgen-large")
    assert synthetic.frontend_embeds(music, 0, 2) is None


# ---------------------------------------------------------------------------
# the epoch runner and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FUSED_ARCHS)
def test_fused_epoch_runner_matches_reference(arch):
    """The kernels' path (K1, K2, K3, their plain versions here) for the
    MoE archs and RecurrentGemma, against the reference's fused run."""
    check_runner(arch, True)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen3-moe-30b-a3b"])
def test_launcher_trains_the_new_archs_on_the_cpu(arch, capsys):
    launch_train.main(["--arch", arch, "--reduced", "--steps", "4",
                       "--vr-table-size", "2", "--num-workers", "2",
                       "--seq-len", "16", "--global-batch", "4",
                       "--microbatch", "1", "--optimizer", "sgd",
                       "--lr", "0.1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 4 steps" in out and "nan" not in out.lower()
