"""The loss (+ the MoE aux loss) and its gradients of the eight archs of
the PyTorch port beyond Qwen2-7B and Mamba2-130M (local attention, RG-LRU
blocks, MoE FFNs with and without a shared expert, LayerNorm / GELU
archs, qk_norm, the vision frontend stub) against the JAX reference, for
remat "none", "block" and "dots".

Everything runs on the CPU in float32 with the reference's params and
tokens fed to the port.
"""
import numpy as np
import pytest
import torch

from torch_lm_common import (LM_TOL, NEW_ARCHS, assert_trees_close,
                             loss_and_grads)

torch.set_num_threads(1)


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    got, want, g_port, g_ref = loss_and_grads(arch, remat)
    np.testing.assert_allclose(got, want, **LM_TOL)
    assert_trees_close(g_port, g_ref, **LM_TOL)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "recurrentgemma-2b"])
def test_remat_dots_matches_reference(arch):
    """The reference's ``checkpoint_dots_with_no_batch_dims``: the MoE
    experts' and the RG-LRU gates' batched products are recomputed."""
    got, want, g_port, g_ref = loss_and_grads(arch, "dots")
    np.testing.assert_allclose(got, want, **LM_TOL)
    assert_trees_close(g_port, g_ref, **LM_TOL)
