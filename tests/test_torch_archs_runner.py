"""The epoch runner of the PyTorch port for the eight archs beyond
Qwen2-7B and Mamba2-130M, unfused, against the JAX reference's: two
epochs of CentralVR at W = 2 from the reference's params and tokens
(``test_torch_archs.py`` holds the fused runs).

Everything runs on the CPU in float32.
"""
import pytest
import torch

from torch_lm_common import NEW_ARCHS, check_runner

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_epoch_runner_matches_reference(arch):
    """Two epochs of CentralVR at W = 2 (M 2, SGD, remat "block") from
    the reference's params and tokens, unfused: per-step losses (the MoE
    aux loss included) and both workers' final params at LM_TOL."""
    check_runner(arch, False)
