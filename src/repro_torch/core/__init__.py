"""The paper's contribution on PyTorch: CentralVR and its distributed
variants.

Modules:
  convex       -- the paper's experimental problems (GLM scalar-residual form)
  centralvr    -- Algorithm 1 (single worker)
  distributed  -- Algorithms 2-5 (CentralVR-Sync, CentralVR-Async, D-SVRG,
                  D-SAGA), workers as a batch dimension
  baselines    -- SGD, SVRG, SAGA (Fig. 1); distributed SGD, EASGD, PS-SVRG
  runtime      -- the asynchronous event schedule and its wave algebra
  fused        -- the VR inner loops, each one launch of the hand-written
                  vr_epoch kernel
  solver       -- RunSpec / solve / RunResult
  host_loop    -- per-round host drivers of Algorithms 1-5 (a pinning
                  oracle)
  theory       -- Theorem 1 constants
"""
from repro_torch.core import (baselines, centralvr, convex,  # noqa: F401
                              distributed, host_loop, runtime, theory)
