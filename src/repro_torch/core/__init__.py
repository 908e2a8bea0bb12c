"""The paper's contribution on PyTorch: CentralVR and its distributed
variants.

Modules:
  convex       -- the paper's experimental problems (GLM scalar-residual form)
  centralvr    -- Algorithm 1 (single worker)
  distributed  -- Algorithm 2 (CentralVR-Sync), workers as a batch dimension
  fused        -- the inner loop through the hand-written vr_update kernel
  solver       -- RunSpec / solve / RunResult
"""
