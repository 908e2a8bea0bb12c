"""Roofline terms of the port's programs: ``analysis`` (the three terms,
the model-FLOPs rule, the VR step's traffic) and ``op_cost`` (the op-level
cost model of a call on meta tensors, the dry run's counterpart of the
reference's HLO cost model)."""
from repro_torch.roofline import analysis, op_cost  # noqa: F401
