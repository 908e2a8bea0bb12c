"""Placement of the port's parameters on a process mesh: the reference's
PartitionSpec rules (``specs``), the explicit per-layer ZeRO-3 weight
gather over 'data' (``gather_ctx``) and the tensor-parallel collectives
over 'model' (``tp``)."""
