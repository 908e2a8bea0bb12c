"""repro_torch.prox — proximal operators for composite objectives."""
