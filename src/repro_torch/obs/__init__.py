"""repro_torch.obs — run accounting (the analytical comms model)."""
