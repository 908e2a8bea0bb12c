"""Problem presets of the port (the paper's §6 settings)."""
