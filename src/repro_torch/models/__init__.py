"""The LM of the port: layers, attention, the decoder stack and the loss."""
