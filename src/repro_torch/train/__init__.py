"""The LM trainer of the port: epoch runner and training loop."""
