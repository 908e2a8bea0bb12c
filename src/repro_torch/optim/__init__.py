"""Optimizers and the VR wrapper of the LM trainer."""
