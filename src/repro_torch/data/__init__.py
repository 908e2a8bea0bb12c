"""Synthetic finite-sum token streams of the port."""
