"""Checkpoints of the port: ``checkpoint.py`` (trees of tensors to one
``.npz`` and a ``.json`` manifest, the reference's format) and
``elastic.py`` (the elastic runtime's mesh-shape-portable checkpoints)."""
