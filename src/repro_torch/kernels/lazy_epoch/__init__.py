"""The lazy sparse epoch (``prox/lazy.py``, ``sampling="sparse"``): the
hand-written CUDA kernel ``csrc/lazy_epoch.cu`` (``kernel.py``: build,
checks, launch) and its plain PyTorch version (``ref.py``). It has no
Pallas counterpart: it stands for the reference's jitted scan
``_lazy_epoch``."""
