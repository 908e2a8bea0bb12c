"""K4: the Mamba2 SSD chunk scan — CUDA kernel (``kernel.py``) and its
plain PyTorch version (``ref.py``)."""
