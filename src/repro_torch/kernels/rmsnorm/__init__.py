"""K2: fused RMSNorm (``kernel.py`` wrapper and build, ``ref.py`` plain
version, ``csrc/rmsnorm.cu`` the CUDA source)."""
