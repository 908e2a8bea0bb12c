"""K1: the fused CentralVR/SAGA update (``kernel.py`` wrapper and build,
``ref.py`` plain version, ``csrc/vr_update.cu`` the CUDA source)."""
