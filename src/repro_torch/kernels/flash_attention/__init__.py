"""K3: causal GQA flash attention, forward (``kernel.py`` wrapper and
build, ``ref.py`` plain versions, ``csrc/flash_attention.cu`` the CUDA
source)."""
