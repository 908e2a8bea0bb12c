"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). Shares of them are
stated with the card's power limit beside them."""

BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores, dense
HBM_BYTES = 3.35e12        # HBM3 bandwidth, bytes a second
