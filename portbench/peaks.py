"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W power limit)."""

BF16_FLOP_S = 989e12    # bf16 / fp16 tensor-core operations a second
HBM_BYTES_S = 3.35e12   # device memory bytes a second
