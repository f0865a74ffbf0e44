"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W)."""
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
