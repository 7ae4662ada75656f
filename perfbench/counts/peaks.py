"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
full 700 W power limit): float32 outside the tensor cores, and HBM3
bandwidth. A card set below 700 W reaches less; the run prints its limit."""

PEAK_FP32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
