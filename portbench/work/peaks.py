"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit). A card set to a lower power limit runs below them; the
run prints the card's limit beside every share of a peak."""

PEAK_BF16_FLOPS = 989e12   # bf16 / fp16 tensor cores
PEAK_TF32_FLOPS = 495e12   # tf32 tensor cores
PEAK_BYTES = 3.35e12       # HBM3
PEAK_EXP = 3.9e12          # exponentials on the special-function units
