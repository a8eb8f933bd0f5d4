"""NVIDIA H100 SXM constants for roofline math, one card.

Published figures from NVIDIA's H100 data sheet (SXM part, dense rates
without sparsity, at the full 700 W power limit), not measurements: a
card set below 700 W runs slower under load, so a share of these peaks
is stated beside the card's power limit.  Names follow
``repro.roofline.hw`` where one exists; ``LINK_BW`` stands where JAX's
has an inter-chip link rate, ``SMEM_BYTES`` where it has an on-chip
scratch size.
"""

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 and fp16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12  # FLOP/s, TF32 on the tensor cores
PEAK_FLOPS_F32 = 67e12  # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80e9  # bytes of device memory
LINK_BW = 450e9  # bytes/s of NVLink per direction
SMEM_BYTES = 228 * 1024  # shared memory per SM
SM_COUNT = 132
