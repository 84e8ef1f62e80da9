"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates without
sparsity, at its full 700 W power limit (NVIDIA H100 Tensor Core GPU data
sheet; the same figures as the port's ``kernel_times.py``). A card set to a
lower power limit reaches less: every share is stated against these, with the
card's power limit beside it in the result's ``device``."""

BYTES_PER_S = 3.35e12   # HBM3 bandwidth
F32_FLOPS = 67e12       # float32 outside the tensor cores
TF32_FLOPS = 495e12     # TF32 on the tensor cores
BF16_FLOPS = 989e12     # bfloat16 on the tensor cores

FLOPS = {"float32": F32_FLOPS, "tf32": TF32_FLOPS, "bfloat16": BF16_FLOPS}
