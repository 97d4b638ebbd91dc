"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

#: bf16 / fp16 tensor-core operations per second
BF16_FLOPS = 989e12
#: float32 operations per second outside the tensor cores
F32_FLOPS = 67e12
#: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
