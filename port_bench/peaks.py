"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense
rates without sparsity, at the 700 W power limit)."""
FLOPS = {"float32": 67e12,       # fp32 outside the tensor cores
         "tf32": 495e12,
         "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
