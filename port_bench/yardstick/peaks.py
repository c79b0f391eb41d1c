"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W limit)."""

BF16_FLOPS = 989e12  # bf16 tensor cores, dense
HBM_BYTES = 3.35e12  # bytes/s
# float32 operations outside the tensor cores: 67 TFLOP/s counts a fused
# multiply-add as two; the kernels are built with -fmad=false, so an
# operation is one multiply or one add
FP32_OPS = 33.5e12
