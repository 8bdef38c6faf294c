"""Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit)."""

# float32 outside the tensor cores: the configurations multiply in
# float32 with TF32 off (their bf16 heads round the operands and
# multiply in float32)
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
