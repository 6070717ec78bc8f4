"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at the full
700 W power limit.  A card set below it runs slower: every figure held
against these is reported with the card's name and power limit."""

F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

DTYPE_FLOPS = {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS, "float16": BF16_FLOPS}
