// Flash attention for Hopper (sm_90a), bfloat16 q, k, v, dO and outputs (lse
// and corr float32): the C entry points flash_attention_bf16_fwd,
// flash_attention_bf16_bwd_dq and flash_attention_bf16_bwd_dkv over the
// kernels of flash_attention.cuh, which replace the reference's Pallas
// kernels on bf16 inputs (fedml_tpu/ops/flash_attention.py:79, :213, :238):
// float32 math on each tile, the outputs rounded to bf16 once.

#include "flash_attention.cuh"

FLASH_ENTRY_POINTS(flash_attention_bf16, __nv_bfloat16)
