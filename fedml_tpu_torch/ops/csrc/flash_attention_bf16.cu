// Flash attention for Hopper (sm_90a), bfloat16 q, k, v, dO and outputs (lse
// and corr float32): the C entry points flash_attention_bf16_fwd,
// flash_attention_bf16_bwd_dq and flash_attention_bf16_bwd_dkv, which replace
// the reference's Pallas kernels on bf16 inputs (fedml_tpu/ops/
// flash_attention.py:79, :213, :238): float32 math on each tile, the outputs
// rounded to bf16 once. All three run on wgmma with TMA-fed tiles
// (flash_attention_sm90_bf16.cuh). Each returns cudaGetLastError() of its
// launch, the tensor map's error before it, or kErrRegisterShare (-1) for a
// wgmma kernel built with other than its block's register share.

#include "flash_attention_sm90_bf16.cuh"

FLASH_ENTRY_POINTS(flash_attention_bf16, __nv_bfloat16, run_fwd_wgmma, run_dq_wgmma,
                   run_dkv_wgmma)
