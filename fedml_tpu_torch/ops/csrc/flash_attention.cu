// Flash attention for Hopper (sm_90a), float32 q, k, v, dO and outputs: the
// C entry points flash_attention_fwd, flash_attention_bwd_dq and
// flash_attention_bwd_dkv. The forward and dK/dV run on wgmma, every
// product in six bf16 passes on operands split in three
// (flash_attention_sm90_f32.cuh); dQ runs on mma.sync as 3xTF32
// (flash_attention.cuh). The source notes there say which TPU kernels they
// replace and how they are built. Each returns cudaGetLastError() of its
// launch, the tensor map's error before it, or kErrRegisterShare (-1) for a
// wgmma kernel built with other than its block's register share.

#include "flash_attention_sm90_f32.cuh"

FLASH_ENTRY_POINTS(flash_attention, float, run_fwd_wgmma_f32, run_dq, run_dkv_wgmma_f32)
