// Flash attention for Hopper (sm_90a), float32 q, k, v, dO and outputs: the
// C entry points flash_attention_fwd, flash_attention_bwd_dq and
// flash_attention_bwd_dkv over the kernels of flash_attention.cuh (the source
// note there says which TPU kernels they replace and how they are built).

#include "flash_attention.cuh"

FLASH_ENTRY_POINTS(flash_attention, float)
