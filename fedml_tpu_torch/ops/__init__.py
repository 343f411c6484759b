"""Hand-written Hopper kernels for the hot ops (CUDA C++ under ``csrc/``,
built with nvcc and bound through ctypes by ``loader``)."""

from fedml_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_with_lse,
)

__all__ = ["flash_attention", "flash_attention_with_lse"]
