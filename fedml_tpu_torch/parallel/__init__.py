"""Parallelism strategies: the single-device attention oracle and ring,
flash-ring and Ulysses sequence-parallel attention over a mesh axis of a
torch.distributed world."""

from fedml_tpu_torch.parallel.ring_attention import (
    full_attention,
    ring_attention,
    ring_attention_flash,
    ring_attention_flash_sharded,
    ring_attention_sharded,
    ulysses_attention,
    ulysses_attention_sharded,
)

__all__ = ["full_attention", "ring_attention", "ring_attention_flash",
           "ring_attention_flash_sharded", "ring_attention_sharded",
           "ulysses_attention", "ulysses_attention_sharded"]
