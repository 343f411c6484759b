"""Parallelism strategies. This slice carries the single-device attention
oracle only; ring and Ulysses attention over torch.distributed are queued
in ROADMAP.md (queue A, item 11)."""

from fedml_tpu_torch.parallel.ring_attention import full_attention

__all__ = ["full_attention"]
