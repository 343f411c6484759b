"""Collectives, port of fedml_tpu/collectives: the GF(p) arithmetic secure
aggregation runs on (``finite_field``) and the differentiable mesh-axis
collectives of the sequence-parallel path (``ops``)."""

from fedml_tpu_torch.collectives import finite_field
from fedml_tpu_torch.collectives.ops import (
    all_gather,
    all_to_all,
    ppermute,
    psum,
    seq_invariant,
    shard,
)

__all__ = ["finite_field", "all_gather", "all_to_all", "ppermute", "psum",
           "seq_invariant", "shard"]
