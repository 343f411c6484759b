"""Finite-field collectives, port of fedml_tpu/collectives: the GF(p)
arithmetic secure aggregation runs on (``finite_field``)."""

from fedml_tpu_torch.collectives import finite_field

__all__ = ["finite_field"]
