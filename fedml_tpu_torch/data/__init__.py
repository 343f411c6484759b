"""Federated datasets, port of fedml_tpu/data: a ``FederatedData`` per
dataset, synthesized byte-equal to the reference's stand-ins (image,
LEAF-LR and sequence families)."""

from fedml_tpu_torch.core.client_data import FederatedData
from fedml_tpu_torch.data.registry import DATASETS, load_dataset

__all__ = ["DATASETS", "FederatedData", "load_dataset"]
