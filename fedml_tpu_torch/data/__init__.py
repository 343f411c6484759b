"""Federated datasets, port of fedml_tpu/data: a ``FederatedData`` per
dataset, synthesized byte-equal to the reference's stand-ins (image,
LEAF-LR and sequence families)."""

from fedml_tpu_torch.core.client_data import FederatedData
from fedml_tpu_torch.data.registry import DATASETS, load_dataset

__all__ = ["DATASETS", "FederatedData", "dataset_source", "load_dataset"]


def dataset_source(data) -> str:
    """'real' | 'synthetic' for the telemetry run header — so a run on a
    synthetic stand-in can never pass for real-dataset evidence.
    FederatedData carries the loaders' synthetic_fallback flag (absent =
    real files were read)."""
    src = getattr(data, "source", None)
    if isinstance(src, str):
        return src
    return ("synthetic" if getattr(data, "synthetic_fallback", False)
            else "real")
