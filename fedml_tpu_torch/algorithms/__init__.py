"""Federated algorithms, port of fedml_tpu/algorithms. This slice carries
standalone FedAvg on one device."""

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig

__all__ = ["FedAvgAPI", "FedAvgConfig"]
