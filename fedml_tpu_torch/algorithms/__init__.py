"""Federated algorithms, port of fedml_tpu/algorithms: standalone FedAvg on
one device and its robust / accounted-DP variant."""

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustAPI

__all__ = ["FedAvgAPI", "FedAvgConfig", "FedAvgRobustAPI"]
