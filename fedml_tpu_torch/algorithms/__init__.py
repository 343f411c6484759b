"""Federated algorithms, port of fedml_tpu/algorithms: standalone FedAvg on
one device, its robust / accounted-DP variant, and TurboAggregate's masked
secure aggregation (``algorithms.turboaggregate``)."""

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustAPI

__all__ = ["FedAvgAPI", "FedAvgConfig", "FedAvgRobustAPI"]
