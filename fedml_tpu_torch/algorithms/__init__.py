"""Federated algorithms, port of fedml_tpu/algorithms: standalone FedAvg on
one device, its robust / accounted-DP variant, TurboAggregate's masked
secure aggregation (``algorithms.turboaggregate``) and sequence-parallel
long-context FedAvg over a ('clients', 'seq') mesh (``FedAvgSeqAPI``)."""

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustAPI
from fedml_tpu_torch.algorithms.fedavg_seq import FedAvgSeqAPI

__all__ = ["FedAvgAPI", "FedAvgConfig", "FedAvgRobustAPI", "FedAvgSeqAPI"]
