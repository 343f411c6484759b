from fedml_tpu_torch.distributed.fedavg.api import (
    FedML_FedAvg_distributed,
    run_simulated,
)
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage

__all__ = ["FedML_FedAvg_distributed", "run_simulated", "MyMessage"]
