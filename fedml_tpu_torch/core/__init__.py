"""Core federated engine pieces, port of fedml_tpu/core: the data plane
(client_data, sampling, partition), the cohort-batched local fit (local,
optim) and task builders (tasks)."""

from fedml_tpu_torch.core.client_data import (
    ClientBatch,
    FederatedData,
    pack_clients,
)
from fedml_tpu_torch.core.local import LocalSpec, make_eval_fn, make_local_update
from fedml_tpu_torch.core.sampling import sample_clients

__all__ = ["ClientBatch", "FederatedData", "LocalSpec", "make_eval_fn",
           "make_local_update", "pack_clients", "sample_clients"]
