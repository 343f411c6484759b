"""Per-process client trainer, port of fedml_tpu/distributed/fedavg/trainer.py:
the local fit over the client the server assigned this rank for the round.

The fit is the standalone engine's (core/local.make_local_update) on a
cohort of one, over the client's batches packed at its own depth (capped
at the budget every party agrees on, ``num_batches_for``) by the port's
``pack_clients``, the C++ packer when it builds. The models ported so far
draw no randomness during the fit, so where the reference folds an RNG
key by (seed, round, client), the port passes none.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgConfig,
    float32_compute,
    resolve_local_spec,
)
from fedml_tpu_torch.comm.message import pack_pytree, unpack_pytree
from fedml_tpu_torch.core.client_data import FederatedData, pack_clients
from fedml_tpu_torch.core.local import LocalSpec, Task, make_local_update
from fedml_tpu_torch.device import resolve_device


def num_batches_for(max_count: int, cfg: FedAvgConfig) -> int:
    """The per-client batch-depth formula every party must agree on: the
    natural depth for the largest client, capped by cfg.max_batches."""
    b_needed = int(np.ceil(max_count / cfg.batch_size))
    return min(cfg.max_batches or b_needed, b_needed)


class DistributedTrainer:
    """One rank's trainer on ``device`` (the CUDA device when None, see
    fedml_tpu_torch.device). ``net`` is the model state the rank holds: the
    last broadcast it received, then its local fit's result."""

    def __init__(self, client_rank: int, dataset: FederatedData, task: Task,
                 cfg: FedAvgConfig, local_spec: LocalSpec | None = None,
                 device=None):
        self.dataset, self.task, self.cfg = dataset, task, cfg
        self.device = resolve_device(device)
        self.client_index = client_rank - 1  # re-assigned per round by the server
        max_count = max(len(v) for v in dataset.train_idx_map.values())
        self.num_batches = num_batches_for(max_count, cfg)
        self.local_update = make_local_update(
            task, resolve_local_spec(local_spec, cfg))
        # the standalone engine's init (FedAvgAPI.__init__), so the
        # distributed and standalone runs of the port start equal
        init = task.init(torch.Generator().manual_seed(cfg.seed),
                         dataset.train_x[:cfg.batch_size])
        self.net = {k: v.to(self.device) for k, v in init.items()}
        self.metrics = None  # the last fit's summed metrics, on the device

    def warmup(self) -> dict:
        """The reference AOT-compiles its local-fit program here; eager
        PyTorch has nothing to compile, so this does nothing and reports
        nothing (kept so ``warmup`` / ``--warmup`` callers run unchanged)."""
        return {}

    def update_model(self, wire_leaves) -> None:
        self.net = unpack_pytree(self.net, wire_leaves)

    def update_dataset(self, client_index: int) -> None:
        self.client_index = int(client_index)

    def pack(self, round_idx: int):
        """The assigned client's batches for ``round_idx`` (host arrays,
        leading axis 1)."""
        return pack_clients(self.dataset, [self.client_index],
                            self.cfg.batch_size, max_batches=self.num_batches,
                            seed=self.cfg.seed, round_idx=round_idx)

    def fit(self, round_idx: int) -> int:
        """Run the local fit on the currently assigned client's data
        (result in self.net); returns the local sample count."""
        cb = self.pack(round_idx)
        put = lambda a: torch.from_numpy(a).to(self.device)
        with float32_compute():
            nets, self.metrics = self.local_update(
                self.net, put(cb.x), put(cb.y), put(cb.mask))
        self.net = {k: v[0] for k, v in nets.items()}
        return int(cb.num_samples[0])

    def train(self, round_idx: int):
        """Returns (wire_leaves, local_sample_number)."""
        n = self.fit(round_idx)
        return pack_pytree(self.net), n
