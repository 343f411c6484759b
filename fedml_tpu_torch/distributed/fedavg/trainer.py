"""Per-process client trainer, port of fedml_tpu/distributed/fedavg/trainer.py:
the local fit over the client the server assigned this rank for the round.

The fit is the standalone engine's (core/local.make_local_update) on a
cohort of one, over the client's batches packed at its own depth (capped
at the budget every party agrees on, ``num_batches_for``) by the port's
``pack_clients``, the C++ packer when it builds (a streamed
``core/client_source.ClientDataSource`` reads only the assigned client's
rows). ``cfg.precision`` resolves as in the engine (bf16 included). The
models ported so far draw no randomness during the fit, so where the
reference folds an RNG key by (seed, round, client), the port passes none.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgConfig,
    float32_compute,
    resolve_local_spec,
)
from fedml_tpu_torch.comm.message import pack_pytree, unpack_pytree
from fedml_tpu_torch.convert import num_heads_of
from fedml_tpu_torch.core.client_data import FederatedData, pack_clients
from fedml_tpu_torch.core.client_source import (
    ClientDataSource,
    pack_clients_source,
)
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
        self._source = (dataset if isinstance(dataset, ClientDataSource)
                        else None)
        if self._source is not None:
            max_count = int(np.max(self._source.client_sizes))
        else:
            max_count = max(len(v) for v in dataset.train_idx_map.values())
        self.num_batches = num_batches_for(max_count, cfg)
        self.local_update = make_local_update(
            task, resolve_local_spec(local_spec, cfg))
        # the standalone engine's init (FedAvgAPI.__init__), so the
        # distributed and standalone runs of the port start equal
        init = task.init(torch.Generator().manual_seed(cfg.seed),
                         self._source.init_batch(cfg.batch_size)
                         if self._source is not None
                         else dataset.train_x[:cfg.batch_size])
        self.net = {k: v.to(self.device) for k, v in init.items()}
        # the wire layout's head count (a TransformerLM's; None otherwise)
        self.num_heads = num_heads_of(task.module)
        self.metrics = None  # the last fit's summed metrics, on the device

    def warmup(self) -> dict:
        """Run the local fit once, on an all-masked zero batch, at each of
        the (at most four) most common batch depths of this population
        (the deepest kept), as the reference AOT-compiles those variants:
        the cuDNN / cuBLAS handles load and the allocator grows before the
        first broadcast. An all-masked fit is a no-op and its result is
        dropped, so ``net`` is untouched. Returns the engine's warmup
        report (``fresh_compiles`` / ``cache_hits`` 0: nothing compiles)."""
        bs = self.cfg.batch_size
        if self._source is not None:
            sizes = [int(n) for n in self._source.client_sizes]
            (xs, xd), (ys, yd) = self._source.row_meta()
        else:
            sizes = [len(ix) for ix in self.dataset.train_idx_map.values()]
            tx, ty = self.dataset.train_x, self.dataset.train_y
            (xs, xd), (ys, yd) = (tx.shape[1:], tx.dtype), (ty.shape[1:],
                                                            ty.dtype)
        counts = Counter(min(self.num_batches, -(-n // bs)) for n in sizes)
        counts.pop(0, None)  # empty clients dispatch nothing
        depths = sorted(counts, key=lambda b: (-counts[b], -b))[:4]
        deepest = max(counts) if counts else self.num_batches
        if deepest not in depths:
            depths = depths[:-1] + [deepest] if depths else [deepest]
        put = lambda a: torch.from_numpy(a).to(self.device)
        per_variant, t_all = {}, time.perf_counter()
        for B in sorted(depths):
            t0 = time.perf_counter()
            with float32_compute():
                self.local_update(
                    self.net, put(np.zeros((1, B, bs) + tuple(xs), xd)),
                    put(np.zeros((1, B, bs) + tuple(ys), yd)),
                    put(np.zeros((1, B, bs), np.float32)))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            per_variant[f"local_fit_b{B}"] = time.perf_counter() - t0
        return {"variants": list(per_variant), "per_variant": per_variant,
                "seconds": time.perf_counter() - t_all,
                "fresh_compiles": 0, "cache_hits": 0}

    def update_model(self, wire_leaves) -> None:
        self.net = unpack_pytree(self.net, wire_leaves, self.num_heads)

    def update_dataset(self, client_index: int) -> None:
        self.client_index = int(client_index)

    def pack(self, round_idx: int):
        """The assigned client's batches for ``round_idx`` (host arrays,
        leading axis 1)."""
        if self._source is not None:
            return pack_clients_source(
                self._source, [self.client_index], self.cfg.batch_size,
                max_batches=self.num_batches, seed=self.cfg.seed,
                round_idx=round_idx)
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

    def wire_leaves(self) -> list:
        """The rank's model as wire leaves (to the host, flax layout)."""
        return pack_pytree(self.net, self.num_heads)
