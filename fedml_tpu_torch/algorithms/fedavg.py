"""FedAvg on one GPU, port of fedml_tpu/algorithms/fedavg.py (``mesh=None``).

Reference behavior (fedml_api/standalone/fedavg/fedavg_api.py:40-115):
per round, sample clients -> each client runs local SGD from the global
weights -> the server takes the sample-weighted average of the returned
weights -> periodic eval on the global test set.

The JAX engine vmaps the cohort's local fits inside one jitted round
program; here the fits run one client after another on the device, which is
the same math. Mesh/SPMD drivers, round blocks, prefetch pipelines,
telemetry, robust aggregation and the other engine options are queued in
ROADMAP.md (queue A, items 5-8); passing one raises.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time

import numpy as np
import torch

from fedml_tpu_torch.core.client_data import (
    FederatedData,
    batch_global,
    pack_clients,
    pad_batches,
)
from fedml_tpu_torch.core.local import LocalSpec, Task, make_eval_fn, make_local_update
from fedml_tpu_torch.core.sampling import prepare_sampling, sample_for
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.utils.tree import tree_weighted_mean

log = logging.getLogger("fedml_tpu_torch.fedavg")


def agg_weights(nsamp: torch.Tensor, uniform: bool) -> torch.Tensor:
    """Aggregation weights: sample counts (FedAvg default) or, with
    ``uniform``, 1 per participating client / 0 for zero-sample padding."""
    if not uniform:
        return nsamp
    return (nsamp > 0).to(nsamp.dtype)


def eval_subset(tx, ty, cfg: "FedAvgConfig", call_idx: int):
    """Apply the eval_max_samples subset policy (see FedAvgConfig).
    ``call_idx`` only matters in 'fresh' mode, where each eval resamples
    (reference FedAVGAggregator.py:99-107)."""
    if cfg.eval_max_samples is None or len(tx) <= cfg.eval_max_samples:
        return tx, ty
    if cfg.eval_subset_mode == "fresh":
        rs = np.random.RandomState((cfg.seed * 1_000_003 + call_idx) & 0x7FFFFFFF)
    elif cfg.eval_subset_mode == "fixed":
        rs = np.random.RandomState(cfg.seed)
    else:
        raise ValueError(f"eval_subset_mode={cfg.eval_subset_mode!r} "
                         "(expected 'fixed' or 'fresh')")
    sel = rs.choice(len(tx), cfg.eval_max_samples, replace=False)
    return tx[sel], ty[sel]


@dataclasses.dataclass(frozen=True)
class FedAvgConfig:
    """Flag surface parity with the reference argparse and with
    fedml_tpu's FedAvgConfig (same fields, same defaults). FedAvgAPI
    raises on the values this slice does not run."""

    comm_round: int = 10
    client_num_in_total: int = 10
    client_num_per_round: int = 10
    epochs: int = 1
    batch_size: int = 32
    client_optimizer: str = "sgd"  # 'sgd' | 'adam'
    lr: float = 0.03
    wd: float = 0.0
    momentum: float = 0.0
    frequency_of_the_test: int = 5
    seed: int = 0
    max_batches: int | None = None  # static per-client batch budget (B)
    ci: bool = False  # truncate eval, reference --ci semantics
    eval_batch_size: int = 256
    eval_max_samples: int | None = None
    remat: bool = False
    eval_subset_mode: str = "fixed"
    sampling: str = "uniform"
    precision: str = "f32"
    local_test_on_all_clients: str = "auto"
    churn_trace: object | None = None


def make_client_optimizer(cfg: FedAvgConfig):
    """params -> optimizer: SGD(momentum, wd) or Adam(wd), as the reference
    builds per client (MyModelTrainer.py:24-32) and optax.sgd / optax.adam
    chained after add_decayed_weights compute in the JAX package."""
    if cfg.client_optimizer == "sgd":
        return functools.partial(torch.optim.SGD, lr=cfg.lr,
                                 momentum=cfg.momentum, weight_decay=cfg.wd)
    if cfg.client_optimizer == "adam":
        return functools.partial(torch.optim.Adam, lr=cfg.lr,
                                 weight_decay=cfg.wd)
    raise ValueError(cfg.client_optimizer)


def resolve_local_spec(local_spec: LocalSpec | None,
                       cfg: FedAvgConfig) -> LocalSpec:
    """The engine's LocalSpec: built from the config unless one is passed."""
    if cfg.precision not in ("f32", "float32"):
        raise NotImplementedError(
            f"precision={cfg.precision!r}: only float32 is ported (bf16: "
            "ROADMAP.md queue A, item 7)")
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet: ROADMAP.md "
                                  "queue A, item 4")
    if local_spec is not None:
        return local_spec
    return LocalSpec(optimizer=make_client_optimizer(cfg), epochs=cfg.epochs)


class FedAvgAPI:
    """Host-side round driver on one device (``device``: the CUDA device
    when None, see fedml_tpu_torch.device).

    State: ``net`` is the global model, a dict of parameter tensors on the
    device; ``history`` holds one record per eval round."""

    def __init__(self, dataset: FederatedData, task: Task,
                 config: FedAvgConfig, device=None,
                 local_spec: LocalSpec | None = None,
                 uniform_avg: bool = False, **unported):
        if unported:
            raise NotImplementedError(
                f"FedAvgAPI options {sorted(unported)} are not ported yet: "
                "ROADMAP.md queue A, items 5-8")
        if config.churn_trace is not None:
            raise NotImplementedError("churn_trace is not ported yet: "
                                      "ROADMAP.md queue A, item 8")
        self.data = dataset
        self.task = task
        self.cfg = config
        self.device = resolve_device(device)
        if self._eval_on_all_clients():
            raise NotImplementedError(
                "per-client eval (local_test_on_all_clients, "
                "evaluate_per_client) is not ported yet: ROADMAP.md queue A, "
                "item 5 — use a dataset without per-client test splits or "
                "local_test_on_all_clients='off'")
        # size_weighted sampling pairs with a uniform aggregate
        self.uniform_avg = uniform_avg or config.sampling == "size_weighted"
        self._client_sizes = prepare_sampling(config, dataset)

        # static per-client batch budget, fixed across rounds
        max_count = max(len(v) for v in dataset.train_idx_map.values())
        b_needed = int(np.ceil(max_count / config.batch_size))
        self.num_batches = min(config.max_batches or b_needed, b_needed)

        self.local_spec = resolve_local_spec(local_spec, config)
        self.local_update = make_local_update(task, self.local_spec)
        self.eval_fn = make_eval_fn(task)

        init = task.init(torch.Generator().manual_seed(config.seed))
        self.net = {k: v.to(self.device) for k, v in init.items()}
        self._test_cache = None
        self._eval_calls = 0
        self.history: list[dict] = []

    # ------------------------------------------------------------------ data
    def _sampled_ids(self, round_idx: int):
        return sample_for(self.cfg, round_idx, self._client_sizes)

    def _pack_round(self, round_idx: int, ids):
        """The round's ClientBatch, padded to the static batch budget."""
        cfg = self.cfg
        cb = pack_clients(self.data, ids, cfg.batch_size,
                          max_batches=self.num_batches, seed=cfg.seed,
                          round_idx=round_idx)
        return pad_batches(cb, self.num_batches)

    # ------------------------------------------------------------------ round
    def run_round(self, round_idx: int) -> dict:
        """One round: sample, pack, local fits, sample-weighted mean (the
        FedAvg server update is the identity on the mean). Returns the
        round's summed training metrics as device tensors."""
        ids = self._sampled_ids(round_idx)
        cb = self._pack_round(round_idx, ids)
        put = lambda a: torch.from_numpy(a).to(self.device)
        x, y, mask, nsamp = put(cb.x), put(cb.y), put(cb.mask), put(cb.num_samples)
        states, metrics = [], {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
        for k in range(len(ids)):
            state, m = self.local_update(self.net, x[k], y[k], mask[k])
            states.append(state)
            metrics = {n: metrics[n] + m[n] for n in metrics}
        stacked = {n: torch.stack([s[n] for s in states]) for n in self.net}
        self.net = tree_weighted_mean(stacked,
                                      agg_weights(nsamp, self.uniform_avg))
        return metrics

    def _eval_on_all_clients(self) -> bool:
        mode = self.cfg.local_test_on_all_clients
        if mode == "auto":
            return (self.data.test_idx_map is not None
                    and self.cfg.eval_max_samples is None)
        if mode in ("on", "off"):
            return mode == "on"
        raise ValueError(f"local_test_on_all_clients={mode!r} "
                         "(expected 'auto', 'on' or 'off')")

    def eval_record(self, round_idx: int, metrics) -> dict:
        """One eval-round history record: the round's training metrics plus
        the global test-set eval of the current model."""
        n = max(float(metrics["count"]), 1.0)
        ev = self.evaluate()
        return {
            "round": round_idx,
            "train_loss": float(metrics["loss_sum"]) / n,
            "train_acc": float(metrics["correct"]) / n,
            "test_loss": ev["loss"], "test_acc": ev["acc"],
        }

    def train(self, num_rounds: int | None = None):
        cfg = self.cfg
        rounds = num_rounds or cfg.comm_round
        for r in range(rounds):
            t0 = time.perf_counter()
            metrics = self.run_round(r)
            if (r % cfg.frequency_of_the_test == 0) or (r == rounds - 1):
                rec = self.eval_record(r, metrics)
                rec["round_time"] = time.perf_counter() - t0
                self.history.append(rec)
                log.info("round %d: %s", r, rec)
        return self.net

    # ------------------------------------------------------------------ state
    def load_state(self, net: dict):
        """Install a global model (a state dict, e.g. converted from the JAX
        package's params by fedml_tpu_torch.convert) on the engine's
        device."""
        if set(net) != set(self.net):
            raise ValueError(f"state keys {sorted(net)} do not match the "
                             f"model's {sorted(self.net)}")
        self.net = {k: torch.as_tensor(v).to(self.device, self.net[k].dtype)
                    for k, v in net.items()}

    # ------------------------------------------------------------------ eval
    def evaluate(self) -> dict:
        """Global test-set eval: {'loss', 'acc', 'count'}."""
        fresh = (self.cfg.eval_subset_mode == "fresh"
                 and self.cfg.eval_max_samples is not None
                 and len(self.data.test_x) > self.cfg.eval_max_samples)
        self._eval_calls += 1
        if self._test_cache is None or fresh:
            tx, ty = eval_subset(self.data.test_x, self.data.test_y,
                                 self.cfg, self._eval_calls)
            n = len(tx)
            if self.cfg.ci:
                n = min(n, 512)  # --ci truncation (FedAVGAggregator.py:126-131)
            self._test_cache = tuple(
                torch.from_numpy(a).to(self.device)
                for a in batch_global(tx[:n], ty[:n], self.cfg.eval_batch_size))
        return self.eval_fn(self.net, *self._test_cache)
