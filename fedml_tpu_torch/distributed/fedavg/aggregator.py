"""Server-side aggregator, port of fedml_tpu/distributed/fedavg/aggregator.py
(the synchronous, dense, stacked path): collect per-client results, take
their sample-weighted mean behind the sanitation gate, eval.

Mirror of fedml_api/distributed/fedavg/FedAVGAggregator.py —
add_local_trained_result (:44-48), check_whether_all_receive (:50-56),
aggregate (:58-87), client_sampling (:89-97),
test_on_server_for_all_clients (:109-163). As in the JAX package, uploads
are stamped (out-of-round and unknown-rank uploads are rejected and
counted), and the non-finite gate runs on every aggregate: a NaN upload is
dropped, counted and quarantined, never averaged.

Uploads arrive as wire leaves (flax layout) and are staged on the server's
device in the port's layout as they arrive (``_stage_upload``), the
counterpart of the reference's ``jax.device_put``. Robust estimators, an
armed norm gate, sharded server state, pairwise summation and fused
ingest are queued in ROADMAP.md (queue A, items 7 and 12); passing one
raises.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, float32_compute
from fedml_tpu_torch.comm.message import pack_pytree, unpack_pytree
from fedml_tpu_torch.convert import num_heads_of
from fedml_tpu_torch.core.client_data import FederatedData, batch_global
from fedml_tpu_torch.core.local import Task, make_eval_fn
from fedml_tpu_torch.core.robust_agg import (
    REASON_OK,
    QuarantineLedger,
    gated_aggregate,
)
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.obs import comm_instrument as _obs

log = logging.getLogger("fedml_tpu_torch.distributed.fedavg")


def refuse_unported(owner: str, options: dict) -> None:
    """``options``: name -> (set off its default?, ROADMAP item). Raise
    NotImplementedError naming the item of the first one set."""
    for name, (is_set, item) in options.items():
        if is_set:
            raise NotImplementedError(
                f"{owner} option {name} is not ported yet: ROADMAP.md "
                f"queue A, item {item}")


class FedAvgAggregator:
    def __init__(self, dataset: FederatedData, task: Task, cfg: FedAvgConfig,
                 worker_num: int, aggregator: str | None = None,
                 aggregator_params: dict | None = None,
                 sanitize: bool | float | None = None,
                 shard_server_state: bool = False,
                 partition_rules=None,
                 sum_assoc: str = "auto",
                 fused_agg: bool = False, device=None):
        refuse_unported("FedAvgAggregator", {
            "aggregator": (aggregator is not None, 7),
            "aggregator_params": (aggregator_params is not None, 7),
            "sanitize": (sanitize not in (None, False), 7),
            "shard_server_state": (bool(shard_server_state), 12),
            "partition_rules": (partition_rules is not None, 12),
            "sum_assoc": (sum_assoc != "auto", 7),
            "fused_agg": (bool(fused_agg), 7)})
        if cfg.sampling != "uniform":
            # this runtime's client_sampling + weighted aggregate implement
            # the uniform scheme only — refuse rather than silently ignore
            raise ValueError(
                f"sampling={cfg.sampling!r} is not wired for the "
                "cross-process runtime; use uniform")
        if cfg.churn_trace is not None:
            raise NotImplementedError("churn_trace is not ported yet: "
                                      "ROADMAP.md queue A, item 8")
        self.dataset, self.task, self.cfg = dataset, task, cfg
        self.device = resolve_device(device)
        self.worker_num = worker_num
        self.model_dict: dict[int, dict] = {}
        self.sample_num_dict: dict[int, int] = {}
        self.flag_client_model_uploaded = {i: False for i in range(worker_num)}
        # the round uploads are currently being accepted FOR — stamped by
        # the server manager at broadcast (begin_round); uploads tagged
        # with any other round are rejected, never slotted
        self.current_round = 0
        # the standalone engine's init, so every party (and the standalone
        # oracle) starts from identical weights
        init = task.init(torch.Generator().manual_seed(cfg.seed),
                         dataset.train_x[:cfg.batch_size])
        self.net = {k: v.to(self.device) for k, v in init.items()}
        # the wire layout's head count (a TransformerLM's; None otherwise)
        self.num_heads = num_heads_of(task.module)
        self._model_nbytes = sum(v.numel() * v.element_size()
                                 for v in self.net.values())
        self.eval_fn = make_eval_fn(task)
        self._test_cache = None
        self.history: list[dict] = []
        self.quarantine = QuarantineLedger()
        self._last_flush: dict | None = None

    def get_global_model_params(self):
        return pack_pytree(self.net, self.num_heads)

    # ------------------------------------------------------------- receive
    def _stage_upload(self, wire_leaves) -> dict:
        """The upload as a state dict on the server's device, copied there
        as it arrives (a synchronous copy: the stack at the barrier reads
        it from the server's own thread)."""
        return unpack_pytree(self.net, wire_leaves, self.num_heads)

    def begin_round(self, round_idx: int) -> None:
        """Stamp the round uploads are now accepted for (called by the
        server manager right before each broadcast)."""
        self.current_round = int(round_idx)

    def _admit_upload(self, index: int, round_idx: int | None) -> bool:
        """The upload-slotting admission rule (see
        :meth:`add_local_trained_result` for the reject vocabulary)."""
        if index not in self.flag_client_model_uploaded:
            _obs.record_stale_upload("unknown_rank")
            log.warning("reject upload for unknown worker index %s "
                        "(workers 0..%d)", index, self.worker_num - 1)
            return False
        if round_idx is not None and int(round_idx) != self.current_round:
            _obs.record_stale_upload("stale")
            log.warning("reject out-of-round upload from index %s "
                        "(tagged round %s, current %d)",
                        index, round_idx, self.current_round)
            return False
        return True

    def add_local_trained_result(self, index: int, wire_leaves,
                                 sample_num: int,
                                 round_idx: int | None = None) -> None:
        """Slot one client upload. Rejects (counted in
        ``comm_stale_uploads_total{reason}``, never slotted):

        - ``unknown_rank`` — ``index`` outside the worker table;
        - ``stale`` — ``round_idx`` given and != the stamped current round.

        ``round_idx=None`` (legacy caller) skips the round check only.
        """
        if not self._admit_upload(index, round_idx):
            return
        self.model_dict[index] = self._stage_upload(wire_leaves)
        self.sample_num_dict[index] = sample_num
        self.flag_client_model_uploaded[index] = True

    def check_whether_all_receive(self) -> bool:
        if not all(self.flag_client_model_uploaded.values()):
            return False
        for i in self.flag_client_model_uploaded:
            self.flag_client_model_uploaded[i] = False
        return True

    # ----------------------------------------------------------- aggregate
    def aggregate(self):
        self._aggregate_core()
        return pack_pytree(self.net, self.num_heads)

    def agg_record(self) -> dict:
        """The ``agg`` block the server manager rides on telemetry round
        records: server-state placement (one device: replicated) and the
        last flush's mode/latency/staging bytes."""
        rec = {"mode": "replicated"}
        if self._last_flush is not None:
            rec.update(self._last_flush)
        return rec

    def _aggregate_core(self):
        """Gate + weighted mean + ledger, updating ``self.net``: the
        non-finite rule always (the float wire path performs no clamping),
        an all-rejected round keeps the global model."""
        t0 = time.perf_counter()
        ranks = sorted(self.model_dict)
        if not ranks:
            log.warning("round %d: no decodable uploads — keeping the "
                        "current global model", self.current_round)
            return
        stacked = {k: torch.stack([self.model_dict[r][k] for r in ranks])
                   for k in self.net}
        weights = torch.tensor([float(self.sample_num_dict[r]) for r in ranks],
                               dtype=torch.float32, device=self.device)
        with float32_compute():
            avg, _, reasons = gated_aggregate(stacked, self.net, weights,
                                              norm_mult=float("inf"))
        reasons = reasons.cpu().numpy()
        if reasons.any():
            # slot i holds worker index ranks[i] -> 1-based rank + the
            # client id that rank trained this round
            ids = self.client_sampling(self.current_round)
            self.quarantine.record_codes(
                self.current_round, reasons,
                clients=[int(ids[r]) for r in ranks],
                ranks=[r + 1 for r in ranks])
            if (reasons != REASON_OK).all():
                log.warning("round %d: all %d uploads quarantined — "
                            "keeping the current global model",
                            self.current_round, len(ranks))
        self.net = avg
        self.model_dict.clear()
        self.sample_num_dict.clear()
        flush_s = time.perf_counter() - t0
        self._last_flush = {"fused": False, "flush_s": round(flush_s, 6),
                            "stack_bytes": int(self._model_nbytes
                                               * len(ranks))}
        log.info("aggregate time cost: %.3fs", flush_s)

    # ------------------------------------------------------------ sampling
    def client_sampling(self, round_idx: int) -> np.ndarray:
        return sample_clients(
            round_idx, self.cfg.client_num_in_total,
            self.cfg.client_num_per_round, self.cfg.seed)

    # ----------------------------------------------------------------- eval
    ci_eval_cap = 512  # --ci truncation (FedAVGAggregator.py:126-131)

    def test_on_server_for_all_clients(self, round_idx: int) -> None:
        cfg = self.cfg
        if round_idx % cfg.frequency_of_the_test != 0 and round_idx != cfg.comm_round - 1:
            return
        if self._test_cache is None:
            tx, ty = self.dataset.test_x, self.dataset.test_y
            if (cfg.eval_max_samples is not None
                    and len(tx) > cfg.eval_max_samples):
                # seeded validation subset — the reference server's 10k
                # stackoverflow cap (_generate_validation_set, :99-107)
                sel = np.random.RandomState(cfg.seed).choice(
                    len(tx), cfg.eval_max_samples, replace=False)
                tx, ty = tx[sel], ty[sel]
            n = len(tx)
            if cfg.ci:
                n = min(n, self.ci_eval_cap)
            self._test_cache = tuple(
                torch.from_numpy(a).to(self.device)
                for a in batch_global(tx[:n], ty[:n], cfg.eval_batch_size))
        self._record_eval(round_idx)

    def _record_eval(self, round_idx: int) -> None:
        with float32_compute():
            ev = self.eval_fn(self.net, *self._test_cache)
        rec = {"round": round_idx, "test_loss": float(ev["loss"]),
               "test_acc": float(ev["acc"])}
        self.history.append(rec)
        log.info("server eval %s", rec)
