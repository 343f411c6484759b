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
counterpart of the reference's ``jax.device_put``.

Byzantine-robust aggregation (core/robust_agg.py): ``aggregator=`` swaps
the weighted mean for a robust estimator, ``sanitize=`` arms the
norm-outlier rule, and ``sum_assoc='pairwise'`` folds with the canonical
pairwise association — with an aggregator, through the two-phase
evidence/verdict composition (``make_verdict_estimator``). The server runs
the same ``gated_aggregate`` as the engine over the same stacked state
layout, so the two runtimes' quarantine ledgers agree entry for entry.
The aggregation families (fed_agg_bytes_total, fed_flush_seconds,
fed_agg_stack_bytes, fed_server_state_bytes: obs/perf_instrument.py) are
fed from every flush. Sharded server state (item 12) is queued in
ROADMAP.md, queue A; passing it raises.

Fused on-device ingest (``fused_agg=True``, core/fused_agg.py): an upload
arrives as its raw wire payload and is densified on the server's device
against the device-resident broadcast stash (``add_fused_result``), gated,
and folded into the round's canonical pairwise partials at once, so no
per-client dense tree is built on the host and the fold needs O(log K)
partials. Robust estimators and the armed norm gate run the STAGED fused
mode (raw slots on the device, one stacked verdict flush). Either way the
result is bitwise the stacked ``sum_assoc='pairwise'`` route, model and
ledger; fused implies ``sum_assoc='pairwise'``.
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
from fedml_tpu_torch.core.client_source import ClientDataSource
from fedml_tpu_torch.core.local import Task, make_eval_fn, refuse_extras
from fedml_tpu_torch.core.robust_agg import (
    DEFAULT_NORM_MULT,
    REASON_OK,
    QuarantineLedger,
    gated_aggregate,
    make_robust_aggregator,
    make_verdict_estimator,
)
from fedml_tpu_torch.core.sampling import sample_available, sample_clients
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.obs import comm_instrument as _obs
from fedml_tpu_torch.obs import perf_instrument as _perf

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
            "shard_server_state": (bool(shard_server_state), 12),
            "partition_rules": (partition_rules is not None, 12)})
        # the dense synchronous flat server carries a model's extras; the
        # robust, fused, DP, masked and tree servers do not yet
        if type(self) is not FedAvgAggregator:
            refuse_extras(task, type(self).__name__)
        refuse_extras(task, "FedAvgAggregator", {
            "aggregator": aggregator, "sanitize": sanitize or None,
            "fused_agg": fused_agg})
        if sum_assoc not in ("auto", "pairwise"):
            raise ValueError(f"sum_assoc={sum_assoc!r} "
                             "(expected 'auto' or 'pairwise')")
        if fused_agg:
            if not type(self)._stage_uploads_on_arrival:
                raise ValueError(
                    f"{type(self).__name__} aggregates on the HOST "
                    "representation — fused_agg needs the device-staged "
                    "float path (run the stacked route)")
            # the fused fold IS the canonical pairwise association
            sum_assoc = "pairwise"
        if cfg.sampling != "uniform":
            # this runtime's client_sampling + weighted aggregate implement
            # the uniform scheme only — refuse rather than silently ignore
            raise ValueError(
                f"sampling={cfg.sampling!r} is not wired for the "
                "cross-process runtime; use uniform")
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
        # heartbeat-driven cohort admission: worker INDICES the server
        # manager excluded from this round's cohort (heartbeat age past the
        # threshold) — the barrier does not wait for them, but an excluded
        # rank that uploads anyway (it just resumed) is still folded in
        self.excluded: set[int] = set()
        # async buffered flush (server_manager async mode): slot ->
        # (1-based worker rank, trained client id) for ledger attribution —
        # buffered slots are arrival positions, not worker indices, and a
        # buffer may fold several waves of one rank into one aggregate
        self._async_meta: dict[int, tuple[int, int]] | None = None
        # slot -> the bare staleness discount of an async flush (None on a
        # sync round): an aggregate that replaces the sample-count half of
        # the weight keeps the staleness half (DP's uniform average)
        self._async_discounts: dict[int, float] | None = None
        # the standalone engine's init, so every party (and the standalone
        # oracle) starts from identical weights
        init = task.init(torch.Generator().manual_seed(cfg.seed),
                         dataset.init_batch(cfg.batch_size)
                         if isinstance(dataset, ClientDataSource)
                         else dataset.train_x[:cfg.batch_size])
        self.net = {k: v.to(self.device) for k, v in init.items()}
        # the wire layout's head count (a TransformerLM's; None otherwise)
        self.num_heads = num_heads_of(task.module)
        self._model_nbytes = sum(v.numel() * v.element_size()
                                 for v in self.net.values())
        # the server plane's per-device bytes (the model; the server
        # optimizer state is none until FedOpt, item 9), one device:
        # replicated
        _perf.set_server_state_bytes("replicated", self._model_nbytes)
        self.eval_fn = make_eval_fn(task)
        self._test_cache = None
        self.history: list[dict] = []
        self.quarantine = QuarantineLedger()
        self._last_flush: dict | None = None
        # gate -> estimator -> suspected merge -> all-rejected fallback,
        # the composition the engine runs. The gate runs every aggregate:
        # its norm rule arms with ``sanitize`` (None = on iff an aggregator
        # is set), the non-finite rule is unconditional (the float wire
        # ships the sender's bits verbatim)
        robust = verdict_fn = None
        if aggregator is not None:
            build = (make_verdict_estimator if sum_assoc == "pairwise"
                     else make_robust_aggregator)
            fn = build(aggregator, n=worker_num, **(aggregator_params or {}))
            if sum_assoc == "pairwise":
                verdict_fn = fn
            else:
                robust = fn
        if sanitize is None:
            sanitize = aggregator is not None
        self._sanitize_mult = (
            None if sanitize is False
            else DEFAULT_NORM_MULT if sanitize is True else float(sanitize))
        self.sum_assoc = sum_assoc
        self._gagg_kw = dict(
            robust_fn=robust, verdict_fn=verdict_fn,
            norm_mult=(float("inf") if self._sanitize_mult is None
                       else self._sanitize_mult),
            pairwise=sum_assoc == "pairwise" and verdict_fn is None)
        # fused ingest: plain mode folds at arrival; estimators and the
        # armed norm gate need the cohort, so they stage (STAGED mode)
        self.fused_agg = bool(fused_agg)
        self._fused_staged = self.fused_agg and (
            aggregator is not None or self._sanitize_mult is not None)
        self._fused = None  # the active round's FusedRoundIngest
        self._fused_ingest: dict[str, object] = {}
        if self.fused_agg:
            from fedml_tpu_torch.comm.message import _wire_spec
            from fedml_tpu_torch.core import fused_agg as _fused_mod

            spec = _wire_spec(tuple((k, tuple(v.shape)) for k, v in
                                    sorted(self.net.items())),
                              self.num_heads)
            # (shape, numpy dtype) of each wire leaf: the densify's meta
            self._fused_meta = [(shape, np.dtype(dt))
                                for _, shape, dt in spec]
            self._wire_paths = [path for path, _, _ in spec]
            self._fused_term_nbytes = _fused_mod.term_nbytes(self.net)
            if self._fused_staged:
                self._fused_flush = _fused_mod.make_fused_robust_flush(
                    verdict_fn, norm_mult=self._gagg_kw["norm_mult"])

    def get_global_model_params(self):
        return pack_pytree(self.net, self.num_heads)

    def wire_to_state(self, leaves) -> dict:
        """Dense wire leaves on the device -> the server's state dict on
        the device (``convert.from_flax`` of the device tensors: a
        permutation of their values)."""
        from fedml_tpu_torch.convert import from_flax

        params: dict = {}
        for path, leaf in zip(self._wire_paths, leaves):
            node = params
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        state = from_flax(params)
        return {k: state[k].to(v.device, v.dtype)
                for k, v in self.net.items()}

    # ------------------------------------------------------------- receive
    # Stage-on-arrival: each upload moves to the server's device as its
    # frame arrives, instead of all K at the round barrier under the round
    # lock. A subclass whose aggregate reworks every upload itself first
    # (the robust clip) opts out and keeps the wire leaves until then.
    _stage_uploads_on_arrival = True

    def _stage_upload(self, wire_leaves):
        """The upload as a state dict on the server's device, copied there
        as it arrives (a synchronous copy: the stack at the barrier reads
        it from the server's own thread); the wire leaves themselves when
        the class opts out of staging."""
        if not type(self)._stage_uploads_on_arrival:
            return wire_leaves
        return unpack_pytree(self.net, wire_leaves, self.num_heads)

    def _staged(self, upload) -> dict:
        """An upload slot as a state dict on the server's device, staged
        or not."""
        if isinstance(upload, dict):
            return upload
        return unpack_pytree(self.net, upload, self.num_heads)

    def begin_round(self, round_idx: int) -> None:
        """Stamp the round uploads are now accepted for (called by the
        server manager right before each broadcast)."""
        self.current_round = int(round_idx)
        # fused ingest state is per round: a fresh accumulator against the
        # round's own global model (arrivals gate against it)
        self._fused = None

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

    def add_fused_result(self, index: int, kind: str, payload, scales,
                         sample_num, round_idx: int | None,
                         base_leaves) -> None:
        """Fused twin of :meth:`add_local_trained_result`: the upload
        arrives as its RAW wire payload (``kind`` one of
        core/fused_agg.FUSED_KINDS) plus the device-resident broadcast it
        encoded against, and is densified, gated and folded (or staged) on
        the device at once. Same admission rule and barrier bookkeeping as
        the stacked path."""
        if not self._admit_upload(index, round_idx):
            return
        if self._fused is None:
            self._fused = self._make_fused_round()
        self._fused.add(index, self._fused_ingest_fn(kind), payload,
                        scales, base_leaves, float(sample_num))
        self.sample_num_dict[index] = sample_num
        self.flag_client_model_uploaded[index] = True

    def _make_fused_round(self):
        from fedml_tpu_torch.core.fused_agg import FusedRoundIngest

        return FusedRoundIngest(self.net, staged=self._fused_staged)

    def _fused_ingest_fn(self, kind: str):
        """The per-kind arrival composition, built once and cached."""
        fn = self._fused_ingest.get(kind)
        if fn is None:
            from fedml_tpu_torch.core import fused_agg as _fused_mod

            build = (_fused_mod.make_fused_robust_ingest
                     if self._fused_staged
                     else _fused_mod.make_fused_ingest)
            fn = build(kind, self._fused_meta, self.wire_to_state,
                       self.device)
            self._fused_ingest[kind] = fn
        return fn

    def make_fused_densify(self, kind: str):
        """The async door's arrival densify for ``kind``: ``fn(payload,
        scales, base_leaves) -> (state, finite)``."""
        from fedml_tpu_torch.core.fused_agg import make_fused_densify

        return make_fused_densify(kind, self._fused_meta, self.wire_to_state,
                                  self.device)

    def load_buffered(self, entries, weights, discounts=None) -> None:
        """Populate the aggregation slots from an async buffer drain
        (server_manager async mode): slot i carries ``entries[i]``'s staged
        state with its staleness-DISCOUNTED weight, and the (rank, client)
        side table routes quarantine verdicts to the true worker rank. The
        next ``aggregate()`` — the subclass's composition, so the robust
        clip and noise apply to the buffered aggregate unchanged —
        consumes and clears the slots as usual. With constant discount the
        weights are bitwise the sample counts, which is the weight half of
        the K=cohort sync-parity contract. ``discounts`` is the bare
        per-slot staleness multiplier, kept aside for the DP uniform
        average (fedavg_robust.py)."""
        self.model_dict.clear()
        self.sample_num_dict.clear()
        self._async_meta = {}
        self._async_discounts = (None if discounts is None
                                 else {i: float(d)
                                       for i, d in enumerate(discounts)})
        if self.fused_agg:
            # fused async drain: the entries arrived densified on the
            # device; the gate (or the staging) runs here, against the
            # flush-time global, exactly when the stacked route gates
            self._fused = self._make_fused_round()
            for slot, (e, w) in enumerate(zip(entries, weights)):
                self._fused.add_state(slot, e.payload, float(w))
                self.sample_num_dict[slot] = float(w)
                self._async_meta[slot] = (int(e.rank), int(e.client))
            return
        for slot, (e, w) in enumerate(zip(entries, weights)):
            self.model_dict[slot] = e.payload
            self.sample_num_dict[slot] = float(w)
            self._async_meta[slot] = (int(e.rank), int(e.client))

    def check_whether_all_receive(self) -> bool:
        if any(not v for i, v in self.flag_client_model_uploaded.items()
               if i not in self.excluded):
            # heartbeat-excluded indices never block the barrier; everyone
            # else must report (or the elastic watchdog trips)
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
        if self.cfg.precision not in ("f32", "float32"):
            # the cfg's client-compute policy (every rank shares the cfg)
            rec["prec"] = self.cfg.precision
        if self._last_flush is not None:
            rec.update(self._last_flush)
        return rec

    def _record_reasons(self, slots, reasons: np.ndarray) -> None:
        """Suspected and rejected slots into the ledger: slot ``i`` is
        worker index ``slots[i]`` (async: an arrival position, attributed
        through the side table the server manager staged)."""
        if not reasons.any():
            return
        if self._async_meta is not None:
            rank_l = [self._async_meta[r][0] for r in slots]
            client_l = [self._async_meta[r][1] for r in slots]
        else:
            # slot i holds worker index slots[i] -> 1-based rank + the
            # client id that rank trained this round
            ids = self.client_sampling(self.current_round)
            rank_l = [r + 1 for r in slots]
            client_l = [int(ids[r]) for r in slots]
        self.quarantine.record_codes(
            self.current_round, reasons, clients=client_l, ranks=rank_l)
        if (reasons != REASON_OK).all():
            log.warning("round %d: all %d uploads quarantined — "
                        "keeping the current global model",
                        self.current_round, len(slots))

    def _aggregate_fused(self):
        """The fused flush: arrivals were densified and gated on the
        device already — plain mode merges the pairwise partials and
        divides once; staged mode runs the stacked verdict composition
        over the staged slots. Bitwise the stacked ``sum_assoc=
        'pairwise'`` route over the same arrived slots, ledger included."""
        t0 = time.perf_counter()
        fr, self._fused = self._fused, None
        if fr is None or not fr.slots:
            log.warning("round %d: no decodable uploads — keeping the "
                        "current global model", self.current_round)
            self.sample_num_dict.clear()
            return
        slots = sorted(fr.slots)
        with float32_compute():
            if fr.staged_mode:
                avg, _vw, reasons = fr.flush_robust(self._fused_flush)
            else:
                avg, reasons = fr.flush()
        # staged slots are O(K), the stacked route's bytes; partials
        # O(log K) in order: each under its own gauge mode
        mode = "fused_staged" if fr.staged_mode else "fused"
        stack_bytes = fr.peak_terms * self._fused_term_nbytes
        _perf.record_agg_bytes("replicated", self._model_nbytes * len(slots))
        _perf.set_agg_stack_bytes(mode, stack_bytes)
        self._record_reasons(slots, reasons.cpu().numpy())
        self.net = avg
        self.sample_num_dict.clear()
        flush_s = time.perf_counter() - t0
        _perf.record_flush_seconds(flush_s)
        self._last_flush = {"fused": True, "flush_s": round(flush_s, 6),
                            "stack_bytes": int(stack_bytes)}
        log.info("fused aggregate time cost: %.3fs (%d %s peak)", flush_s,
                 fr.peak_terms,
                 "staged slots" if fr.staged_mode else "partials")

    def _aggregate_core(self):
        """Gate + estimator + ledger, updating ``self.net``: the
        non-finite rule always (the float wire path performs no clamping),
        suspected and rejected slots into the ledger, an all-rejected
        round keeps the global model."""
        if self.fused_agg:
            return self._aggregate_fused()
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
                                              **self._gagg_kw)
        # bytes folded this round: an elastic partial aggregation may stack
        # fewer than worker_num uploads — count the realized cohort
        _perf.record_agg_bytes("replicated", self._model_nbytes * len(ranks))
        self._record_reasons(ranks, reasons.cpu().numpy())
        self.net = avg
        self.model_dict.clear()
        self.sample_num_dict.clear()
        flush_s = time.perf_counter() - t0
        _perf.record_flush_seconds(flush_s)
        _perf.set_agg_stack_bytes("stacked", self._model_nbytes * len(ranks))
        self._last_flush = {"fused": False, "flush_s": round(flush_s, 6),
                            "stack_bytes": int(self._model_nbytes
                                               * len(ranks))}
        log.info("aggregate time cost: %.3fs", flush_s)

    # ------------------------------------------------------------ sampling
    def client_sampling(self, round_idx: int) -> np.ndarray:
        trace = self.cfg.churn_trace
        if trace is not None:
            ids = sample_available(self.cfg, round_idx, trace)
            k = self.cfg.client_num_per_round
            if len(ids) < k:
                # the cross-process cohort is one client per worker RANK —
                # slots stay fully populated: in a trough the available
                # cohort re-assigns clients to several ranks (cycle-pad,
                # deterministic); rank-level scheduled-offline skipping is
                # what shrinks the realized round
                ids = np.resize(ids, k)
            return ids
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
