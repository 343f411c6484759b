"""FedAvg server manager, port of fedml_tpu/distributed/fedavg/server_manager.py
(synchronous rounds, elastic): round coordination over the comm layer.

Mirror of fedml_api/distributed/fedavg/FedAvgServerManager.py: send_init_msg
(:31-39), handle_message_receive_model_from_client (:45-82, aggregate when
all received, eval, resample, sync), send_message_sync_model_to_client
(:90-95).

Elastic extension (as in the JAX package): with ``round_timeout_s`` set, a
round that stalls past the deadline aggregates over the clients that DID
report (sample-weighted, so the average stays exact over the
participants) and moves on; a send to an unreachable rank is dropped and
the rank reprobed every ``_DEAD_RANK_REPROBE_ROUNDS`` rounds; late uploads
from superseded rounds are round-tagged and dropped.

Encoded uplinks (top-k, delta and quantized tiers) densify against the
broadcast of the version they name, stashed as clients hold it; a payload
that does not decode is quarantined ``undecodable`` and counted. With
``delta_broadcast`` warm ranks get the round delta instead of the model.
With a ``Telemetry`` bundle the server emits one record a round (its
``aggregate`` and ``eval`` spans, update norm, comm bytes) and, when the
bundle traces, rides trace context on each broadcast and stitches the
clients' spans into the round's timeline.

Crash recovery (the JAX package's; docs/ROBUSTNESS.md §Server crash
recovery there): with ``ckpt_dir`` the server checkpoints after every
aggregate (core/checkpoint.py, the npz layout both packages read) and
journals its round lifecycle to the durable WAL at ``<ckpt_dir>/wal``
(core/wal.py). A fresh server boots through replay -> journal ``restart``
-> restore: the newest restorable checkpoint is the state authority, an
open round re-runs behind a resume probe under a new restart epoch, every
upload the dead server had accepted is ledgered ``server_restart``, and the
epoch gate sheds pre-crash uploads. Chaos ``crash`` rules naming rank 0 kill
the server at its journaled crash points (:class:`SimulatedServerCrash`).

Buffered-async mode (``async_buffer_k=K``) replaces the barrier with an
event-driven loop: each upload is admitted (staleness bound / non-finite
quarantine), staged into a bounded buffer (core/async_buffer.py), and its
rank immediately re-dispatched; K staged arrivals (or
``buffer_deadline_s``) flush one staleness-discounted aggregate through the
aggregator's usual composition. ``heartbeat_max_age_s`` arms
heartbeat-driven cohort admission on BOTH modes.

A ``churn_trace`` (chaos/churn.py ChurnTrace) arms RANK-level scheduled
availability: a rank the trace marks away for the round's window is
skipped silently at dispatch (no suspect bookkeeping, no reprobe churn)
and leaves the barrier's denominator; only a rank the trace expects here
rides the suspected-dead paths. A DP aggregator (distributed/
fedavg_robust.py) checkpoints its noise key and RDP totals, and recovery
re-charges its accountant from the WAL's ``precharge`` records past the
commit, so a crash never under-reports ε.

With a ``Telemetry(fleet=True)`` bundle every broadcast and async dispatch
carries the fleet marker (``__telemetry``), the ranks piggyback digests on
their uploads and the server ingests each before any gate (obs/fleet.py);
off, no frame carries the key. Sync rounds and async flushes carry a
duty-only ``goodput`` block (the server runs no device round program of
its own: wire wait, aggregation flush and the rest of the wall,
obs/goodput.py). With a fused aggregator (``fused_agg=True``) an upload's
host work is structural validation only: the densify against the
device-resident broadcast stash, the gate and the fold run on the
server's device at arrival (``_stage_fused``; the async door densifies and
the drain gates, ``_decode_upload_fused``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

import numpy as np
import torch

from fedml_tpu_torch.comm.managers import ServerManager
from fedml_tpu_torch.comm.message import (
    Message,
    check_wire_leaves,
    codec_roundtrip,
)
from fedml_tpu_torch.core.local import refuse_extras
from fedml_tpu_torch.data import dataset_source
from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.obs import comm_instrument as _obs
from fedml_tpu_torch.obs import goodput as _goodput
from fedml_tpu_torch.obs.tracing import TRACE_KEY

log = logging.getLogger("fedml_tpu_torch.distributed.fedavg")


class SimulatedServerCrash(BaseException):
    """Deterministic SIGKILL analogue for loopback supervision (chaos
    ``crash`` rules naming rank 0): raised at a journaled crash point and
    deliberately a BaseException so no elastic/chaos ``except Exception``
    swallows it. Only the supervision driver (``run_simulated``) catches
    it: the dead manager's transport is abandoned without any farewell
    frame and a FRESH manager boots through the real checkpoint + WAL
    recovery path."""

    def __init__(self, round_idx: int, point: str):
        super().__init__(f"simulated server crash at round {round_idx} "
                         f"({point})")
        self.round_idx, self.point = round_idx, point


class FedAvgServerManager(ServerManager):
    def __init__(self, aggregator: FedAvgAggregator, rank=0, size=0,
                 backend="LOOPBACK", round_timeout_s: float | None = None,
                 ckpt_dir: str | None = None, telemetry=None,
                 wal_dir: str | None = None,
                 async_buffer_k: int | None = None,
                 staleness="constant", staleness_bound: int | None = None,
                 buffer_deadline_s: float | None = None,
                 buffer_capacity: int | None = None,
                 heartbeat_max_age_s: float | None = None,
                 delta_broadcast: bool = False, churn_trace=None, **kw):
        # scheduled availability (chaos/churn.py ChurnTrace, or None): a
        # rank the trace marks away for the current round's window is
        # EXPECTED silent — skipped at dispatch with no send, no
        # suspect/undeliverable bookkeeping, no reprobe or backoff churn —
        # and subtracted from the barrier's denominator; only a rank the
        # trace expects here rides the suspected-dead paths
        refuse_extras(aggregator.task, "FedAvgServerManager", {
            "async_buffer_k": async_buffer_k,
            "delta_broadcast": delta_broadcast})
        self.churn_trace = churn_trace
        self._offline_now: set[int] = set()
        # ranks whose dispatch was skipped for scheduled offline — the
        # flush-time reprobe re-dispatches them the moment the trace
        # brings them back (async mode's "resume on the next arrival")
        self._offline_skipped: set[int] = set()
        self._idle_rounds = 0
        self._idle_logged_round: int | None = None
        if churn_trace is not None:
            # pre-register the churn families at zero so a churn-driven
            # run's export always carries them
            _obs.ensure_churn_families()
        self.aggregator = aggregator
        self.round_num = aggregator.cfg.comm_round
        self.round_idx = 0
        # version -> the broadcast AS CLIENTS HOLD IT (decoded through the
        # frame codec; under delta_broadcast the exact chain value). Every
        # encoded uplink names the version it encoded against via its
        # ROUND tag and densifies against THIS table; a version never
        # stashed is a loud protocol error.
        self._version_pack: dict[int, list] = {}
        # fused on-device ingest (aggregator.fused_agg): the same stash as
        # device tensors, which the arrival densify decodes against
        self._fused = bool(getattr(aggregator, "fused_agg", False))
        self._version_dev: dict[int, list] = {}
        self._fused_densify: dict[str, object] = {}  # async door, per kind
        # rank -> the version its last upload PROVED it holds (the upload's
        # round tag): the delta-broadcast warm set. Proof-based tracking
        # self-heals to the dense fallback after a dropped frame.
        self._rank_version: dict[int, int] = {}
        # round-delta downlink: warm ranks get global@r - global@r-1, cold
        # ranks (joiners, ranks that missed a round) the dense fallback
        self.delta_broadcast = bool(delta_broadcast)
        self.round_timeout_s = round_timeout_s
        self.ckpt_dir = ckpt_dir
        # Buffered-async mode: ``async_buffer_k`` arms the event-driven
        # loop — clients train continuously against possibly-stale
        # globals, each upload is admitted (staleness bound; non-finite
        # quarantined at the door), staged into a bounded AsyncBuffer
        # (overflow sheds the stalest, counted, never blocks), and a full
        # buffer (or deadline) flushes a staleness-discounted gated
        # aggregate, after which the uploading ranks are immediately
        # re-dispatched with the fresh global. ``round_idx`` then counts
        # GLOBAL UPDATES (buffer flushes), so the checkpoint/eval/telemetry
        # cadence carries over unchanged. None = the synchronous barrier.
        self._async = async_buffer_k is not None
        self._buffer = None
        if self._async and self.delta_broadcast:
            log.warning("delta_broadcast ignored in async buffered mode: "
                        "per-rank dispatch holds arbitrary versions, so "
                        "downlinks stay dense (uplink delta/quantized "
                        "tiers still apply)")
            self.delta_broadcast = False
        self._staleness_bound = staleness_bound
        if self._async:
            from fedml_tpu_torch.core.async_buffer import (AsyncBuffer,
                                                           StalenessPolicy)
            from fedml_tpu_torch.obs import perf_instrument as _perf

            self._staleness = StalenessPolicy.from_spec(
                staleness, bound=staleness_bound)
            self._discount_np = self._staleness.discount_np()
            self._buffer = AsyncBuffer(int(async_buffer_k),
                                       capacity=buffer_capacity)
            self.buffer_deadline_s = buffer_deadline_s
            self._buffer_epoch = 0
            self._buffer_first_t: float | None = None
            # per-rank dispatch counters (the sampling key: rank r's n-th
            # dispatch trains client_sampling(n)[r-1], the structure the
            # sync round loop uses) and the bound-0 parking lot (see
            # StalenessPolicy.synchronous)
            self._dispatch_wave: dict[int, int] = {}
            # rank -> the ONE outstanding dispatch's wave: the upload gate
            # folds exactly the wave it awaits, so a reprobe's superseded
            # twin (or a chaos duplicate) is dropped instead of spawning a
            # second self-perpetuating dispatch stream
            self._awaiting: dict[int, int] = {}
            self._parked: list[int] = []
            self._last_dispatch_version: dict[int, int] = {}
            self._bcast_version = -1
            self._bcast_pack = None
            # graceful drain: after the last flush the server keeps its
            # receive loop up until every outstanding dispatch's upload
            # landed (and was discarded); a grace timer bounds the wait
            # when a rank crashed mid-dispatch
            self._draining = False
            self._drain_grace_s = round_timeout_s or 2.0
            # reprobe grace is WALL-CLOCK, not versions: with small K
            # global updates can elapse faster than one slow rank's honest
            # fit — a wave is only declared lost after this many SECONDS
            # since its dispatch
            self._reprobe_grace_s = (round_timeout_s or buffer_deadline_s
                                     or 30.0)
            self._last_dispatch_t: dict[int, float] = {}
            # per-JOB shed tally for round records (the registry counter is
            # process-cumulative)
            self._shed_counts: dict[str, int] = {}
            # pre-register every shed reason so the Prometheus export
            # carries the full fed_async_shed_total family
            _perf.ensure_async_shed_families()
        self.heartbeat_max_age_s = heartbeat_max_age_s
        # rank -> round its delivery last failed. Initialized HERE, not
        # lazily at first failure: two sender paths (round loop + watchdog
        # thread) can fail concurrently.
        self._undeliverable: dict[int, int] = {}
        self._round_ids: list[int] = []
        # round-economics stamps (monotonic seconds; telemetry only)
        self._gp_bcast_start_t = self._gp_bcast_end_t = None
        self._gp_last_arrival_t = self._gp_prev_flush_t = None
        # obs.Telemetry: per-round event records (sampled ids, aggregate/eval
        # span timings, update norm, comm byte/message deltas). None = no
        # extra work.
        self.telemetry = telemetry
        # cross-rank tracer (obs/tracing.py): present only when the
        # Telemetry bundle opted in (trace_dir / trace=True). None = no
        # __trace params on any frame — the wire is byte-identical.
        self._dtracer = telemetry.tracer if telemetry is not None else None
        # fleet observability plane (obs/fleet.py): present only when the
        # bundle armed a collector (Telemetry(fleet=True)). None = no
        # __telemetry marker on any frame — the wire is byte-identical.
        self._fleet = getattr(telemetry, "fleet", None)
        if telemetry is not None:
            import dataclasses

            from fedml_tpu_torch.obs.tracing import RoundTracer

            self._tracer = RoundTracer(sink=self._dtracer)
            telemetry.run_header(dataclasses.asdict(aggregator.cfg),
                                 engine="distributed", backend=backend,
                                 world_size=size,
                                 dataset_source=dataset_source(
                                     aggregator.dataset),
                                 tracing=self._dtracer is not None)
        # ---- server crash recovery: a ckpt_dir implies the durable round
        # WAL next to it (override with wal_dir). Boot order matters:
        # replay FIRST (the restart epoch and the open-round evidence),
        # then open the log for append and journal this boot, then
        # restore state.
        self.wal = None
        self._wal_replay = None
        self._restart_epoch = 0
        self._resume_round: int | None = None
        self._resume_pending: set[int] = set()
        self._resume_acks: dict[int, tuple[int, int]] = {}
        self._crash_plan: list[tuple[int, int | None]] = []
        self._sim_crash: SimulatedServerCrash | None = None
        self._uploads_this_round = 0
        if wal_dir is None and ckpt_dir is not None:
            wal_dir = os.path.join(ckpt_dir, "wal")
        if wal_dir is not None:
            from fedml_tpu_torch.core.wal import RoundWAL
            from fedml_tpu_torch.obs import perf_instrument as _perf

            self._wal_replay = RoundWAL.replay(wal_dir)
            self._restart_epoch = self._wal_replay.restart_epochs
            self.wal = RoundWAL(wal_dir)
            self.wal.append("restart", sync=True,
                            epoch=self._restart_epoch)
            # the aggregator journals its own durable records (a DP
            # aggregator's pre-charge, fsync'd before its noise key draw)
            self.aggregator.wal = self.wal
            _perf.ensure_restart_families()
            _perf.sync_server_restarts(self._restart_epoch)
            # quarantine verdicts ride the WAL as a forensic trail (the
            # ledger's commit-time authority is quarantine.json)
            self.aggregator.quarantine.journal = (
                lambda e: self.wal.append("quarantine", **e))
            if self._buffer is not None:
                # async buffer membership rides the WAL: recovery ledgers
                # exactly the admitted-and-unflushed entries that died
                # with the process
                self._buffer.journal = self._journal_buffer
            if self._restart_epoch:
                log.warning("server restart epoch %d (WAL at %s): "
                            "recovering", self._restart_epoch, wal_dir)
        if ckpt_dir is not None or self._wal_replay is not None:
            self._maybe_resume()
        self._round_lock = threading.Lock()
        self._validate_world_size(size)
        ts = kw.pop("timeout_s", None)
        if round_timeout_s is not None and round_timeout_s <= 0:
            # 0 would arm the elastic error-swallowing but DISARM the
            # watchdog ('or' treats 0.0 as unset) — a silent permanent hang
            raise ValueError(f"round_timeout_s={round_timeout_s} must be > 0")
        if round_timeout_s is not None:
            # elastic mode: a send to a dead/unreachable client must not
            # absorb more than one round deadline (the gRPC default is a
            # 600 s boot-tolerance window) — and its failure is handled
            # (the client becomes a straggler), not fatal
            kw.setdefault("send_timeout_s", round_timeout_s)
        super().__init__(rank, size, backend, timeout_s=round_timeout_s or ts, **kw)
        _obs.set_ranks_alive(size - 1)  # all peers presumed reachable at boot

    def _validate_world_size(self, size: int) -> None:
        """One worker process per sampled client (FedAvgAPI.py:20-28
        launches client_num_per_round+1 ranks); a deficit would silently
        aggregate fewer clients than configured."""
        if size - 1 != self.aggregator.cfg.client_num_per_round:
            raise ValueError(
                f"worker count {size - 1} != client_num_per_round="
                f"{self.aggregator.cfg.client_num_per_round}"
            )

    # a rank whose delivery failed is probed again only every k-th round:
    # one dead peer must not cost every round a full send deadline, but a
    # REBOOTED peer must still be able to rejoin
    _DEAD_RANK_REPROBE_ROUNDS = 4

    def _update_alive_gauge(self) -> None:
        """fed_ranks_alive from the undeliverable bookkeeping; scheduled-
        offline ranks count as not alive alongside the undeliverable set,
        so a diurnal trough never looks like an outage. World size may be
        unknown on a partially-built instance (tests drive the admission
        paths without the comm stack)."""
        size = getattr(self, "size", None)
        if size is not None:
            dead = set(self._undeliverable) | self._offline_now
            _obs.set_ranks_alive(size - 1 - len(dead))

    def _scheduled_offline(self) -> set[int]:
        """The churn trace's scheduled-offline rank set for the CURRENT
        round's window (empty with no trace). Publishes the
        fed_ranks_scheduled_offline gauge and refreshes fed_ranks_alive —
        every skip / admission / watchdog path reads availability through
        here so the gauges can never drift from the decisions."""
        if self.churn_trace is None:
            return set()
        off = self.churn_trace.scheduled_offline_ranks(
            self.round_idx, self.size)
        if off != self._offline_now:
            self._offline_now = off
            _obs.set_ranks_scheduled_offline(len(off))
            self._update_alive_gauge()
            if self._fleet is not None:
                # the fleet rows' avail column: rank 0 owns the trace, so
                # it stamps the rows directly (an away rank sends no
                # digests to say so itself)
                self._fleet.note_avail(off, self.size)
        return off

    @staticmethod
    def _is_transport_error(e: BaseException) -> bool:
        """Only delivery failures are elastic-tolerable; config/programming
        errors (KeyError on a bad ip table, serialization bugs) stay
        fatal. grpc.RpcError is detected by name so the server module
        needs no grpc import for the loopback/mqtt backends."""
        if isinstance(e, (ConnectionError, TimeoutError, OSError)):
            return True
        return any(c.__name__ == "RpcError" for c in type(e).__mro__)

    def send_message(self, msg) -> None:
        """Elastic mode tolerates an unreachable downlink: the failed rank
        simply has nothing to report this round and the watchdog drops it
        (the reference aborts the whole job instead — raise_MPI_error ->
        MPI.COMM_WORLD.Abort(), fedml_api/utils/context.py:9-18).
        Without a round deadline, delivery failures stay fatal."""
        rank = int(msg.get_receiver_id())
        failed_at = self._undeliverable.get(rank)
        # reprobe only on a POSITIVE multiple of the interval: at
        # round_idx == failed_at the failure was just recorded, and a
        # second send in the same round (e.g. the FINISH broadcast after a
        # failed final sync) must not re-block a full send deadline
        if (failed_at is not None and
                (self.round_idx == failed_at or
                 (self.round_idx - failed_at) % self._DEAD_RANK_REPROBE_ROUNDS)):
            log.debug("elastic: skipping send to dead rank %d "
                      "(failed at round %d; reprobed every %d rounds)",
                      rank, failed_at, self._DEAD_RANK_REPROBE_ROUNDS)
            return
        try:
            super().send_message(msg)
            if failed_at is not None:
                log.info("elastic: rank %d reachable again", rank)
                self._undeliverable.pop(rank, None)
                self._update_alive_gauge()
        except Exception as e:
            if self.round_timeout_s is None or not self._is_transport_error(e):
                raise
            self._undeliverable[rank] = self.round_idx
            self._update_alive_gauge()
            log.warning("elastic: dropping undeliverable send to rank %d",
                        rank, exc_info=True)

    # ------------------------------------------------------ crash recovery
    def _ckpt_state_template(self) -> dict:
        """What a checkpoint holds (the reference's layout): the net, the
        server optimizer state (none in the port: FedOpt is item 9) and
        the reference's ``PRNGKey(0)`` bits, which a DP aggregator
        replaces with its noise key (a resumed job continues the key
        stream instead of replaying it), plus its cumulative RDP totals
        (``dp_rdp``: epsilon() must cover the pre-restart rounds)."""
        import numpy as np

        st = {"net": self.aggregator.net, "server_opt_state": (),
              "rng": np.asarray(getattr(self.aggregator, "_noise_rng",
                                        np.zeros(2, np.uint32)),
                                np.uint32)}
        acct = getattr(self.aggregator, "accountant", None)
        if acct is not None:
            st["dp_rdp"] = np.asarray(acct._rdp)
        return st

    def _maybe_resume(self) -> None:
        import json

        import numpy as np

        from fedml_tpu_torch.core.checkpoint import restore_latest

        t0 = time.monotonic()
        committed = -1
        if self.ckpt_dir is not None:
            template = dict(self._ckpt_state_template(),
                            round=np.asarray(0, np.int64))
            # the newest RESTORABLE checkpoint is the commit authority: a
            # torn newest file (crash mid-save) is skipped + counted and
            # recovery falls back to the previous round
            hit = restore_latest(self.ckpt_dir, template,
                                 self.aggregator.num_heads)
            if hit is not None:
                committed, state = hit
                self.aggregator.net = state["net"]
                if hasattr(self.aggregator, "_noise_rng"):
                    self.aggregator._noise_rng = np.asarray(
                        state["rng"], np.uint32).copy()
                acct = getattr(self.aggregator, "accountant", None)
                if "dp_rdp" in state and acct is not None:
                    acct._rdp = np.asarray(state["dp_rdp"])
            # reload the persisted eval history + quarantine ledger so a
            # restarted process reports the SAME artifacts an
            # uninterrupted run would
            hist_path = os.path.join(self.ckpt_dir, "history.json")
            if os.path.exists(hist_path):
                with open(hist_path) as f:
                    self.aggregator.history = json.load(f)
            quar_path = os.path.join(self.ckpt_dir, "quarantine.json")
            if os.path.exists(quar_path):
                with open(quar_path) as f:
                    self.aggregator.quarantine.restore(json.load(f))
        replay = self._wal_replay
        if committed < 0 and (replay is None or not replay.records):
            return  # genuinely fresh start
        self.round_idx = committed + 1
        self._recover_in_flight(committed, replay)
        if self.wal is not None:
            from fedml_tpu_torch.obs import perf_instrument as _perf

            _perf.record_recovery_seconds(time.monotonic() - t0)
        log.info("resumed from checkpoint+WAL: committed round %d, next "
                 "round %d%s (restart epoch %d)", committed, self.round_idx,
                 " [open round re-runs]" if self._resume_round is not None
                 else "", self._restart_epoch)

    def _recover_in_flight(self, committed: int, replay) -> None:
        """WAL half of recovery: reconstruct what the crash interrupted.

        - an OPEN round (anything journaled past the last commit) re-runs
          as ``self.round_idx`` behind a resume probe, and every upload
          the dead server had ACCEPTED (sync ``upload`` / async buffer
          ``admit`` records — the payloads died with the process) is
          ledgered ``server_restart``, slot-exact;
        - DP pre-charges past the committed round re-charge the
          accountant (the noise MAY have been released pre-crash; ε must
          never read lower than the charges incurred — the conservative
          direction);
        - async dispatch-wave counters resume past their journaled
          maxima, keeping the per-rank sampling chain monotonic."""
        if replay is None:
            return
        acct = getattr(self.aggregator, "accountant", None)
        if acct is not None:
            for rec in replay.of_kind("precharge"):
                if int(rec.get("round", -1)) > committed:
                    acct.step(float(rec["q"]), float(rec["z"]))
                    log.warning("recovery: re-charged DP accountant for "
                                "the pre-crash charge of round %d "
                                "(q=%.6f, z=%.3f)", rec["round"],
                                rec["q"], rec["z"])
        # per-client ledgers rebuild from EVERY precharge record (the WAL
        # is append-only for the run): the variable-key {client: rdp} map
        # rides no checkpoint — the journaled client ids ARE its durable
        # form. The in-flight round's record re-charges too, so per-client
        # ε can over-count by one round per crash but never under-report
        ledger = getattr(self.aggregator, "client_ledger", None)
        if ledger is not None:
            recharged = 0
            for rec in replay.of_kind("precharge"):
                clients = rec.get("clients")
                if clients:
                    ledger.charge([int(c) for c in clients],
                                  float(rec["z"]))
                    recharged += 1
            if recharged:
                from fedml_tpu_torch.obs import perf_instrument as _perf

                s = ledger.summary()
                _perf.set_client_epsilon(s["eps_client_max"],
                                         s["eps_client_mean"],
                                         s["clients_charged"])
                log.warning("recovery: rebuilt per-client privacy "
                            "ledgers from %d precharge record(s) — "
                            "eps_client_max=%.6f over %d client(s)",
                            recharged, s["eps_client_max"],
                            s["clients_charged"])
        if self._async:
            for rank, w in replay.dispatch_waves().items():
                self._dispatch_wave[rank] = w + 1
        in_flight = replay.since_last_commit(
            ("broadcast", "dispatch", "upload", "admit"))
        if not in_flight or self.round_idx >= self.round_num:
            return
        self._resume_round = self.round_idx
        lost = replay.since_last_commit(("upload", "admit"))
        # an admit whose entry was overflow-SHED pre-crash held no
        # foldable work at death (and was already counted overflow by the
        # live server) — it must not be re-ledgered server_restart
        shed_keys = {(int(r.get("rank", -1)), int(r.get("wave", -1)))
                     for r in replay.since_last_commit("shed")}
        lost = [rec for rec in lost
                if rec.get("kind") != "admit"
                or (int(rec["rank"]),
                    int(rec.get("wave", -1))) not in shed_keys]
        for rec in lost:
            self.aggregator.quarantine.record(
                int(rec.get("round", self.round_idx)), int(rec["rank"]),
                "server_restart", client=rec.get("client"))
            _obs.record_update_rejected("server_restart")
            if self._async:
                self._record_shed("server_restart")
        log.warning("recovery: round %d was in flight at the crash — "
                    "%d accepted upload(s) lost with the process "
                    "(ledgered server_restart); re-dispatching behind a "
                    "resume probe", self.round_idx, len(lost))

    def _maybe_save(self) -> None:
        if self.ckpt_dir is None:
            return
        import json

        from fedml_tpu_torch.core.checkpoint import save_round
        from fedml_tpu_torch.core.wal import durable_write

        st = self._ckpt_state_template()
        extra = {k: v for k, v in st.items()
                 if k not in ("net", "server_opt_state", "rng")}
        save_round(self.ckpt_dir, self.round_idx, st["net"],
                   st["server_opt_state"], st["rng"],
                   history=self.aggregator.history,
                   extra_state=extra or None,
                   num_heads=self.aggregator.num_heads)
        # the quarantine ledger rides the commit (atomic + fsync'd): a
        # restarted process must report the same ledger an uninterrupted
        # run would — the WAL's quarantine records are forensic only
        durable_write(os.path.join(self.ckpt_dir, "quarantine.json"),
                      json.dumps(self.aggregator.quarantine.entries())
                      .encode())
        if self.wal is not None:
            # commit AFTER the checkpoint rename: the checkpoint is the
            # state authority; the record witnesses it and resets the
            # WAL's in-flight (since_last_commit) window
            self.wal.commit(self.round_idx)

    def _broadcast_finish(self):
        # final best-effort delivery to EVERY rank, including ones the
        # elastic sender had marked undeliverable: a rank that RECOVERED
        # after its failure but whose reprobe round never came would
        # otherwise miss FINISH and block in its receive loop. A still-dead
        # rank just re-fails the send (re-marked, skipped).
        self._undeliverable.clear()
        self._update_alive_gauge()
        for rank in range(1, self.size):
            msg = Message(MyMessage.MSG_TYPE_S2C_FINISH, self.rank, rank)
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
            self.send_message(msg)
        self.finish()

    def run(self):
        if self.round_idx >= self.round_num:  # resumed past the last round
            self._broadcast_finish()
            return
        if self._resume_round is not None:
            # recovery found an open round: probe before re-dispatching so
            # the fleet's in-flight pre-crash work is accounted, then the
            # ack quorum (or the backstop) re-broadcasts under this epoch
            with self._round_lock:
                self._send_resume_probes()
        else:
            log.info("server up: %s round %d to %d client ranks",
                     "dispatching" if self._async else "broadcasting",
                     self.round_idx, self.size - 1)
            self.send_init_msg()
        super().run()
        if self._sim_crash is not None:
            # a crash point fired on a non-dispatch thread (watchdog /
            # timer) and stopped the loop: surface it to the supervision
            # driver from the thread that owns run()
            raise self._sim_crash

    def _broadcast_model(self, msg_type: str, global_params) -> None:
        """Sample this round's clients and broadcast ``global_params`` to
        every rank under ``msg_type`` — the shared body of send_init_msg
        and the round-advance sync (they must not diverge)."""
        self._maybe_crash("broadcast")
        self._goodput_round_start()
        if self.wal is not None:
            # journal the round opening BEFORE any frame leaves: recovery
            # must know round r was in flight even if the crash lands
            # mid-broadcast
            self.wal.append("broadcast", sync=True, round=self.round_idx)
        self._uploads_this_round = 0
        client_indexes = self.aggregator.client_sampling(self.round_idx)
        self._round_ids = [int(c) for c in client_indexes]
        # stamp the aggregator's accepted round BEFORE any client can
        # answer the broadcast — uploads tagged with any other round are
        # rejected at the slotting layer (add_local_trained_result)
        self.aggregator.begin_round(self.round_idx)
        suspects = self._admit_cohort()
        # stash the pack AS CLIENTS WILL SEE IT: under a lossy wire
        # codec their deltas are relative to the decoded broadcast; under
        # delta_broadcast the stash IS the base chain every rank holds
        delta, base_v = None, self.round_idx - 1
        if self.delta_broadcast:
            import numpy as np

            from fedml_tpu_torch.comm.delta import apply_delta, round_delta

            pack = [np.asarray(v) for v in global_params]
            prev = self._version_pack.get(base_v)
            if prev is not None:
                delta = round_delta(pack, prev)
                # the canonical held value is the CHAIN value prev + delta
                # (f32 adds), not the pack: warm clients compute exactly
                # this, and the dense fallback ships it verbatim (marked
                # lossless) so every rank holds the same base bitwise
                stash = apply_delta(prev, delta)
            else:
                stash = pack
        else:
            stash = codec_roundtrip(global_params)
        self._stash_version(self.round_idx, stash)
        tr = self._dtracer
        if tr is not None:
            tr.begin_round(self.round_idx)
        for rank in range(1, self.size):
            if rank in suspects:  # heartbeat-suspect or scheduled-offline
                continue
            msg = Message(msg_type, self.rank, rank)
            if delta is not None and self._rank_version.get(rank) == base_v:
                # warm rank: its last upload proved it holds base_v
                msg.add_params(MyMessage.MSG_ARG_KEY_DELTA_PARAMS, delta)
                msg.add_params(MyMessage.MSG_ARG_KEY_BASE_VERSION, base_v)
            else:
                msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, stash
                               if self.delta_broadcast else global_params)
                if self.delta_broadcast:
                    # the dense fallback must land bit-exact: the next
                    # delta is computed against this chain value
                    msg.mark_lossless(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, int(client_indexes[rank - 1]))
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
            if self._restart_epoch:
                # post-restart session tag, echoed on every upload so the
                # epoch gate sheds pre-crash in-flight work exactly once;
                # absent at epoch 0 — the wire is unchanged until a crash
                # actually happened
                msg.add_params(MyMessage.MSG_ARG_KEY_RESTART_EPOCH,
                               self._restart_epoch)
            if tr is not None:  # trace context rides the header scalars
                msg.add_params(TRACE_KEY, tr.broadcast_ctx(rank))
            self._add_fleet_marker(msg)
            self.send_message(msg)
        if tr is not None:
            tr.end_broadcast()
        self._goodput_broadcast_end()
        # after_uploads=0: mid-round with the broadcast OUT but zero
        # uploads accepted — distinct from None (between commits, before
        # any frame of the round leaves)
        self._maybe_crash("post_broadcast")

    def _admit_cohort(self) -> set[int]:
        """Heartbeat-driven cohort admission for this round: ranks silent
        past the age threshold are excluded — no send, and the barrier
        does not wait for them (the aggregator's excluded set) — except on
        reprobe rounds, which re-invite them so a resumed rank rejoins;
        its first frame resets the age and readmits it for good. A rank
        the churn trace says is away is EXPECTED silent: it never rides
        the suspect path, but it is excluded all the same (no send, the
        barrier does not wait). Returns the excluded ranks, suspect and
        scheduled-offline."""
        suspects = _obs.suspect_ranks(
            range(1, self.size), self.heartbeat_max_age_s, self.round_idx,
            self._DEAD_RANK_REPROBE_ROUNDS)
        offline = self._scheduled_offline()
        suspects -= offline
        self.aggregator.excluded = {r - 1 for r in suspects | offline}
        if offline:
            log.debug("round %d: %d rank(s) scheduled-offline by the churn "
                      "trace — skipped silently", self.round_idx,
                      len(offline))
        if (self.heartbeat_max_age_s is not None
                and self.round_idx % self._DEAD_RANK_REPROBE_ROUNDS == 0):
            # reprobe round: force a REAL send attempt to every silent rank
            # — the elastic undeliverable skip runs on its own (failed_at
            # anchored) cadence, and the two schedules can otherwise never
            # align, leaving a resumed rank permanently uninvited
            silent = _obs.suspect_ranks(
                range(1, self.size), self.heartbeat_max_age_s,
                self.round_idx, 0)  # reprobe_every=0: the raw verdict
            for rank in list(self._undeliverable):
                if rank in silent:
                    self._undeliverable.pop(rank, None)
            self._update_alive_gauge()
        if suspects:
            log.warning("round %d: heartbeat-suspect ranks %s excluded "
                        "from the cohort (age > %.2fs; reprobed every %d "
                        "rounds)", self.round_idx, sorted(suspects),
                        self.heartbeat_max_age_s,
                        self._DEAD_RANK_REPROBE_ROUNDS)
        return suspects | offline

    def send_init_msg(self):
        if self._async:
            # async boot: every rank gets wave-0 work individually (same
            # cohort assignment as the sync broadcast — rank r trains
            # client_sampling(0)[r-1]); from here on dispatch is
            # event-driven, one rank at a time as uploads land
            self.aggregator.begin_round(self.round_idx)
            for rank in range(1, self.size):
                self._dispatch_one(rank, MyMessage.MSG_TYPE_S2C_INIT_CONFIG)
            return
        self._broadcast_model(MyMessage.MSG_TYPE_S2C_INIT_CONFIG,
                              self.aggregator.get_global_model_params())

    # ------------------------------------------------- async buffered mode
    # The event-driven loop of buffered-async rounds. All state below is
    # touched under _round_lock only.
    def _dispatch_one(self, rank: int,
                      msg_type: str | None = None) -> None:
        """Hand ``rank`` its next unit of work: the current global model
        (packed once per version) + the client its dispatch-wave counter
        samples. Heartbeat-suspect ranks are skipped (admission control) —
        the flush-time reprobe re-dispatches them once they may have
        resumed. Scheduled-offline ranks (churn trace) are skipped
        SILENTLY before the suspect check: the trace expects them away,
        so they get no suspect bookkeeping and no reprobe churn — the
        flush-time reprobe hands them fresh work the moment the trace
        brings them back."""
        if rank in self._scheduled_offline():
            self._offline_skipped.add(rank)
            self._record_shed("offline")
            log.debug("async: rank %d scheduled-offline — dispatch skipped "
                      "until the trace's next arrival", rank)
            return
        suspects = _obs.suspect_ranks(
            range(1, self.size), self.heartbeat_max_age_s, self.round_idx,
            self._DEAD_RANK_REPROBE_ROUNDS)
        if rank in suspects:
            self._record_shed("suspect")
            log.warning("async: not dispatching to heartbeat-suspect rank "
                        "%d (reprobed every %d updates)", rank,
                        self._DEAD_RANK_REPROBE_ROUNDS)
            return
        wave = self._dispatch_wave.get(rank, 0)
        self._dispatch_wave[rank] = wave + 1
        self._last_dispatch_version[rank] = self.round_idx
        self._last_dispatch_t[rank] = time.monotonic()
        if self._bcast_version != self.round_idx or self._bcast_pack is None:
            self._bcast_pack = self.aggregator.get_global_model_params()
            self._bcast_version = self.round_idx
            # versioned base stash: encoded uplinks from THIS dispatch wave
            # densify against the broadcast as the client decodes it
            self._stash_version(self.round_idx,
                                codec_roundtrip(self._bcast_pack))
        cid = int(self.aggregator.client_sampling(wave)[rank - 1])
        if self.wal is not None:
            # journaled (fsync'd) so a restarted server resumes every
            # rank's wave counter PAST this dispatch — the sampling chain
            # stays monotonic across restarts and recovery knows work was
            # in flight
            self.wal.append("dispatch", sync=True, round=self.round_idx,
                            rank=rank, wave=wave, client=cid)
        msg = Message(msg_type or MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                      self.rank, rank)
        msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, self._bcast_pack)
        msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, cid)
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
        if self._restart_epoch:
            msg.add_params(MyMessage.MSG_ARG_KEY_RESTART_EPOCH,
                           self._restart_epoch)
        # the wave rides the dispatch and comes back on the upload: it is
        # the work-unit key (sampling + the client's batch order), and
        # reconstructing it server-side from the counter would misattribute
        # a delayed upload once a reprobe puts two dispatches in flight
        msg.add_params(MyMessage.MSG_ARG_KEY_DISPATCH_WAVE, wave)
        # the sync broadcast's marker: without it an async fleet would
        # never fold a digest
        self._add_fleet_marker(msg)
        self._awaiting[rank] = wave
        self.send_message(msg)
        if rank in self._undeliverable:
            # elastic send failure: nothing is outstanding for this rank —
            # the flush-time reprobe owns bringing it back
            self._awaiting.pop(rank, None)

    def _handle_async_upload(self, msg_params) -> None:
        """Admission -> staging -> maybe flush -> re-dispatch. Caller holds
        _round_lock."""
        import numpy as np

        from fedml_tpu_torch.core.async_buffer import BufferedUpdate

        sender = int(msg_params[Message.MSG_ARG_KEY_SENDER])
        if self._fleet is not None:
            # fleet digest ingest happens before every gate: a shed or
            # stale upload still proves what its rank was doing (the
            # fleet view is liveness telemetry, not fold accounting)
            self._fleet.ingest(
                msg_params.get(MyMessage.MSG_ARG_KEY_TELEMETRY))
        if self._draining or self.round_idx >= self.round_num:
            # post-FINISH drain: absorb (and discard) the uploads that
            # were in flight when the job completed, then stop the loop —
            # clients never see a torn-down transport mid-upload
            self._awaiting.pop(sender, None)
            if self._draining and not self._awaiting:
                log.info("async: drain complete — stopping")
                self.finish()
            return
        expected_wave = self._awaiting.get(sender)
        # the echoed dispatch wave is authoritative (see _dispatch_one);
        # the fallback covers interop peers that drop unknown keys
        wave = msg_params.get(MyMessage.MSG_ARG_KEY_DISPATCH_WAVE)
        wave = expected_wave if wave is None else int(wave)
        if expected_wave is None or wave != expected_wave:
            # chaos-duplicated or superseded upload: either the rank has no
            # outstanding dispatch, or this is the abandoned twin of a
            # reprobe — exactly-once folding, like the sync round-tag gate
            _obs.record_stale_upload("stale")
            log.warning("async: drop upload from rank %d for wave %s "
                        "(awaiting %s)", sender, wave, expected_wave)
            return
        self._awaiting.pop(sender, None)
        trained_version = int(msg_params.get(MyMessage.MSG_ARG_KEY_ROUND,
                                             self.round_idx))
        staleness = self.round_idx - trained_version
        if not self._staleness.admits(staleness):
            # admission control: reject-and-requeue with the fresh global
            self._record_shed("stale")
            log.warning("async: rejecting upload from rank %d at staleness "
                        "%d > bound %d — requeued", sender, staleness,
                        self._staleness.bound)
            self._dispatch_one(sender)
            return
        # encoded uplinks compose with the async waves because they
        # densify against the stashed broadcast of the version the
        # dispatch carried: an admissible-staleness upload whose base was
        # EVICTED from the bounded stash is shed as stale and requeued —
        # only a version never broadcast stays a loud protocol error
        encoded = (MyMessage.MSG_ARG_KEY_SPARSE_IDX in msg_params
                   or MyMessage.MSG_ARG_KEY_UPDATE_CODEC in msg_params)
        if encoded and trained_version not in self._version_pack \
                and 0 <= trained_version <= self.round_idx:
            self._record_shed("stale")
            log.warning("async: rank %d's upload encoded against evicted "
                        "base version %d (stash floor %s) — requeued",
                        sender, trained_version,
                        min(self._version_pack, default=None))
            self._dispatch_one(sender)
            return
        if self._fused:
            decoded = self._decode_upload_fused(msg_params, sender,
                                                trained_version)
        else:
            decoded = self._decode_upload(msg_params, sender,
                                          trained_version)
        if decoded is None:
            # undecodable payload: quarantined + counted by the decode;
            # the rank gets fresh work like any other consumed upload
            self._record_shed("undecodable")
            self._dispatch_one(sender)
            return
        # the work unit's client id: echoed from the dispatch frame (like
        # the wave) so the hot path never rebuilds the seeded sampling
        # permutation under _round_lock; the fallback recomputes it for
        # interop peers that drop unknown keys
        client = msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX)
        client = (int(self.aggregator.client_sampling(wave)[sender - 1])
                  if client is None else int(client))
        if self._fused:
            # the device densify answered the door's question already
            payload, finite = decoded
        else:
            payload = self.aggregator._stage_upload(decoded)
            finite = all(np.isfinite(v).all() for v in decoded
                         if isinstance(v, np.ndarray)
                         and np.issubdtype(v.dtype, np.floating))
        if not finite:
            # quarantine at the door: a non-finite arrival never enters
            # the buffer (norm outliers still gate at flush, where the
            # cohort median exists)
            self.aggregator.quarantine.record(
                self.round_idx, sender, "nonfinite", client=client)
            _obs.record_update_rejected("nonfinite")
            self._record_shed("nonfinite")
            self._dispatch_one(sender)
            return
        now = time.monotonic()
        if len(self._buffer) == 0:
            self._buffer_first_t = now
            self._arm_deadline()
        entry = BufferedUpdate(
            rank=sender, client=client,
            version=trained_version, wave=wave,
            payload=payload,
            nsamp=float(msg_params[MyMessage.MSG_ARG_KEY_NUM_SAMPLES]),
            seq=wave * self.size + sender, t_arrival=now)
        for victim in self._buffer.add(entry):
            # backpressure: shed the stalest pending update, never block.
            # Counting is ALL a victim needs: an old victim's rank already
            # has outstanding work (it was re-dispatched or parked when its
            # entry was staged), and a shed-on-arrival sender gets its one
            # park-or-redispatch below like any other consumed upload
            self._record_shed("overflow")
            log.warning("async: buffer overflow shed rank %d's update "
                        "(trained at version %d)", victim.rank,
                        victim.version)
        if self._staleness.synchronous:
            # bound 0 = the barrier expressed async: work dispatched now
            # would be born stale post-flush — park until the flush lands
            self._parked.append(sender)
        else:
            self._dispatch_one(sender)
        if self._buffer.ready:
            self._flush_buffer()

    def _flush_buffer(self) -> None:
        """One buffered aggregate = one global update: staleness-discounted
        weights through the aggregator's gated composition, then
        eval/checkpoint/telemetry at the sync round cadence, then
        re-dispatch of every parked rank with the fresh global. Caller
        holds _round_lock."""
        import numpy as np

        from fedml_tpu_torch.obs import perf_instrument as _perf

        entries = self._buffer.drain()
        self._buffer_epoch += 1
        if not entries or self.round_idx >= self.round_num:
            return
        version = self.round_idx
        self.aggregator.begin_round(version)
        stale = np.asarray([version - e.version for e in entries],
                           np.float32)
        discounts = [float(d) for d in self._discount_np(stale)]
        weights = [e.nsamp * d for e, d in zip(entries, discounts)]
        self.aggregator.load_buffered(entries, weights, discounts=discounts)
        for s in stale:
            _perf.record_update_staleness(float(s))
        now = time.monotonic()
        fill_s = now - (self._buffer_first_t
                        if self._buffer_first_t is not None else now)
        _perf.record_buffer_fill(fill_s)
        self._buffer_first_t = None
        tel = self.telemetry
        try:
            if tel is not None:
                old_leaves = [np.asarray(v) for v in
                              self.aggregator.get_global_model_params()]
                with self._tracer.span("aggregate"):
                    global_params = self.aggregator.aggregate()
                with self._tracer.span("eval"):
                    self.aggregator.test_on_server_for_all_clients(version)
                upd_sq = sum(float(np.sum((np.asarray(n) - o) ** 2))
                             for n, o in zip(global_params, old_leaves))
                hist = self.aggregator.history
                q = self.aggregator.quarantine.for_round(version)
                spans = dict(self._tracer.rounds[-1])
                # async round economics: a flush's wall is the time since
                # the previous flush (no broadcast barrier); the
                # buffer-fill window is its wire wait
                prev_flush = self._gp_prev_flush_t
                self._gp_prev_flush_t = time.monotonic()
                tel.emit_round(
                    version, clients=[e.client for e in entries],
                    spans=spans,
                    metrics={"update_norm": float(np.sqrt(upd_sq)),
                             "num_samples": float(sum(e.nsamp
                                                      for e in entries))},
                    **({} if prev_flush is None else self._goodput_extra(
                        spans, wire_wait_s=fill_s,
                        wall_s=self._gp_prev_flush_t - prev_flush)),
                    evals=(hist[-1] if hist
                           and hist[-1].get("round") == version else None),
                    **{"async": {
                        "k": len(entries),
                        "staleness": [int(s) for s in stale],
                        "buffer_fill_s": round(fill_s, 6),
                        "shed": dict(self._shed_counts)}},
                    **({"quarantine": q} if q else {}),
                    agg=self.aggregator.agg_record(),
                    **self._round_record_extra())
                self._tracer.next_round()
            else:
                self.aggregator.aggregate()
                self.aggregator.test_on_server_for_all_clients(version)
        finally:
            self.aggregator._async_meta = None
        self._maybe_save()
        self.round_idx += 1
        self._bcast_pack = None  # repack lazily at the next dispatch
        # crash points in async terms: a flush IS the commit boundary —
        # 'between commits' fires here (the new round exists, nothing of
        # it dispatched), and the per-round upload counter resets so
        # 'after_uploads' counts THIS round's admissions
        self._uploads_this_round = 0
        self._maybe_crash("broadcast")
        if self.round_idx >= self.round_num:
            self._finish_async()
            return
        parked, self._parked = self._parked, []
        for rank in parked:
            self._dispatch_one(rank)
        self._async_reprobe()
        # after_uploads=0 in async terms: the new round's dispatches are
        # out, nothing admitted yet
        self._maybe_crash("post_broadcast")

    def _finish_async(self) -> None:
        """Broadcast FINISH, then DRAIN instead of tearing down: the
        receive loop stays up until every outstanding dispatch's upload
        has landed (each is discarded by the drain gate), bounded by a
        grace timer for ranks that died mid-dispatch. Caller holds
        _round_lock."""
        # final best-effort delivery to EVERY rank, including ones the
        # elastic sender had marked undeliverable
        self._undeliverable.clear()
        self._update_alive_gauge()
        for rank in range(1, self.size):
            msg = Message(MyMessage.MSG_TYPE_S2C_FINISH, self.rank, rank)
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
            self.send_message(msg)
        if not self._awaiting:
            self.finish()
            return
        self._draining = True
        log.info("async: job complete — draining %d in-flight upload(s) "
                 "(grace %.1fs)", len(self._awaiting), self._drain_grace_s)
        t = threading.Timer(self._drain_grace_s, self.finish)
        t.daemon = True
        t.start()

    def _record_shed(self, reason: str) -> None:
        """One shed verdict: the process-wide metric family AND this job's
        own tally (round records must scope to this job)."""
        from fedml_tpu_torch.obs import perf_instrument as _perf

        _perf.record_async_shed(reason)
        self._shed_counts[reason] = self._shed_counts.get(reason, 0) + 1

    def _journal_buffer(self, event: str, e) -> None:
        """AsyncBuffer journal hook: buffer membership rides the WAL so
        recovery ledgers exactly the admitted-and-unflushed entries that
        died with the process. Admits are fsync'd (the lost-slot ledger
        is a correctness artifact); overflow sheds are forensic."""
        if self.wal is None:
            return
        extra = {} if event == "admit" else {"reason": "overflow"}
        self.wal.append("admit" if event == "admit" else "shed",
                        sync=event == "admit", round=int(e.version),
                        rank=int(e.rank), client=int(e.client),
                        wave=int(e.wave), nsamp=float(e.nsamp), **extra)
        if event == "admit":
            self._uploads_this_round += 1
            self._maybe_crash("upload")

    def _async_reprobe(self, force: bool = False) -> None:
        """Bring silent ranks back: a rank whose dispatch went nowhere
        (send failed elastically, heartbeat-skipped) OR whose upload was
        lost on the wire (still awaiting, silent for
        ``_DEAD_RANK_REPROBE_ROUNDS`` global updates) is re-dispatched —
        the reissue DECLARES the old wave lost, so a late upload of it
        dies at the wave-matched awaiting gate. ``force`` skips the
        recently-dispatched check (the idle watchdog after
        ``round_timeout_s`` of total silence); both paths respect the
        WALL-CLOCK grace. Caller holds _round_lock."""
        now = time.monotonic()
        offline = self._scheduled_offline()
        for rank in range(1, self.size):
            if rank in self._parked:
                continue
            if rank in offline:
                # scheduled-offline: the trace says it's away, not dead —
                # zero reprobe churn; the branch below picks it up the
                # moment the trace brings it back
                continue
            if rank in self._offline_skipped:
                # back from scheduled-offline: re-dispatch immediately,
                # bypassing the age/grace checks — its silence was the
                # trace's doing, not evidence of death
                self._offline_skipped.discard(rank)
                self._idle_logged_round = None  # an arrival ends the stretch
                log.info("async: rank %d returned from scheduled-offline — "
                         "re-dispatching", rank)
                self._undeliverable.pop(rank, None)
                self._update_alive_gauge()
                self._awaiting.pop(rank, None)
                self._dispatch_one(rank)
                continue
            last = self._last_dispatch_version.get(rank)
            if not force and last is not None and \
                    (self.round_idx - last) < \
                    self._DEAD_RANK_REPROBE_ROUNDS:
                continue  # recently dispatched: give it time
            t_disp = self._last_dispatch_t.get(rank)
            if t_disp is not None and \
                    (now - t_disp) < self._reprobe_grace_s:
                continue  # dispatched recently in WALL-CLOCK: still alive
            log.info("async: reprobing silent rank %d", rank)
            # the reprobe IS the re-invitation: drop the elastic
            # undeliverable mark so the send is actually attempted
            self._undeliverable.pop(rank, None)
            self._update_alive_gauge()
            self._awaiting.pop(rank, None)
            self._dispatch_one(rank)

    def _arm_deadline(self) -> None:
        """Deadline flush: a buffer that has waited ``buffer_deadline_s``
        since its first arrival aggregates PARTIAL instead of waiting out a
        straggler cohort — the async analogue of the elastic round
        timeout."""
        if self.buffer_deadline_s is None:
            return
        t = threading.Timer(self.buffer_deadline_s, self._deadline_fire,
                            args=(self._buffer_epoch,))
        t.daemon = True
        t.start()

    def _deadline_fire(self, epoch: int) -> None:
        with self._round_lock:
            if (self._finished.is_set() or epoch != self._buffer_epoch
                    or len(self._buffer) == 0):
                return
            log.warning("async: buffer deadline fired with %d/%d staged — "
                        "flushing partial", len(self._buffer),
                        self._buffer.flush_threshold)
            self._flush_buffer()

    # ------------------------------------------------ crash points (chaos)
    def _maybe_crash(self, point: str) -> None:
        """Deterministic simulated-crash hook (loopback supervision):
        ``_crash_plan`` holds ``(round, after_uploads)`` points derived
        from chaos ``crash`` rules naming rank 0 — ``after_uploads=None``
        dies BETWEEN COMMITS (entering the round, before any frame of it
        leaves), an integer dies MID-ROUND once that many uploads of the
        round were accepted (``0`` = broadcast out, nothing accepted yet;
        their WAL records already fsync'd, their payloads about to die
        with the process), and ``-1`` dies at the masked tier's reveal
        fan-out (distributed/turboaggregate.py), the recovery state
        machine's most dangerous window. Only the head of the plan is
        consulted; the supervision driver pops it per boot, so a recovered
        server does not re-crash on the same point."""
        if not self._crash_plan:
            return
        rnd, after = self._crash_plan[0]
        why = None
        if point == "broadcast" and after is None \
                and self.round_idx == int(rnd):
            why = "between commits"
        elif point == "post_broadcast" and after is not None \
                and int(after) == 0 and self.round_idx == int(rnd):
            # m=0 must fire with the broadcast out and ZERO uploads
            # journaled — the upload hook can't express it (it only runs
            # after an accept)
            why = "mid-round after 0 uploads"
        elif point == "reveal" and after is not None and int(after) == -1 \
                and self.round_idx == int(rnd):
            # after_uploads = -1: die at the secagg reveal fan-out (the
            # fold must recover as a shed, never half-recovered)
            why = "mid-reveal"
        elif point == "upload" and after is not None and int(after) >= 1 \
                and self.round_idx == int(rnd) \
                and self._uploads_this_round >= int(after):
            why = f"mid-round after {self._uploads_this_round} uploads"
        if why is None:
            return
        exc = SimulatedServerCrash(self.round_idx, why)
        # crash points can fire on the WATCHDOG or a timer thread, where a
        # bare raise would kill only that thread: flag the crash and stop
        # the dispatch loop WITHOUT any farewell frame (the loopback
        # deregistration IS process death), then raise — run() re-raises
        # the flag to the supervision driver whichever thread died first
        self._sim_crash = exc
        # black box (obs/flightrec.py): the crash is the one moment the
        # in-memory ring MUST become durable — record the crash marker,
        # then dump before the transport goes down
        from fedml_tpu_torch.obs import flightrec as _flightrec

        _flightrec.flight_record("sim_crash", rank=self.rank,
                                 round=self.round_idx, point=point, why=why)
        _flightrec.dump_active("sim_crash")
        try:
            inner = getattr(self.com_manager, "inner", self.com_manager)
            inner.stop_receive_message()
        except Exception:  # noqa: BLE001 — dying is the whole point
            log.debug("simulated crash: transport teardown failed",
                      exc_info=True)
        raise exc

    # --------------------------------------------------- session resumption
    def _send_resume_probes(self) -> None:
        """Post-restart probe fan-out: recovery found an OPEN round, so
        clients may hold in-flight pre-crash work. Each rank gets one
        s2c_resume frame carrying the new restart epoch; its c2s_resume
        answer (last-seen round + async wave) tells the server who is
        alive and what they hold before the open round is re-dispatched.
        A backstop timer proceeds without the silent ranks (they re-enter
        through the elastic undeliverable/reprobe machinery)."""
        self._resume_pending = set(range(1, self.size))
        log.info("resume probe: round %d re-runs under restart epoch %d — "
                 "probing %d rank(s)", self._resume_round,
                 self._restart_epoch, len(self._resume_pending))
        for rank in range(1, self.size):
            msg = Message(MyMessage.MSG_TYPE_S2C_RESUME_PROBE, self.rank,
                          rank)
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self._resume_round)
            msg.add_params(MyMessage.MSG_ARG_KEY_RESTART_EPOCH,
                           self._restart_epoch)
            self.send_message(msg)
        grace = self.round_timeout_s or 5.0
        t = threading.Timer(grace, self._resume_backstop)
        t.daemon = True
        t.start()

    def _resume_backstop(self) -> None:
        with self._round_lock:
            if self._resume_round is None or self._finished.is_set():
                return
            log.warning("resume probe: %d rank(s) silent past the grace — "
                        "re-dispatching without them (elastic machinery "
                        "owns their rejoin)", len(self._resume_pending))
            self._complete_resume()

    def handle_message_resume_ack(self, msg_params):
        with self._round_lock:
            if self._resume_round is None:
                return  # late/duplicate ack after the backstop proceeded
            sender = int(msg_params[Message.MSG_ARG_KEY_SENDER])
            last = int(msg_params.get(MyMessage.MSG_ARG_KEY_LAST_SEEN_ROUND,
                                      -1))
            wave = int(msg_params.get(MyMessage.MSG_ARG_KEY_LAST_SEEN_WAVE,
                                      -1))
            self._resume_pending.discard(sender)
            self._resume_acks[sender] = (last, wave)
            log.info("resume probe: rank %d last saw round %d (wave %d); "
                     "%d pending", sender, last, wave,
                     len(self._resume_pending))
            if not self._resume_pending:
                self._complete_resume()

    def _complete_resume(self) -> None:
        """Re-dispatch the open round under the new epoch. Caller holds
        _round_lock. Ranks whose ack shows pre-crash work for this round
        get it superseded (the epoch gate sheds the stale upload when it
        lands); ranks that never answered ride the elastic path."""
        rnd, self._resume_round = self._resume_round, None
        if rnd is None:
            return
        stale = sorted(r for r, (last, _w) in self._resume_acks.items()
                       if last >= rnd)
        if stale:
            log.info("resume: ranks %s hold pre-crash round-%d work — "
                     "superseded by the re-dispatch (epoch gate sheds it "
                     "on arrival)", stale, rnd)
        if self._async:
            # async re-dispatch: every rank gets fresh work at the
            # recovered round; wave counters already resume past the
            # journaled maxima
            self.aggregator.begin_round(self.round_idx)
            for rank in range(1, self.size):
                self._dispatch_one(rank)
            return
        self._broadcast_model(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                              self.aggregator.get_global_model_params())

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self.handle_message_receive_model_from_client,
        )
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_RESUME_ACK,
            self.handle_message_resume_ack,
        )

    # Sync rounds only look up the current version (the round-tag gate
    # drops anything else before densify), and the delta chain needs only
    # r-1: two stashed versions, not a model copy per round. Async rounds
    # retain enough versions to cover any admissible staleness, with a
    # floor for the unbounded-staleness mode.
    _VERSION_RETAIN = 2
    _ASYNC_VERSION_RETAIN = 16

    def _stash_version(self, version: int, decoded_leaves) -> None:
        self._version_pack[int(version)] = decoded_leaves
        if self._fused:
            dev = self.aggregator.device
            self._version_dev[int(version)] = [
                torch.from_numpy(np.array(v)).to(dev)
                for v in decoded_leaves]
        retain = (max(self._ASYNC_VERSION_RETAIN,
                      (self._staleness_bound or 0) + 2)
                  if self._async else self._VERSION_RETAIN)
        for v in [v for v in self._version_pack if v <= version - retain]:
            del self._version_pack[v]
            self._version_dev.pop(v, None)

    def _fused_payload(self, msg_params, sender: int, version: int):
        """The fused route's host work on one upload: structural
        validation only (zlib inflate to int8, leaf-count and size checks,
        comm/delta.inflate_update). Returns ``(kind, payload, scales,
        base_dev)`` for the device densify; raises ``CorruptPayload`` (a
        ValueError) on structural garbage and RuntimeError on a base
        version never broadcast."""
        from fedml_tpu_torch.comm.delta import CorruptPayload, inflate_update

        has_sparse = MyMessage.MSG_ARG_KEY_SPARSE_IDX in msg_params
        has_upd = MyMessage.MSG_ARG_KEY_UPDATE_CODEC in msg_params
        if not (has_sparse or has_upd):
            leaves = msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
            if not isinstance(leaves, list):
                raise ValueError(f"model_params is {type(leaves).__name__}")
            check_wire_leaves(self.aggregator.net, leaves,
                              self.aggregator.num_heads)
            return "dense", leaves, None, None
        base_dev = self._version_dev.get(int(version))
        base = self._version_pack.get(int(version))
        if base is None or base_dev is None:
            raise RuntimeError(
                f"upload from rank {sender} is encoded against version "
                f"{version}, which was never broadcast (or predates this "
                f"server) — encoded uplinks require a versioned base "
                f"(stashed: {sorted(self._version_pack)})")
        if has_sparse:
            idx = msg_params[MyMessage.MSG_ARG_KEY_SPARSE_IDX]
            val = msg_params[MyMessage.MSG_ARG_KEY_SPARSE_VAL]
            if len(idx) != len(base) or len(val) != len(base):
                raise CorruptPayload(
                    f"sparse payload has {len(idx)}/{len(val)} leaves, "
                    f"model has {len(base)}")
            for sel, vals, t in zip(idx, val, base):
                sel, t = np.asarray(sel), np.asarray(t)
                # the device gather would fault (or wrap) where the host
                # scatter raised IndexError: validate here, so a flipped
                # index costs one upload on both routes
                if np.issubdtype(t.dtype, np.floating) and (
                        len(sel) != len(np.asarray(vals)) or sel.size and (
                            int(sel.max()) >= t.size
                            or int(sel.min()) < -t.size)):
                    raise CorruptPayload(
                        f"sparse index out of range for a {t.size}-entry "
                        f"leaf")
            return "topk", (list(idx), list(val)), None, base_dev
        codec = str(msg_params[MyMessage.MSG_ARG_KEY_UPDATE_CODEC])
        raw, scales = inflate_update(
            msg_params[MyMessage.MSG_ARG_KEY_UPDATE_PAYLOAD],
            msg_params[MyMessage.MSG_ARG_KEY_UPDATE_SCALE], codec, base)
        return codec, raw, scales, base_dev

    def _quarantine_undecodable(self, sender: int, e) -> None:
        """Structural garbage that survived the CRC costs one upload:
        ledgered ``undecodable`` and counted, never a crashed loop."""
        self.aggregator.quarantine.record(self.round_idx, sender,
                                          "undecodable")
        _obs.record_update_rejected("undecodable")
        log.warning("quarantining undecodable upload from rank %d (%s)",
                    sender, e)

    def _stage_fused(self, msg_params, sender: int, version: int,
                     sample_num) -> bool:
        """Fused twin of ``_decode_upload`` + ``add_local_trained_result``:
        host-side structural validation, then the aggregator's device
        densify, gate and fold. Returns False when the payload is
        structurally undecodable (quarantined and counted, as on the
        stacked path); raises on a base version never broadcast."""
        try:
            kind, payload, scales, base_dev = self._fused_payload(
                msg_params, sender, version)
            self.aggregator.add_fused_result(
                sender - 1, kind, payload, scales, sample_num, version,
                base_dev)
        except (ValueError, KeyError, TypeError, IndexError) as e:
            self._quarantine_undecodable(sender, e)
            return False
        return True

    def _decode_upload_fused(self, msg_params, sender: int, version: int):
        """Fused twin of ``_decode_upload`` for the ASYNC door: the same
        validation, then only the device densify and the finiteness
        verdict (the gate runs at the drain, against the flush-time
        global). Returns ``(state, finite)`` or None when undecodable."""
        try:
            kind, payload, scales, base_dev = self._fused_payload(
                msg_params, sender, version)
            fn = self._fused_densify.get(kind)
            if fn is None:
                fn = self._fused_densify[kind] = \
                    self.aggregator.make_fused_densify(kind)
            state, finite = fn(payload, scales, base_dev)
        except (ValueError, KeyError, TypeError, IndexError) as e:
            self._quarantine_undecodable(sender, e)
            return None
        return state, bool(finite)

    def _decode_upload(self, msg_params, sender: int, version: int):
        """Densify one upload's wire payload into full model leaves:
        top-k (comm/sparse.py) and delta/quantized tiers (comm/delta.py)
        decode against the stashed broadcast of ``version``; dense uploads
        pass through. Returns None when the payload does not decode or its
        leaves do not fit the model (quarantined ``undecodable`` and
        counted: structural garbage that survived the CRC costs one upload,
        not the server); raises on a genuinely unversioned base (a protocol
        bug, not wire damage)."""
        has_sparse = MyMessage.MSG_ARG_KEY_SPARSE_IDX in msg_params
        has_upd = MyMessage.MSG_ARG_KEY_UPDATE_CODEC in msg_params
        base = None
        if has_sparse or has_upd:
            base = self._version_pack.get(int(version))
            if base is None:
                raise RuntimeError(
                    f"upload from rank {sender} is encoded against version "
                    f"{version}, which was never broadcast (or predates this "
                    f"server) — encoded uplinks require a versioned base "
                    f"(stashed: {sorted(self._version_pack)})")
        try:
            if has_sparse:
                from fedml_tpu_torch.comm.delta import CorruptPayload
                from fedml_tpu_torch.comm.sparse import topk_decode

                idx = msg_params[MyMessage.MSG_ARG_KEY_SPARSE_IDX]
                val = msg_params[MyMessage.MSG_ARG_KEY_SPARSE_VAL]
                if len(idx) != len(base) or len(val) != len(base):
                    # zip would silently truncate a leaf-count mismatch
                    raise CorruptPayload(
                        f"sparse payload has {len(idx)}/{len(val)} leaves, "
                        f"model has {len(base)}")
                leaves = topk_decode(base, idx, val)
            elif has_upd:
                from fedml_tpu_torch.comm.delta import (apply_delta,
                                                        decode_update)

                codec = str(msg_params[MyMessage.MSG_ARG_KEY_UPDATE_CODEC])
                leaves = apply_delta(base, decode_update(
                    msg_params[MyMessage.MSG_ARG_KEY_UPDATE_PAYLOAD],
                    msg_params[MyMessage.MSG_ARG_KEY_UPDATE_SCALE],
                    codec, base))
            else:
                leaves = msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
                if not isinstance(leaves, list):
                    raise ValueError(
                        f"model_params is {type(leaves).__name__}")
            check_wire_leaves(self.aggregator.net, leaves,
                              self.aggregator.num_heads)
        except (ValueError, KeyError, TypeError, IndexError) as e:
            # VALUE garbage (corrupt scales -> non-finite decode) flows
            # through and dies at the non-finite gate instead. IndexError:
            # a bit-flipped sparse index lands out of range in
            # topk_decode's scatter.
            self._quarantine_undecodable(sender, e)
            return None
        return leaves

    def _epoch_admits(self, msg_params) -> bool:
        """Restart-epoch gate: an upload whose echoed epoch predates this
        boot is PRE-CRASH in-flight work — its slot was already ledgered
        ``server_restart`` at recovery (if the dead server had accepted
        it) and the open round was re-dispatched, so folding it now would
        double-count. Counted, never ledgered (arrival timing is
        wall-clock; the ledger stays deterministic). Epoch-0 uploads
        against an epoch-0 server pass untouched."""
        up_epoch = int(msg_params.get(MyMessage.MSG_ARG_KEY_RESTART_EPOCH,
                                      0))
        if up_epoch == self._restart_epoch:
            return True
        _obs.record_stale_upload("server_restart")
        log.warning("dropping upload from rank %s at restart epoch %d "
                    "(server now at %d) — superseded by the post-crash "
                    "re-dispatch",
                    msg_params.get(Message.MSG_ARG_KEY_SENDER), up_epoch,
                    self._restart_epoch)
        return False

    def handle_message_receive_model_from_client(self, msg_params):
        with self._round_lock:
            if not self._epoch_admits(msg_params):
                if self._async:
                    # the pre-crash dispatch is dead; hand the rank fresh
                    # work under the new epoch so it rejoins the fleet
                    sender = int(msg_params[Message.MSG_ARG_KEY_SENDER])
                    self._record_shed("server_restart")
                    self._awaiting.pop(sender, None)
                    if not self._draining:
                        self._dispatch_one(sender)
                return
            if self._async:
                self._handle_async_upload(msg_params)
                return
            sender = msg_params[Message.MSG_ARG_KEY_SENDER]
            msg_round = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
            if int(msg_round) != self.round_idx:
                _obs.record_stale_upload("stale")
                log.warning("drop stale upload from rank %d (round %s, now %d)",
                            sender, msg_round, self.round_idx)
                return
            tel = self.telemetry
            if tel is not None:
                # the last counted arrival closes this round's wire_wait
                self._gp_last_arrival_t = time.monotonic()
            if self._dtracer is not None:
                # arrival time + clock sample + the piggybacked client
                # span buffer (None from an untraced peer is fine — the
                # arrival alone keeps slack computable)
                self._dtracer.on_upload(int(sender),
                                        msg_params.get(TRACE_KEY))
            if self._fleet is not None:
                self._fleet.ingest(
                    msg_params.get(MyMessage.MSG_ARG_KEY_TELEMETRY))
            # proof of possession: an upload tagged round v means the
            # sender decoded broadcast v — the delta-downlink warm set
            self._rank_version[int(sender)] = int(msg_round)
            # densify encoded uplinks against the STASHED broadcast of the
            # upload's version; the round gate above means sync lookups
            # always hit the current round's stash. With telemetry on, the
            # server's host work per upload (densify, check, the copy to
            # the device) is the round's ``decode`` span, which the
            # reference does not time apart.
            with (self._tracer.span("decode") if tel is not None
                  else contextlib.nullcontext()):
                if self._fused:
                    # fused: validate here, densify -> gate -> fold on
                    # the device against the version stash
                    decoded = self._stage_fused(
                        msg_params, int(sender), int(msg_round),
                        msg_params[MyMessage.MSG_ARG_KEY_NUM_SAMPLES])
                else:
                    decoded = self._decode_upload(msg_params, int(sender),
                                                  int(msg_round))
                    if decoded is not None:
                        self.aggregator.add_local_trained_result(
                            sender - 1,
                            decoded,
                            msg_params[MyMessage.MSG_ARG_KEY_NUM_SAMPLES],
                            round_idx=int(msg_round),
                        )
            if not decoded:
                # undecodable: quarantined + counted, but the ARRIVAL still
                # satisfies the barrier — with no elastic timeout armed, a
                # skipped slot would otherwise hang the round forever. The
                # round degrades to the exact partial aggregate over the
                # decodable uploads (an all-undecodable round keeps the
                # global model).
                if (sender - 1) in self.aggregator.flag_client_model_uploaded:
                    self.aggregator.flag_client_model_uploaded[sender - 1] = True
                if self.aggregator.check_whether_all_receive():
                    self._advance_round()
                return
            if self.wal is not None and \
                    self.aggregator.flag_client_model_uploaded.get(
                        int(sender) - 1):
                # journal the ACCEPT (fsync'd): the payload lives only in
                # this process — if we die before the round commits,
                # recovery ledgers this slot ``server_restart``
                self._uploads_this_round += 1
                self.wal.append(
                    "upload", sync=True, round=int(msg_round),
                    rank=int(sender),
                    client=(self._round_ids[int(sender) - 1]
                            if int(sender) - 1 < len(self._round_ids)
                            else None),
                    nsamp=float(
                        msg_params[MyMessage.MSG_ARG_KEY_NUM_SAMPLES]))
                self._maybe_crash("upload")
            if not self.aggregator.check_whether_all_receive():
                return
            self._advance_round()

    # ----------------------------------------------------- round economics
    def _goodput_round_start(self) -> None:
        """Stamp the round's start (its wall runs from here) and reset the
        last arrival; telemetry only."""
        if self.telemetry is not None:
            self._gp_bcast_start_t = time.monotonic()
            self._gp_last_arrival_t = None

    def _goodput_broadcast_end(self) -> None:
        """Stamp the broadcast's end: wire_wait runs from here to the last
        counted arrival."""
        if self.telemetry is not None:
            self._gp_bcast_end_t = time.monotonic()

    def _add_fleet_marker(self, msg) -> None:
        """The fleet enablement marker (obs/fleet.py) on a broadcast or
        dispatch frame: it tells the rank to piggyback digests on its
        uploads; absent with the plane off, so the wire stays
        byte-identical. A churn-armed server stamps avail, echoed by the
        rank's digests — a frame only reaches scheduled-online ranks,
        hence the constant."""
        if self._fleet is None:
            return
        marker = self._fleet.marker()
        if self.churn_trace is not None:
            marker = {**marker, "avail": 1.0}
        msg.add_params(MyMessage.MSG_ARG_KEY_TELEMETRY, marker)

    def _goodput_extra(self, spans: dict, wire_wait_s=None,
                       wall_s=None) -> dict:
        """The server round's ``goodput`` block (obs/goodput.py): wall from
        the broadcast stamp (sync) or the caller (async flush), wire_wait
        from broadcast end to the last counted arrival unless given,
        agg_flush from the aggregate span. The server dispatches no device
        round program, so the block is duty-cycle-only (relative goodput);
        the device-side figures live on the engine. {} when the stamps are
        missing (a restart mid-round)."""
        if wall_s is None:
            t0 = self._gp_bcast_start_t
            if t0 is None:
                return {}
            wall_s = time.monotonic() - t0
        if wire_wait_s is None:
            bce, arr = self._gp_bcast_end_t, self._gp_last_arrival_t
            wire_wait_s = (max(0.0, arr - bce)
                           if bce is not None and arr is not None else 0.0)
        buckets = _goodput.buckets_from_spans(
            wall_s, spans, wire_wait_s=wire_wait_s)
        return {"goodput": _goodput.round_goodput(wall_s, buckets)}

    def _round_record_extra(self) -> dict:
        """Extra blocks a subclass rides on the telemetry round record
        (the hierarchical root adds its ``hier`` block). An aggregator
        exposing ``privacy_record()`` (the DP defenses) gets its
        cumulative ε@δ and mechanism parameters on every round; rounds
        emitted after a restart carry the epoch (crash-recovery
        provenance); a churn-driven run carries how many ranks the trace
        held out this round and how many idle rounds it has taken."""
        extra: dict = {}
        pr = getattr(self.aggregator, "privacy_record", None)
        if pr is not None:
            block = pr()
            if block:
                extra["privacy"] = block
        if self._restart_epoch:
            extra["server"] = {"restarts": self._restart_epoch,
                               "restart_epoch": self._restart_epoch}
        if self.churn_trace is not None:
            extra["churn"] = {"scheduled_offline": len(self._offline_now),
                              "idle_rounds": self._idle_rounds}
        return extra

    def _advance_round(self):
        """Aggregate what's collected, eval, and start the next round (or
        finish). Caller holds _round_lock."""
        self._idle_logged_round = None  # real progress ends an idle stretch
        tel = self.telemetry
        if tel is not None:
            import numpy as np

            n_samples = float(sum(self.aggregator.sample_num_dict.values()))
            old_leaves = [np.asarray(v)
                          for v in self.aggregator.get_global_model_params()]
            with self._tracer.span("aggregate"):
                global_params = self.aggregator.aggregate()
            with self._tracer.span("eval"):
                self.aggregator.test_on_server_for_all_clients(self.round_idx)
            upd_sq = sum(
                float(np.sum((np.asarray(n) - o) ** 2))
                for n, o in zip(global_params, old_leaves))
            hist = self.aggregator.history
            # stitch: close the round's trace and fold the critical-path
            # attribution (straggler rank, phase breakdown, slack, chaos
            # cross-reference) into the round record
            cp = (self._dtracer.finish_round()
                  if self._dtracer is not None else None)
            q = self.aggregator.quarantine.for_round(self.round_idx)
            spans = dict(self._tracer.rounds[-1])
            tel.emit_round(
                self.round_idx, clients=self._round_ids,
                spans=spans,
                metrics={"update_norm": float(np.sqrt(upd_sq)),
                         "num_samples": n_samples},
                **self._goodput_extra(spans),
                evals=(hist[-1] if hist
                       and hist[-1].get("round") == self.round_idx else None),
                **({"critical_path": cp} if cp else {}),
                **({"quarantine": q} if q else {}),
                agg=self.aggregator.agg_record(),
                **self._round_record_extra())
            self._tracer.next_round()
        else:
            global_params = self.aggregator.aggregate()
            self.aggregator.test_on_server_for_all_clients(self.round_idx)
        self._maybe_save()
        self.round_idx += 1
        if self.round_idx == self.round_num:
            self._broadcast_finish()
            return
        self._broadcast_model(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                              global_params)

    def finish(self):
        try:
            super().finish()
        finally:
            if self.wal is not None:
                # flush + close the journal; a zombie timer appending
                # after this is a no-op (closed-handle check), which is
                # exactly the post-mortem silence a dead process has
                self.wal.close()

    def on_timeout(self, idle_s: float):
        """Watchdog (own thread): no traffic for round_timeout_s."""
        with self._round_lock:
            if self._async:
                # async analogue of elastic partial aggregation: a stalled
                # fleet flushes whatever is staged; a fully empty buffer
                # means every rank is dark — reprobe them instead of
                # waiting forever. A DRAINING server is quiet by design
                # (FINISH is out) — let the grace timer finish it.
                if self._finished.is_set() or self._draining:
                    return
                if len(self._buffer):
                    log.warning("async: fleet idle %.1fs — flushing %d "
                                "staged update(s)", idle_s,
                                len(self._buffer))
                    self._flush_buffer()
                else:
                    offline = self._scheduled_offline()
                    if offline and all(r in offline
                                       for r in range(1, self.size)):
                        # the WHOLE fleet is scheduled-offline: an idle
                        # trough, not a stall — log once per stretch,
                        # count it, and advance round_idx without folding
                        # (availability windows are round-indexed; a
                        # static round would freeze the trough's offline
                        # set and deadlock). The reprobe after the advance
                        # hands work to whoever the trace brought back.
                        if self._idle_logged_round is None:
                            log.info(
                                "async: fleet idle — every rank is "
                                "scheduled-offline by the churn trace; "
                                "advancing idle rounds until the next "
                                "arrival")
                            self._idle_logged_round = self.round_idx
                        _obs.record_round_idle()
                        self._idle_rounds += 1
                        self.round_idx += 1
                        if self.round_idx >= self.round_num:
                            self._finish_async()
                            return
                        self._async_reprobe(force=True)
                        return
                    log.error("async: fleet idle %.1fs with an empty "
                              "buffer — reprobing silent ranks", idle_s)
                    self._async_reprobe(force=True)
                return
            received = [i + 1 for i, v in
                        self.aggregator.flag_client_model_uploaded.items() if v]
            missing = [i + 1 for i, v in
                       self.aggregator.flag_client_model_uploaded.items() if not v]
            if self.round_timeout_s is None or self._finished.is_set():
                log.error("round %d stalled %.1fs: waiting on client ranks %s",
                          self.round_idx, idle_s, missing)
                return
            if not received:
                offline = self._scheduled_offline()
                if offline and all(r in offline for r in missing):
                    # every missing rank is scheduled-offline: an idle
                    # round, not a stall — log once per idle stretch,
                    # count fed_rounds_idle_total, and advance WITHOUT
                    # folding (availability windows are round-indexed, so
                    # standing still would deadlock an all-offline
                    # trough). The broadcast at the new round reaches
                    # whoever the trace brought back.
                    if self._idle_logged_round is None:
                        log.info(
                            "round %d: fleet idle — every missing rank "
                            "is scheduled-offline by the churn trace; "
                            "advancing idle rounds until the next "
                            "arrival", self.round_idx)
                        self._idle_logged_round = self.round_idx
                    _obs.record_round_idle()
                    self._idle_rounds += 1
                    self.round_idx += 1
                    if self.round_idx == self.round_num:
                        self._broadcast_finish()
                        return
                    self._broadcast_model(
                        MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                        self.aggregator.get_global_model_params())
                    return
                # elastic round with NOTHING to aggregate: re-broadcast the
                # current global instead of folding an empty cohort — a
                # recovered rank gets a fresh shot at the round. Clear the
                # undeliverable marks first: a rank marked THIS round is
                # skipped by send_message until round_idx moves, which it
                # cannot while stalled (a re-failed send re-marks it).
                log.error("round %d stalled %.1fs with NO uploads — "
                          "re-broadcasting round state to ranks %s",
                          self.round_idx, idle_s, missing)
                self._undeliverable.clear()
                self._update_alive_gauge()
                self._broadcast_model(
                    MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                    self.aggregator.get_global_model_params())
                return
            log.warning(
                "round %d: elastic partial aggregation over ranks %s "
                "(stragglers %s dropped after %.1fs)",
                self.round_idx, received, missing, idle_s,
            )
            for i in list(self.aggregator.flag_client_model_uploaded):
                self.aggregator.flag_client_model_uploaded[i] = False
            self._advance_round()
