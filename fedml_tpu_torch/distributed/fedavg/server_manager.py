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

The WAL, checkpoints and resume, crash points, buffered-async rounds,
heartbeat admission, churn traces, fused ingest and goodput records are
queued in ROADMAP.md (queue A, items 7-8); passing one raises.
"""

from __future__ import annotations

import contextlib
import logging
import threading

from fedml_tpu_torch.comm.managers import ServerManager
from fedml_tpu_torch.comm.message import (
    Message,
    check_wire_leaves,
    codec_roundtrip,
)
from fedml_tpu_torch.data import dataset_source
from fedml_tpu_torch.distributed.fedavg.aggregator import (
    FedAvgAggregator,
    refuse_unported,
)
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.obs import comm_instrument as _obs
from fedml_tpu_torch.obs.tracing import TRACE_KEY

log = logging.getLogger("fedml_tpu_torch.distributed.fedavg")


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
        refuse_unported("FedAvgServerManager", {
            "ckpt_dir": (ckpt_dir is not None, 8),
            "wal_dir": (wal_dir is not None, 8),
            "async_buffer_k": (async_buffer_k is not None, 8),
            "staleness": (staleness != "constant", 8),
            "staleness_bound": (staleness_bound is not None, 8),
            "buffer_deadline_s": (buffer_deadline_s is not None, 8),
            "buffer_capacity": (buffer_capacity is not None, 8),
            "heartbeat_max_age_s": (heartbeat_max_age_s is not None, 8),
            "churn_trace": (churn_trace is not None, 8)})
        self.aggregator = aggregator
        self.round_num = aggregator.cfg.comm_round
        self.round_idx = 0
        # version -> the broadcast AS CLIENTS HOLD IT (decoded through the
        # frame codec; under delta_broadcast the exact chain value). Every
        # encoded uplink names the version it encoded against via its
        # ROUND tag and densifies against THIS table; a version never
        # stashed is a loud protocol error.
        self._version_pack: dict[int, list] = {}
        # rank -> the version its last upload PROVED it holds (the upload's
        # round tag): the delta-broadcast warm set. Proof-based tracking
        # self-heals to the dense fallback after a dropped frame.
        self._rank_version: dict[int, int] = {}
        # round-delta downlink: warm ranks get global@r - global@r-1, cold
        # ranks (joiners, ranks that missed a round) the dense fallback
        self.delta_broadcast = bool(delta_broadcast)
        self.round_timeout_s = round_timeout_s
        # rank -> round its delivery last failed. Initialized HERE, not
        # lazily at first failure: two sender paths (round loop + watchdog
        # thread) can fail concurrently.
        self._undeliverable: dict[int, int] = {}
        self._round_ids: list[int] = []
        # obs.Telemetry: per-round event records (sampled ids, aggregate/eval
        # span timings, update norm, comm byte/message deltas). None = no
        # extra work.
        self.telemetry = telemetry
        # cross-rank tracer (obs/tracing.py): present only when the
        # Telemetry bundle opted in (trace_dir / trace=True). None = no
        # __trace params on any frame — the wire is byte-identical.
        self._dtracer = telemetry.tracer if telemetry is not None else None
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
        """fed_ranks_alive from the undeliverable bookkeeping."""
        _obs.set_ranks_alive(self.size - 1 - len(self._undeliverable))

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
        if self.round_idx >= self.round_num:
            self._broadcast_finish()
            return
        log.info("server up: broadcasting round %d to %d client ranks",
                 self.round_idx, self.size - 1)
        self.send_init_msg()
        super().run()

    def _broadcast_model(self, msg_type: str, global_params) -> None:
        """Sample this round's clients and broadcast ``global_params`` to
        every rank under ``msg_type`` — the shared body of send_init_msg
        and the round-advance sync (they must not diverge)."""
        client_indexes = self.aggregator.client_sampling(self.round_idx)
        self._round_ids = [int(c) for c in client_indexes]
        # stamp the aggregator's accepted round BEFORE any client can
        # answer the broadcast — uploads tagged with any other round are
        # rejected at the slotting layer (add_local_trained_result)
        self.aggregator.begin_round(self.round_idx)
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
            if tr is not None:  # trace context rides the header scalars
                msg.add_params(TRACE_KEY, tr.broadcast_ctx(rank))
            self.send_message(msg)
        if tr is not None:
            tr.end_broadcast()

    def send_init_msg(self):
        self._broadcast_model(MyMessage.MSG_TYPE_S2C_INIT_CONFIG,
                              self.aggregator.get_global_model_params())

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self.handle_message_receive_model_from_client,
        )

    # sync rounds only look up the current version (the round-tag gate
    # drops anything else before densify), and the delta chain needs only
    # r-1: two stashed versions, not a model copy per round
    _VERSION_RETAIN = 2

    def _stash_version(self, version: int, decoded_leaves) -> None:
        self._version_pack[int(version)] = decoded_leaves
        for v in [v for v in self._version_pack
                  if v <= version - self._VERSION_RETAIN]:
            del self._version_pack[v]

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
            self.aggregator.quarantine.record(
                self.round_idx, sender, "undecodable")
            _obs.record_update_rejected("undecodable")
            log.warning("quarantining undecodable upload from rank %d "
                        "(%s)", sender, e)
            return None
        return leaves

    def handle_message_receive_model_from_client(self, msg_params):
        with self._round_lock:
            sender = msg_params[Message.MSG_ARG_KEY_SENDER]
            msg_round = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
            if int(msg_round) != self.round_idx:
                _obs.record_stale_upload("stale")
                log.warning("drop stale upload from rank %d (round %s, now %d)",
                            sender, msg_round, self.round_idx)
                return
            tel = self.telemetry
            if self._dtracer is not None:
                # arrival time + clock sample + the piggybacked client
                # span buffer (None from an untraced peer is fine — the
                # arrival alone keeps slack computable)
                self._dtracer.on_upload(int(sender),
                                        msg_params.get(TRACE_KEY))
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
                wire_leaves = self._decode_upload(msg_params, int(sender),
                                                  int(msg_round))
                if wire_leaves is not None:
                    self.aggregator.add_local_trained_result(
                        sender - 1,
                        wire_leaves,
                        msg_params[MyMessage.MSG_ARG_KEY_NUM_SAMPLES],
                        round_idx=int(msg_round),
                    )
            if wire_leaves is None:
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
            if not self.aggregator.check_whether_all_receive():
                return
            self._advance_round()

    def _advance_round(self):
        """Aggregate what's collected, eval, and start the next round (or
        finish). Caller holds _round_lock."""
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
                evals=(hist[-1] if hist
                       and hist[-1].get("round") == self.round_idx else None),
                **({"critical_path": cp} if cp else {}),
                **({"quarantine": q} if q else {}),
                agg=self.aggregator.agg_record())
            self._tracer.next_round()
        else:
            global_params = self.aggregator.aggregate()
            self.aggregator.test_on_server_for_all_clients(self.round_idx)
        self.round_idx += 1
        if self.round_idx == self.round_num:
            self._broadcast_finish()
            return
        self._broadcast_model(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                              global_params)

    def on_timeout(self, idle_s: float):
        """Watchdog (own thread): no traffic for round_timeout_s."""
        with self._round_lock:
            received = [i + 1 for i, v in
                        self.aggregator.flag_client_model_uploaded.items() if v]
            missing = [i + 1 for i, v in
                       self.aggregator.flag_client_model_uploaded.items() if not v]
            if self.round_timeout_s is None or self._finished.is_set():
                log.error("round %d stalled %.1fs: waiting on client ranks %s",
                          self.round_idx, idle_s, missing)
                return
            if not received:
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
