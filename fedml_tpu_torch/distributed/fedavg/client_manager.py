"""FedAvg client manager, port of fedml_tpu/distributed/fedavg/client_manager.py
(the dense synchronous protocol): on INIT/SYNC, take the broadcast model and
the assigned client index, run the local fit, upload to rank 0.

Mirror of fedml_api/distributed/fedavg/FedAvgClientManager.py (:66-75).
The upload is encoded and sent on a FIFO sender thread
(core/pipeline.AsyncSender), so the dispatch loop stays free to receive
the next broadcast. The reference's encoded uplinks (top-k, delta and
quantized tiers), adversary plans, edge tiers, round-delta downlinks,
async dispatch waves and crash-recovery epochs are queued in ROADMAP.md
(queue A, items 7-8): a rank asked for one raises.
"""

from __future__ import annotations

import logging
import time

from fedml_tpu_torch.comm.managers import ClientManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.distributed.fedavg.aggregator import refuse_unported
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.distributed.fedavg.trainer import DistributedTrainer

log = logging.getLogger("fedml_tpu_torch.distributed.fedavg")

# downlink keys of protocols this slice does not run -> their ROADMAP item
_UNPORTED_DOWNLINK = {MyMessage.MSG_ARG_KEY_DELTA_PARAMS: 7,
                      MyMessage.MSG_ARG_KEY_DISPATCH_WAVE: 8,
                      MyMessage.MSG_ARG_KEY_RESTART_EPOCH: 8}


class FedAvgClientManager(ClientManager):
    def __init__(self, trainer: DistributedTrainer, rank, size,
                 backend="LOOPBACK", sparsify_ratio: float | None = None,
                 adversary_plan=None, update_codec: str | None = None,
                 error_feedback: bool = True, server_rank: int = 0,
                 adversary_rank: int | None = None, **kw):
        refuse_unported("FedAvgClientManager", {
            "sparsify_ratio": (sparsify_ratio is not None, 7),
            "adversary_plan": (adversary_plan is not None, 7),
            "update_codec": (update_codec not in (None, "dense", ""), 7),
            "error_feedback": (not error_feedback, 7),
            "server_rank": (server_rank != 0, 7),
            "adversary_rank": (adversary_rank is not None, 7)})
        self.trainer = trainer
        self.round_idx = 0
        self.server_rank = 0
        # uplinks are encoded and sent on a FIFO worker, not the dispatch
        # loop's thread; a send failure still kills the manager visibly
        # (re-raised from the next submit / finish)
        self._sender = None
        super().__init__(rank, size, backend, **kw)

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init
        )
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, self.handle_message_receive_model
        )
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_FINISH, lambda _m: self.finish()
        )

    def handle_message_init(self, msg_params):
        self.round_idx = 0
        self._sync_and_train(msg_params)

    def handle_message_receive_model(self, msg_params):
        self.round_idx += 1  # fallback when the server omits the round tag
        self._sync_and_train(msg_params)

    def _sync_and_train(self, msg_params):
        for key, item in _UNPORTED_DOWNLINK.items():
            if key in msg_params:
                raise NotImplementedError(
                    f"rank {self.rank}: the server sent {key!r}, a protocol "
                    f"not ported yet: ROADMAP.md queue A, item {item}")
        # trust the server's round counter (keeps stragglers aligned after an
        # elastic partial aggregation skipped them)
        self.round_idx = int(msg_params.get(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx))
        self.trainer.update_model(msg_params[MyMessage.MSG_ARG_KEY_MODEL_PARAMS])
        self.trainer.update_dataset(int(msg_params[MyMessage.MSG_ARG_KEY_CLIENT_INDEX]))
        t0 = time.perf_counter()
        wire_leaves, local_sample_num = self.trainer.train(self.round_idx)
        log.info("rank %d round %d: client %d fit on %d samples and packed "
                 "in %.3f s", self.rank, self.round_idx,
                 self.trainer.client_index, local_sample_num,
                 time.perf_counter() - t0)
        msg = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank,
                      self.server_rank)
        msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, wire_leaves)
        msg.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, local_sample_num)
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
        self._send_upload(msg)

    def _send_upload(self, msg):
        if self._sender is None:  # lazy: only a manager that uploads pays
            from fedml_tpu_torch.core.pipeline import AsyncSender

            self._sender = AsyncSender(self.send_message,
                                       name=f"fedml-uplink-r{self.rank}",
                                       on_error=self._on_uplink_error)
        self._sender.submit(msg)

    def _on_uplink_error(self, exc):
        """Sender-worker failure hook (runs on the worker thread). Without
        it a failed upload would HANG this rank: the next wake-up would be
        a broadcast the server will never send (it is still waiting for the
        upload that just died). Shut the manager down instead."""
        log.error(
            "rank %d: uplink send failed (%s) — shutting down instead of "
            "waiting for a broadcast the server cannot send", self.rank, exc)
        self._sender = None  # worker already dead; nothing left to flush
        self.finish()

    def warmup(self) -> dict:
        """See DistributedTrainer.warmup: nothing to compile here."""
        return self.trainer.warmup()

    def finish(self):
        sender, self._sender = self._sender, None
        try:
            if sender is not None:
                # flush the queued uplink (normally empty: FINISH only
                # arrives after the server collected the last round) and
                # surface any send failure before reporting a clean exit
                sender.close()
        finally:
            # the transport must stop even when close() raises
            super().finish()
