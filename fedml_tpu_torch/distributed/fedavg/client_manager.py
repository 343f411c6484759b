"""FedAvg client manager, port of fedml_tpu/distributed/fedavg/client_manager.py
(the synchronous protocol): on INIT/SYNC, take the broadcast model (dense,
or a round delta against the held base) and the assigned client index, run
the local fit, upload to the server rank (dense, top-k or a delta tier).

Mirror of fedml_api/distributed/fedavg/FedAvgClientManager.py (:66-75).
The upload is encoded and sent on a FIFO sender thread
(core/pipeline.AsyncSender), so the dispatch loop stays free to receive
the next broadcast.

Tracing: when an inbound broadcast carries ``__trace`` context (the server
has tracing on), the handler times its unpack / local_fit / pack phases as
spans parented to the server's broadcast span and piggybacks the finished
buffer (plus the clock stamps) on the upload frame — so clients trace
exactly when the server does, with zero client-side configuration. With no
context present the upload is byte-identical. Where the reference's
local_fit also packs the fit's result to the host, the port's ends when
the fit's kernels have (a device sync), and pack carries ``pack_pytree``
(the copy to the host, the flax layout) and the uplink tier's encode.

A Byzantine rank (``adversary_plan``, chaos/adversary.py) perturbs its
wire leaves after the honest fit and before the uplink tier encodes them
(``perturb_leaves``), so every tier and every server defense sees what an
attacker would send. In the hierarchical topology (hierarchy.py) a
worker's ``server_rank`` is its edge aggregator: uploads go there, and
``adversary_rank`` is its cohort slot + 1, so one plan drives a flat and a
tree run alike.

Buffered-async dispatch: a frame carrying a ``dispatch_wave`` keys the fit
by the wave (a requeued dispatch within one global version draws fresh
batches) and the wave and client index are echoed on the upload. Crash
recovery: the server's restart epoch is adopted from any s2c frame that
carries it and echoed on every upload, and a recovered server's resume
probe is answered with this rank's last round and wave. The fleet plane
(obs/fleet.py) is zero-config here, like tracing: the first frame carrying
the server's ``__telemetry`` marker arms a ``DigestEmitter``, which times
this rank's phases and rides one digest on every upload after it.
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

from fedml_tpu_torch.comm.managers import ClientManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.distributed.fedavg.trainer import DistributedTrainer
from fedml_tpu_torch.obs.fleet import TELEMETRY_KEY, DigestEmitter, attach_digest
from fedml_tpu_torch.obs.tracing import TRACE_KEY, ClientSpanBuffer

log = logging.getLogger("fedml_tpu_torch.distributed.fedavg")


class FedAvgClientManager(ClientManager):
    def __init__(self, trainer: DistributedTrainer, rank, size,
                 backend="LOOPBACK", sparsify_ratio: float | None = None,
                 adversary_plan=None, update_codec: str | None = None,
                 error_feedback: bool = True, server_rank: int = 0,
                 adversary_rank: int | None = None, **kw):
        self.trainer = trainer
        # model-space adversary: when this rank is in the plan's schedule
        # its upload is perturbed after the honest fit. ``adversary_rank``
        # is the 1-based cohort rank the plan matches (default: this
        # transport rank, the flat topology's identity)
        self.adversary_plan = adversary_plan
        self.adversary_rank = (int(adversary_rank) if adversary_rank
                               is not None else int(rank))
        self.round_idx = 0
        # where uploads go: rank 0, or this worker's edge in the tree
        self.server_rank = int(server_rank)
        # uplinks are encoded and sent on a FIFO worker, not the dispatch
        # loop's thread; a send failure still kills the manager visibly
        # (re-raised from the next submit / finish)
        self._sender = None
        # top-k sparsified uplinks (comm/sparse.py); None = dense protocol.
        # Validated HERE so a bad ratio fails at launch, not inside the
        # receive-loop handler after a full local fit
        if sparsify_ratio is not None and not 0.0 < sparsify_ratio <= 1.0:
            raise ValueError(
                f"sparsify_ratio must be in (0, 1], got {sparsify_ratio}")
        self.sparsify_ratio = sparsify_ratio
        # delta/quantized uplink tier (comm/delta.py): 'delta' |
        # 'delta-int8' | 'delta-sign1'; None/'dense' = the full-model
        # protocol. Mutually exclusive with top-k: both replace
        # MODEL_PARAMS on the wire.
        if update_codec in ("dense", ""):
            update_codec = None
        if update_codec is not None:
            from fedml_tpu_torch.comm.delta import UPDATE_CODECS

            if update_codec not in UPDATE_CODECS:
                raise ValueError(f"unknown update_codec {update_codec!r} "
                                 f"(one of {UPDATE_CODECS} or 'dense')")
            if sparsify_ratio:
                raise ValueError(
                    "update_codec and sparsify_ratio are mutually "
                    "exclusive uplink tiers — pick one")
        self.update_codec = update_codec
        # one shared error-feedback residual (comm/ef.py) owned by ALL
        # lossy tiers (top-k AND the quantized delta tiers);
        # error_feedback=False is the convergence-ablation knob only
        self._ef = None
        if error_feedback and (sparsify_ratio or
                               update_codec in ("delta-int8", "delta-sign1")):
            from fedml_tpu_torch.comm.ef import ErrorFeedback

            self._ef = ErrorFeedback()
        # the decoded broadcast currently held + its version tag — the
        # base every delta tier encodes against, and what a round-delta
        # broadcast (MSG_ARG_KEY_DELTA_PARAMS) reconstructs from
        self._held = None
        self._held_version: int | None = None
        self._trace_buf: ClientSpanBuffer | None = None  # lazy: see module doc
        # fleet digest emitter: created the first time a frame carries the
        # __telemetry marker. None = plane off = the uplink is
        # byte-identical.
        self._digest: DigestEmitter | None = None
        # crash-recovery session tag (adopted from the server, echoed on
        # uploads) and the last async dispatch wave (kept for the probe)
        self._restart_epoch = 0
        self._last_wave: int | None = None
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
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_RESUME_PROBE,
            self.handle_message_resume_probe,
        )

    def handle_message_init(self, msg_params):
        self.round_idx = 0
        self._sync_and_train(msg_params)

    def handle_message_resume_probe(self, msg_params):
        """Post-restart server probe: adopt the new restart epoch — every
        later upload echoes it, which is what lets the server shed this
        client's pre-crash in-flight work — and answer with the last round
        (and async dispatch wave) this client saw, so the server
        re-dispatches or sheds deterministically. Handlers run serially:
        if this client was mid-fit when the server died, the probe is
        answered right after that fit's (now epoch-stale) upload is
        queued."""
        self._restart_epoch = int(msg_params.get(
            MyMessage.MSG_ARG_KEY_RESTART_EPOCH, self._restart_epoch))
        # answer the PROBE'S sender: probes always come straight from the
        # root, and in the hierarchical topology self.server_rank is this
        # worker's edge — which has no ack handler
        probe_src = int(msg_params.get(Message.MSG_ARG_KEY_SENDER,
                                       self.server_rank))
        msg = Message(MyMessage.MSG_TYPE_C2S_RESUME_ACK, self.rank,
                      probe_src)
        msg.add_params(MyMessage.MSG_ARG_KEY_LAST_SEEN_ROUND,
                       int(self.round_idx))
        msg.add_params(MyMessage.MSG_ARG_KEY_LAST_SEEN_WAVE,
                       -1 if self._last_wave is None
                       else int(self._last_wave))
        msg.add_params(MyMessage.MSG_ARG_KEY_RESTART_EPOCH,
                       self._restart_epoch)
        self.send_message(msg)

    def handle_message_receive_model(self, msg_params):
        self.round_idx += 1  # fallback when the server omits the round tag
        self._sync_and_train(msg_params)

    def _global_leaves(self, msg_params):
        """The broadcast's global model as wire leaves: the dense params,
        or global@r = held@base + delta for a round-delta broadcast. The
        server only sends deltas to ranks whose last UPLOAD proved they
        hold the base version, so a mismatch is a protocol violation
        (e.g. a restarted client the server still believes warm) — fail
        loudly rather than train against a wrong base."""
        if MyMessage.MSG_ARG_KEY_DELTA_PARAMS not in msg_params:
            return msg_params[MyMessage.MSG_ARG_KEY_MODEL_PARAMS]
        from fedml_tpu_torch.comm.delta import apply_delta

        base_v = int(msg_params[MyMessage.MSG_ARG_KEY_BASE_VERSION])
        if self._held is None or self._held_version != base_v:
            raise RuntimeError(
                f"rank {self.rank}: delta broadcast against version "
                f"{base_v} but this client holds "
                f"{self._held_version} — the server's warm-rank "
                "tracking and this client disagree (restarted client?)")
        return apply_delta(self._held,
                           msg_params[MyMessage.MSG_ARG_KEY_DELTA_PARAMS])

    def _encode_upload(self, msg, wire_leaves, global_leaves) -> None:
        """Put the fit's result on ``msg`` in this rank's uplink tier:
        top-k of the round delta, an encoded round delta, or the dense
        leaves. The lossy tiers fold the shared error-feedback residual
        in before encoding and keep what the server will not see."""
        if self.sparsify_ratio:
            from fedml_tpu_torch.comm.sparse import (topk_delta, topk_encode,
                                                     topk_residual)

            delta = topk_delta(wire_leaves, global_leaves)
            comp = self._ef.compensate(delta) if self._ef else delta
            idx, vals = topk_encode(comp, self.sparsify_ratio)
            if self._ef:
                # topk_residual IS comp - shipped: install it directly
                self._ef.update_residual(topk_residual(comp, idx))
            msg.add_params(MyMessage.MSG_ARG_KEY_SPARSE_IDX, idx)
            msg.add_params(MyMessage.MSG_ARG_KEY_SPARSE_VAL, vals)
        elif self.update_codec:
            from fedml_tpu_torch.comm.delta import (decode_update,
                                                    encode_update, round_delta)

            delta = round_delta(wire_leaves, global_leaves)
            comp = self._ef.compensate(delta) if self._ef else delta
            payload, scales = encode_update(comp, self.update_codec)
            if self._ef:
                # residual tracks the SERVER's view: comp minus the
                # decoded form of what actually went on the wire
                self._ef.update(comp, decode_update(
                    payload, scales, self.update_codec, wire_leaves))
            msg.add_params(MyMessage.MSG_ARG_KEY_UPDATE_CODEC,
                           self.update_codec)
            msg.add_params(MyMessage.MSG_ARG_KEY_UPDATE_PAYLOAD, payload)
            msg.add_params(MyMessage.MSG_ARG_KEY_UPDATE_SCALE, scales)
        else:
            msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, wire_leaves)

    def _sync_and_train(self, msg_params):
        # trust the server's round counter (keeps stragglers aligned after an
        # elastic partial aggregation skipped them)
        self.round_idx = int(msg_params.get(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx))
        # adopt the server's restart epoch from any s2c frame carrying one
        # (a post-crash broadcast can arrive before the resume probe)
        ep = msg_params.get(MyMessage.MSG_ARG_KEY_RESTART_EPOCH)
        if ep is not None:
            self._restart_epoch = int(ep)
        # buffered-async dispatch: the server's dispatch-wave counter is
        # the work-unit key — the fit's batch order is keyed by the WAVE
        # (a requeued dispatch within one global version draws fresh
        # batches), and the wave is echoed on the upload so the server
        # attributes it exactly even with two dispatches in flight after
        # a reprobe. Absent on synchronous rounds: round_idx keys the fit,
        # nothing is echoed, and the wire is unchanged.
        wave = msg_params.get(MyMessage.MSG_ARG_KEY_DISPATCH_WAVE)
        if wave is not None:
            self._last_wave = int(wave)  # answered on a resume probe
        buf = None
        blob = msg_params.get(TRACE_KEY)
        if isinstance(blob, dict) and blob.get("tid"):  # server is tracing
            if self._trace_buf is None:
                self._trace_buf = ClientSpanBuffer(self.rank)
            buf = self._trace_buf
            buf.on_broadcast(blob)
        # fleet plane marker: the server's collector is armed — start
        # digesting (lazy, like the trace buffer)
        dig = None
        tmark = msg_params.get(TELEMETRY_KEY)
        if isinstance(tmark, dict):
            if self._digest is None:
                self._digest = DigestEmitter(self.rank)
            dig = self._digest
            dig.on_downlink(tmark)

        @contextlib.contextmanager
        def span(name):
            # compose the (independent) trace span and digest phase
            # timers — either plane can be on without the other
            with (buf.span(name) if buf is not None
                  else contextlib.nullcontext()):
                with (dig.phase(name) if dig is not None
                      else contextlib.nullcontext()):
                    yield
        global_leaves = self._global_leaves(msg_params)
        # the held base: what every delta tier encodes against, and the
        # next round-delta broadcast reconstructs from
        self._held = global_leaves
        self._held_version = self.round_idx
        with span("unpack"):
            self.trainer.update_model(global_leaves)
            self.trainer.update_dataset(int(msg_params[MyMessage.MSG_ARG_KEY_CLIENT_INDEX]))
        t0 = time.perf_counter()
        with span("local_fit"):
            local_sample_num = self.trainer.fit(
                self.round_idx if wave is None else int(wave))
            if self.trainer.device.type == "cuda":
                # the fit's kernels end inside its span, not in pack's D2H
                torch.cuda.synchronize(self.trainer.device)
        msg = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank,
                      self.server_rank)
        with span("pack"):
            wire_leaves = self.trainer.wire_leaves()
            if self.adversary_plan is not None:
                from fedml_tpu_torch.chaos.adversary import perturb_leaves

                wire_leaves = perturb_leaves(
                    self.adversary_plan, wire_leaves, global_leaves,
                    self.adversary_rank, self.round_idx)
            self._encode_upload(msg, wire_leaves, global_leaves)
            msg.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, local_sample_num)
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
            if self._restart_epoch:
                # echo the session tag: a restarted server's epoch gate
                # sheds pre-crash uploads by exactly this mismatch
                msg.add_params(MyMessage.MSG_ARG_KEY_RESTART_EPOCH,
                               self._restart_epoch)
            if wave is not None:  # echo the async work-unit key verbatim
                msg.add_params(MyMessage.MSG_ARG_KEY_DISPATCH_WAVE, int(wave))
                # ... and the client id, so the server's ingest path never
                # rebuilds the seeded sampling permutation per upload
                msg.add_params(
                    MyMessage.MSG_ARG_KEY_CLIENT_INDEX,
                    int(msg_params[MyMessage.MSG_ARG_KEY_CLIENT_INDEX]))
        log.info("rank %d round %d: client %d fit on %d samples and packed "
                 "in %.3f s", self.rank, self.round_idx,
                 self.trainer.client_index, local_sample_num,
                 time.perf_counter() - t0)
        if buf is not None:  # span buffer + clock stamps ride the uplink
            msg.add_params(TRACE_KEY, buf.upload_blob())
        if dig is not None:  # the fleet digest rides the same frame
            attach_digest(msg, dig.digest(self.round_idx, wave=wave))
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
        """See DistributedTrainer.warmup: the fit once per common depth."""
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
