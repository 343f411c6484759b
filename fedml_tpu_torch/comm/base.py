"""Abstract communication backend API.

Mirror of fedml_core/distributed/communication/base_com_manager.py:7-27,
with one behavioral fix: the reference's MPI manager polls its receive queue
with a 0.3 s sleep (mpi/com_manager.py:71-78), which puts a 0.3 s floor under
every round. Backends here block on the queue instead, so message dispatch
latency is microseconds.
"""

from __future__ import annotations

import abc
import queue
import threading
import time
from typing import TYPE_CHECKING

from fedml_tpu_torch.obs import comm_instrument as _obs

if TYPE_CHECKING:
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.comm.observer import Observer


class BaseCommManager(abc.ABC):
    # wire-accounting label (obs/comm_instrument); backends override
    backend_name = "base"

    def __init__(self):
        self._observers: list["Observer"] = []
        # (message, enqueue-time) pairs: the dispatch loop reports how long
        # each decoded message waited before its handler ran
        self._q: "queue.Queue[tuple[Message, float]]" = queue.Queue()
        self._running = threading.Event()

    # ------------------------------------------------------------- interface
    @abc.abstractmethod
    def send_message(self, msg: "Message") -> None:
        ...

    def add_observer(self, observer: "Observer") -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: "Observer") -> None:
        self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        """Dispatch loop: block on the inbound queue, notify observers.

        Returns when stop_receive_message() is called.
        """
        self._running.set()
        while self._running.is_set():
            try:
                msg, t_in = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            _obs.record_dispatch_latency(self.backend_name,
                                         time.perf_counter() - t_in)
            self._notify(msg)

    def stop_receive_message(self) -> None:
        self._running.clear()

    # -------------------------------------------------------------- plumbing
    def _encode(self, msg: "Message", codec: str | None = None) -> bytes:
        """Serialize an outgoing message through the wire codec, recording
        messages/bytes-per-codec into the process metrics registry. Every
        backend's send path routes through here so loopback, gRPC, and MQTT
        report identically.

        Direction split: frames addressed TO rank 0 are uplink, everything
        else downlink (rank 0 is the server in every protocol here), so
        ``comm_bytes_total{codec,direction}`` separates the broadcast-
        dominated downlink from the uplink byte budget the delta/quantized
        tiers optimize. The codec label is the EFFECTIVE tier — the
        update codec riding the message (top-k / comm/delta.py tiers)
        composed with the frame codec — not just the frame codec."""
        from fedml_tpu_torch.comm import message as _message

        frame = msg.to_bytes(codec)
        frame_codec = codec if codec is not None else _message._CODEC
        _obs.record_send(self.backend_name, frame_codec,
                         len(frame), str(msg.get_type()))
        params = msg.get_params()
        upd = params.get("upd_codec")
        if upd is None and "sparse_idx" in params:
            upd = "topk"
        if upd is None and "delta_params" in params:
            upd = "delta-bcast"  # round-delta downlink (server side)
        eff = (frame_codec if upd is None
               else str(upd) if frame_codec == "none"
               else f"{upd}+{frame_codec}")
        # protocol frames with a registered override (e2s_evidence /
        # s2e_verdict — the cross-tier robust control plane) are accounted
        # under their own direction label so their byte budget is
        # separable from the update-frame traffic they exist to bound
        direction = _obs.direction_override(msg.get_type())
        if direction is None:
            try:
                direction = ("uplink" if int(msg.get_receiver_id()) == 0
                             else "downlink")
            except (TypeError, ValueError, KeyError):
                direction = "downlink"  # interop peers with exotic ids
        _obs.record_wire_bytes(eff, direction, len(frame))
        return frame

    def _receive_frame(self, data: bytes) -> None:
        """Decode an inbound frame, record its size, and enqueue it for the
        dispatch loop — the shared receive half of ``_encode``.

        A frame that fails to decode — CRC32 mismatch (message.py FMT2),
        bad magic, damaged deflate stream, or any downstream parse error a
        flipped bit can cause (CorruptFrame and the json/frombuffer errors
        are ValueError; a truncated header manifest raises KeyError) — is
        dropped and counted (``comm_corrupt_frames_total``), never raised:
        wire damage must degrade one frame, not kill the transport's
        receive thread and wedge the job. Only those two exception types
        are absorbed — a genuine programming error in the decode path
        still fails fast (the same rationale as ``_notify``'s re-raise)."""
        from fedml_tpu_torch.comm.message import Message

        _obs.record_receive(self.backend_name, len(data))
        try:
            msg = Message.from_bytes(data)
        except (ValueError, KeyError):
            _obs.record_corrupt_frame(self.backend_name)
            import logging

            logging.getLogger("fedml_tpu_torch.comm").warning(
                "dropping corrupt %d-byte frame", len(data), exc_info=True)
            return
        # liveness: a decoded frame proves its sender alive — feeds the
        # fed_last_heartbeat_age_seconds{rank} gauges on every transport
        _obs.record_rank_seen(msg.get_params().get("sender"))
        self._enqueue(msg)

    def _enqueue(self, msg: "Message") -> None:
        self._q.put((msg, time.perf_counter()))

    def _notify(self, msg: "Message") -> None:
        for obs in list(self._observers):
            try:
                obs.receive_message(msg.get_type(), msg.get_params())
            except Exception:
                # log with traceback THEN re-raise: a silently swallowed
                # handler error turns protocol bugs into eternal hangs, and a
                # silently dead loop does too. Re-raising fails the server's
                # run() fast (the reference's MPI.Abort analogue) while the
                # log names the culprit; client daemon threads die visibly.
                import logging

                logging.getLogger("fedml_tpu_torch.comm").exception(
                    "handler for msg_type=%s raised", msg.get_type())
                raise
