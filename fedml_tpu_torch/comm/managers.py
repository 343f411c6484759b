"""Client/Server manager base classes — handler registry + dispatch loop.
Port of fedml_tpu/comm/managers.py without its chaos wrap (ROADMAP.md
queue A, item 8).

Mirror of fedml_core/distributed/client/client_manager.py:13-73 and
.../server/server_manager.py:13-68: a manager owns a comm backend, registers
per-msg_type callbacks, and runs the receive loop.

Differences from the reference (deliberate):
- Backend switch offers loopback/grpc/mqtt (no MPI — SURVEY.md §2.8: on-TPU
  transport is XLA collectives; this layer is inter-job only).
- finish() shuts the transport down cleanly instead of
  MPI.COMM_WORLD.Abort() (client_manager.py:66-73) which nukes every rank.
- A watchdog thread (failure detection — absent in the reference, SURVEY.md
  §5) calls ``on_timeout`` if no message arrives for ``timeout_s``, so a
  dead peer surfaces as a callback instead of an eternal hang.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

from fedml_tpu_torch.comm.base import BaseCommManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.observer import Observer
from fedml_tpu_torch.obs import comm_instrument as _obs

log = logging.getLogger("fedml_tpu_torch.comm.managers")


def make_comm_manager(backend: str, rank: int, size: int, **kw) -> BaseCommManager:
    """Backend switch (parity with client_manager.py:20-32). The reference
    package wraps the manager in its chaos fault injector when a FaultPlan
    is installed; the port has no chaos plans yet (ROADMAP.md queue A,
    item 8), so the manager comes back as built."""
    backend = backend.upper()
    if backend == "LOOPBACK":
        from fedml_tpu_torch.comm.loopback import LoopbackCommManager

        mgr: BaseCommManager = LoopbackCommManager(
            kw.get("job_id", "default"), rank, size)
    elif backend == "GRPC":
        from fedml_tpu_torch.comm.grpc_backend import GrpcCommManager

        mgr = GrpcCommManager(
            rank, size, ip_table=kw.get("ip_table"),
            base_port=kw.get("base_port", 50000),
            send_timeout_s=kw.get("send_timeout_s", 600.0),
        )
    elif backend == "MQTT":
        from fedml_tpu_torch.comm.mqtt_backend import MqttCommManager

        mgr = MqttCommManager(
            kw.get("broker_host", "127.0.0.1"), kw.get("broker_port", 1883),
            rank, size - 1, job_id=kw.get("job_id"),
        )
    else:
        raise ValueError(f"unknown backend {backend!r} (LOOPBACK|GRPC|MQTT)")
    return mgr


class DistributedManager(Observer):
    """Shared machinery of ClientManager/ServerManager."""

    def __init__(
        self,
        rank: int,
        size: int,
        backend: str = "LOOPBACK",
        timeout_s: float | None = None,
        **backend_kw,
    ):
        self.rank, self.size, self.backend = rank, size, backend
        self.com_manager = make_comm_manager(backend, rank, size, **backend_kw)
        self.com_manager.add_observer(self)
        self._handlers: dict[str, Callable] = {}
        self.timeout_s = timeout_s
        # written by the dispatch thread (receive_message) AND the watchdog
        # thread (_watch's rate-limit reset) — both sides go through
        # _rx_lock so an idle-age read can never interleave with a refresh
        # (the fedlint lock-discipline rule pins this)
        self._rx_lock = threading.Lock()
        self._last_rx = time.monotonic()
        self._finished = threading.Event()
        self.register_message_receive_handlers()

    # ------------------------------------------------------------- handlers
    def register_message_receive_handlers(self) -> None:
        """Subclasses register their per-msg_type handlers here."""

    def register_message_receive_handler(self, msg_type: str, handler: Callable) -> None:
        self._handlers[msg_type] = handler

    def receive_message(self, msg_type: str, msg_params) -> None:
        with self._rx_lock:
            self._last_rx = time.monotonic()
        handler = self._handlers.get(msg_type)
        if handler is None:
            log.warning("rank %d: no handler for msg_type=%s", self.rank, msg_type)
            return
        handler(msg_params)

    def on_timeout(self, idle_s: float) -> None:
        """Failure-detection hook: no inbound traffic for timeout_s."""
        log.error("rank %d: no message for %.1fs — peer failure suspected", self.rank, idle_s)

    # ------------------------------------------------------------------ run
    def run(self) -> None:
        watchdog = None
        if self.timeout_s is not None:
            watchdog = threading.Thread(target=self._watch, daemon=True)
            watchdog.start()
        self.com_manager.handle_receive_message()
        self._finished.set()

    def _watch(self) -> None:
        while not self._finished.is_set():
            time.sleep(min(self.timeout_s / 4, 1.0))
            # periodic liveness refresh: heartbeat-age gauges keep growing
            # while the link is silent — exactly when the watchdog watches
            _obs.refresh_liveness()
            with self._rx_lock:
                idle = time.monotonic() - self._last_rx
                if idle > self.timeout_s:
                    self._last_rx = time.monotonic()  # rate-limit the callback
                else:
                    idle = None
            if idle is not None:  # callback outside the lock: a handler
                self.on_timeout(idle)  # calling receive_message must
                # not deadlock against its own watchdog

    def send_message(self, message: Message) -> None:
        self.com_manager.send_message(message)

    def finish(self) -> None:
        self._finished.set()
        self.com_manager.stop_receive_message()


class ClientManager(DistributedManager):
    """Base class for client-side round participants
    (≈ fedml_core/distributed/client/client_manager.py)."""


class ServerManager(DistributedManager):
    """Base class for the server-side coordinator
    (≈ fedml_core/distributed/server/server_manager.py)."""
