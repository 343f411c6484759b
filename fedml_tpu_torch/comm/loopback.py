"""In-process loopback transport — ranks are threads, links are queues.

The reference has no mock transport; its "fake cluster" is mpirun with all
ranks on localhost (SURVEY.md §4.5). On TPU CI we want the same multi-party
semantics without processes, so this backend routes Message frames through a
process-local registry keyed by (job_id, rank). Frames still round-trip
through to_bytes()/from_bytes(), so loopback exercises the exact wire path
the gRPC backend uses — a loopback test is a serialization test.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

from fedml_tpu_torch.comm.base import BaseCommManager
from fedml_tpu_torch.comm.message import Message

_registry: dict = defaultdict(dict)  # job_id -> {rank: LoopbackCommManager}
_registry_lock = threading.Lock()


class LoopbackCommManager(BaseCommManager):
    backend_name = "loopback"

    # an uplink to an unregistered RANK 0 retries inside this window
    # before failing — the loopback analogue of the gRPC backend's
    # backoff on UNAVAILABLE (docs/ROBUSTNESS.md §Server crash recovery:
    # a client must SURVIVE the server's restart outage, not die on the
    # first refused frame; a supervised in-process restart re-registers
    # rank 0 within milliseconds). Sends to any OTHER unregistered rank
    # fail immediately — the server's elastic machinery owns dead
    # clients, and a retry there would only stall teardown. Either way
    # the failure is a ConnectionError — a transport error the elastic
    # paths tolerate — never an opaque RuntimeError that kills the rank.
    RETRY_WINDOW_S = 3.0
    _RETRY_TICK_S = 0.02

    def __init__(self, job_id: str, rank: int, size: int):
        super().__init__()
        self.job_id, self.rank, self.size = job_id, rank, size
        with _registry_lock:
            _registry[job_id][rank] = self

    def _peer(self, dest: int):
        with _registry_lock:
            return _registry[self.job_id].get(dest)

    def send_message(self, msg: Message) -> None:
        frame = self._encode(msg)  # force the real wire path (and count it)
        dest = int(msg.get_receiver_id())
        peer = self._peer(dest)
        if peer is None and dest == 0:
            deadline = time.monotonic() + self.RETRY_WINDOW_S
            while peer is None and time.monotonic() < deadline:
                time.sleep(self._RETRY_TICK_S)
                peer = self._peer(dest)
        if peer is None:
            raise ConnectionError(
                f"loopback: rank {dest} not registered in job "
                f"{self.job_id}")
        peer._receive_frame(frame)

    def stop_receive_message(self) -> None:
        super().stop_receive_message()
        with _registry_lock:
            _registry[self.job_id].pop(self.rank, None)
            if not _registry[self.job_id]:
                _registry.pop(self.job_id, None)
