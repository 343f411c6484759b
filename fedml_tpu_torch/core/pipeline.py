"""Host-side round pipelining, port of fedml_tpu/core/pipeline.py. This
slice carries ``AsyncSender``, the FIFO uplink worker the cross-process
client sends through (a copy of the reference's class); ``Prefetcher`` and
``InflightRing`` are queued in ROADMAP.md (queue A, item 7)."""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable

log = logging.getLogger("fedml_tpu_torch.pipeline")


class AsyncSender:
    """FIFO sender worker — encode+transmit off the caller's thread.

    One daemon thread drains a queue of messages through ``send``; order is
    preserved (the chaos layer's per-link sequence numbers, the gRPC seq
    stream, and the server's round tags all assume FIFO per sender). A send
    failure is logged with traceback, stops the worker (remaining queued
    messages are dropped — the peer's elastic round deadline handles the
    gap), fires ``on_error`` on the worker thread, and re-raises from the
    next ``submit``/``close`` so the owning manager dies visibly instead of
    hanging silently — the same contract as ``BaseCommManager._notify``.
    ``on_error`` matters for owners that may never call submit/close again
    (a client blocked waiting for a broadcast its failed upload forfeited):
    it is their hook to shut down instead of hanging.
    """

    _STOP = object()

    def __init__(self, send: Callable[[Any], None], name: str = "fedml-sender",
                 on_error: Callable[[BaseException], None] | None = None):
        self._send = send
        self._on_error = on_error
        self._q: queue.Queue = queue.Queue()
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            msg = self._q.get()
            if msg is self._STOP:
                return
            try:
                self._send(msg)
            except BaseException as e:  # noqa: BLE001 — surfaced on submit
                self._err = e
                log.exception("async sender: send failed; worker stopping")
                if self._on_error is not None:
                    try:
                        self._on_error(e)
                    except BaseException:  # noqa: BLE001 — teardown hook
                        log.exception("async sender: on_error hook raised")
                return

    def submit(self, msg: Any) -> None:
        if self._err is not None:
            raise RuntimeError("async sender worker died") from self._err
        self._q.put(msg)

    def close(self, timeout: float = 60.0) -> None:
        """Flush queued sends and stop the worker. Raises if the worker
        died on an earlier send OR failed to flush within ``timeout`` —
        a wedged transport must not read as a clean exit."""
        self._q.put(self._STOP)
        if threading.current_thread() is not self._thread:
            # (an on_error hook may close() from the worker itself — a
            # thread cannot join itself, and the error is already set)
            self._thread.join(timeout)
            if self._err is None and self._thread.is_alive():
                raise RuntimeError(
                    f"async sender did not flush within {timeout}s "
                    "(transport wedged mid-send?)")
        if self._err is not None:
            raise RuntimeError("async sender worker died") from self._err
