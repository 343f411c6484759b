"""Host-side round pipelining, port of fedml_tpu/core/pipeline.py:
``Prefetcher`` (the packer thread that prepares round r+1 while round r
runs), ``InflightRing`` (dispatched round outputs drained ``lag`` rounds
behind) and ``AsyncSender`` (the FIFO uplink worker the cross-process
client sends through), each a copy of the reference's class.

The reference's fourth primitive, ``compile_concurrently``, compiles XLA
programs on a thread pool. Eager PyTorch compiles no program, so it has no
counterpart here: the engine's ``warmup`` runs each bucket depth's fit
once instead (algorithms/fedavg.py).

Safety invariants the primitives rely on (and the engine upholds):

- *Determinism*: packing round r is a pure function of (seed, round,
  sampled ids), so prefetch on/off is bitwise identical.
- *Buffer safety*: packers allocate fresh host buffers every round, and
  on a CUDA device the copy runs on the packer's own stream from pinned
  buffers that live until the copy's event has completed.
- *Thread ownership*: the producer thread only packs and places; all
  engine-state mutation (key chain, net, ledger, telemetry) stays on the
  driver thread. Drains run inline in ``push``/``drain_all``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

from fedml_tpu_torch.obs import perf_instrument as _perf

log = logging.getLogger("fedml_tpu_torch.pipeline")


class Prefetcher:
    """Background producer over a deterministic key schedule.

    ``produce(key)`` runs on the packer thread for each key in order;
    results are handed to :meth:`get` through a ring buffer bounded at
    ``depth`` items (double-buffering = depth 2: one batch in flight on
    device, one staged, one being packed).

    ``get`` must be called with the same keys in the same order — the
    pipeline is a FIFO, not a cache. A producer exception is re-raised by
    the next ``get`` (never swallowed into a hang). ``on_event`` (tests/
    instrumentation) observes ``("produced", key)`` on the packer thread
    and ``("got", key)`` on the consumer thread.
    """

    def __init__(self, produce: Callable[[Any], Any], keys: Iterable[Any],
                 depth: int = 2, on_event: Callable | None = None,
                 name: str = "fedml-prefetch"):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._produce = produce
        self._keys = list(keys)
        self._q: "queue.Queue[tuple[Any, Any]]" = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._on_event = on_event
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for key in self._keys:
                if self._stop.is_set():
                    return
                item = self._produce(key)
                if self._on_event is not None:
                    self._on_event("produced", key)
                while not self._stop.is_set():
                    try:
                        self._q.put((key, item), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — surfaced via get()
            self._err = e
            log.exception("prefetch producer died")

    def get(self, key: Any) -> tuple[Any, float]:
        """Next produced item (must match ``key``) plus the seconds this
        call stalled waiting for it — observed into
        ``fed_prefetch_stall_seconds``."""
        t0 = time.perf_counter()
        while True:
            if self._err is not None and self._q.empty():
                raise RuntimeError(
                    f"prefetch producer failed before key {key!r}"
                ) from self._err
            try:
                k, item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty() \
                        and self._err is None:
                    raise RuntimeError(
                        f"prefetch schedule exhausted before key {key!r}")
                continue
        stall = time.perf_counter() - t0
        _perf.record_prefetch_stall(stall)
        if k != key:
            raise RuntimeError(
                f"prefetch out of order: wanted {key!r}, got {k!r}")
        if self._on_event is not None:
            self._on_event("got", key)
        return item, stall

    def close(self) -> None:
        """Stop the producer and reclaim the thread (idempotent). Items
        still in the ring are discarded — close only after the last get."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)


class InflightRing:
    """Ring of dispatched-but-undrained round outputs.

    ``push(key, entry)`` appends and drains (via ``drain_fn(key, entry)``,
    inline on the caller's thread, in submission order) everything deeper
    than ``lag``; returns the drained results. ``drain_all`` flushes the
    rest (end of run, or an eval round that needs its own metrics). The
    ring length after each push feeds the ``fed_dispatch_depth`` gauge.
    """

    def __init__(self, lag: int, drain_fn: Callable[[Any, Any], Any],
                 on_event: Callable | None = None):
        if lag < 0:
            raise ValueError(f"drain lag must be >= 0, got {lag}")
        self._lag = lag
        self._drain = drain_fn
        self._on_event = on_event
        self._ring: deque = deque()

    def __len__(self) -> int:
        return len(self._ring)

    def _pop(self):
        key, entry = self._ring.popleft()
        out = self._drain(key, entry)
        if self._on_event is not None:
            self._on_event("drained", key)
        return out

    def push(self, key: Any, entry: Any) -> list:
        self._ring.append((key, entry))
        _perf.set_dispatch_depth(len(self._ring))
        out = []
        while len(self._ring) > self._lag:
            out.append(self._pop())
        return out

    def drain_all(self) -> list:
        out = []
        while self._ring:
            out.append(self._pop())
        _perf.set_dispatch_depth(0)
        return out


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
