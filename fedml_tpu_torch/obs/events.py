"""Structured event log — JSONL run records with pluggable sinks.

One run = one stream of JSON objects, one per line:

    {"ts": ..., "kind": "run",   "run": "...", "config": {...}}
    {"ts": ..., "kind": "round", "run": "...", "round": 3,
     "clients": [7, 12, ...], "spans": {"pack": ..., "round": ...},
     "metrics": {"loss_sum": ..., "update_norm": ...},
     "comm": {"messages_sent": ..., "bytes_sent": ...}}
    {"ts": ..., "kind": "eval",  "run": "...", "round": 3,
     "eval": {"test_acc": ..., "test_loss": ...}}

The schema is documented in docs/OBSERVABILITY.md and consumed by
scripts/report.py. Sinks: ``JsonlSink`` (size-rotated file — a long run
cannot fill the disk) and ``MemorySink`` (tests read ``.records``).
"""

from __future__ import annotations

import json
import os
import threading
import time


class MemorySink:
    """In-memory sink — tests and short-lived tools read ``records``.

    Locked like ``JsonlSink``: the HealthMonitor's background thread
    (obs/health.py) emits alert records concurrently with the engine
    thread's round emits, and an unsynchronized list.append can drop a
    record mid-resize on some interpreters — same discipline, both
    sinks."""

    def __init__(self):
        self.records: list[dict] = []
        self._lock = threading.Lock()

    def write(self, rec: dict) -> None:
        with self._lock:
            self.records.append(rec)

    def close(self) -> None:
        with self._lock:
            pass  # nothing to flush; the lock keeps close/write ordered


class JsonlSink:
    """Append-only JSONL file with size-based rotation: when the active file
    would exceed ``max_bytes`` the stack shifts (events.jsonl ->
    events.jsonl.1 -> ... -> .{backups}, oldest dropped) and a fresh file
    opens. Rotation is per-record, so a single record is never split."""

    def __init__(self, path: str, max_bytes: int = 64 << 20, backups: int = 3):
        self.path = path
        self.max_bytes = max_bytes
        self.backups = backups
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        self._size = self._f.tell()

    def _rotate(self) -> None:
        self._f.close()
        for i in range(self.backups - 1, 0, -1):
            src, dst = f"{self.path}.{i}", f"{self.path}.{i + 1}"
            if os.path.exists(src):
                os.replace(src, dst)
        if self.backups > 0:
            os.replace(self.path, f"{self.path}.1")
        else:
            os.remove(self.path)
        self._f = open(self.path, "a")
        self._size = 0

    def write(self, rec: dict) -> None:
        line = json.dumps(rec, default=float) + "\n"
        with self._lock:
            if self._size and self._size + len(line) > self.max_bytes:
                self._rotate()
            self._f.write(line)
            self._f.flush()
            self._size += len(line)

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class EventLog:
    """Emit structured records into a sink. Every record carries ``ts``
    (wall clock), ``kind``, and the run id. Observers (``add_observer``)
    see every emitted record after the sink write — the flight recorder
    (obs/flightrec.py) tees records into its crash ring this way; an
    observer exception is logged-and-swallowed (telemetry fan-out must
    never kill the emitting engine)."""

    def __init__(self, sink, run_id: str | None = None, clock=time.time):
        self.sink = sink
        self.run_id = run_id or time.strftime("run_%Y%m%d_%H%M%S")
        self._clock = clock
        self._observers: list = []

    def add_observer(self, fn) -> None:
        self._observers.append(fn)

    def emit(self, kind: str, **fields) -> dict:
        rec = {"ts": self._clock(), "kind": kind, "run": self.run_id}
        rec.update(fields)
        self.sink.write(rec)
        for fn in self._observers:
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 — see class docstring
                import logging

                logging.getLogger("fedml_tpu_torch.obs.events").exception(
                    "event observer failed on %r", kind)
        return rec

    def close(self) -> None:
        self.sink.close()


def read_jsonl(path: str, kinds: tuple[str, ...] | None = None,
               backups: bool = True) -> list[dict]:
    """Load a JSONL event file. ``backups=True`` (the default) folds the
    rotated stack back in first (``.N`` ... ``.1``, oldest to newest, then
    the active file) so a run that rotated mid-flight comes back in
    emission order with its oldest retained rounds intact — report.py and
    ``bench_blob`` would otherwise silently lose them. ``backups=False``
    reads the active file alone (tail-only tools). Unparseable lines are
    skipped — a run killed mid-write must not make its whole log
    unreadable."""
    paths = []
    if backups:
        i = 1
        while os.path.exists(f"{path}.{i}"):
            paths.append(f"{path}.{i}")
            i += 1
        paths.reverse()  # .N is oldest
    if os.path.exists(path):
        paths.append(path)
    out = []
    for p in paths:
        with open(p, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if kinds is None or rec.get("kind") in kinds:
                    out.append(rec)
    return out
