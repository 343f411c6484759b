"""Crash flight recorder — the black box that survives a supervised death.

The WAL (core/wal.py) journals the server's round lifecycle durably, but
everything else a crash investigation needs — the last alerts, the spans
in flight, which digests had arrived, the final metric values — lives in
process memory and dies with a SIGKILL. This module is the bounded black
box: every process keeps a ring of recent flight records (events, spans,
alerts, digest arrivals, metric snapshots) and dumps it through the WAL's
``durable_*`` helpers at the moments that matter:

- **alert-fire** — the EventLog observer hook tees every emitted record
  into the ring and triggers a dump when an ``alert`` record fires, so
  the box holds the run's state at the first sign of trouble;
- **SIGTERM** — ``install_sigterm_dump()`` chains the previous handler
  behind a dump (the supervised shutdown path);
- **simulated / real crash** — the server's ``_maybe_crash`` dumps just
  before raising; ``Telemetry.close()`` dumps on clean teardown.

A SIGKILL cannot be intercepted: what survives it is the last dump (the
most recent alert-fire/round tick), plus the WAL — which is exactly why
dumps are cheap (one ``durable_write`` of a bounded JSON blob, atomic
latest-wins per rank at ``<dir>/rank<N>.json``) and frequent.

``render_post_mortem`` stitches WAL records, the flight dumps from every
rank, and the event log's alerts into ONE time-ordered crash timeline —
what every rank was doing in the seconds before rank 0 died, which
uploads were in flight, what ε was charged (``scripts/report.py
--post-mortem``).

The recorder is a process-wide optional singleton (mirroring
``metrics.REGISTRY``): ``install_flight_recorder()`` arms it,
``flight_record(kind, **fields)`` is a cheap no-op until then — hot paths
(digest emit, upload ingest) call it unconditionally.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from collections import deque

from fedml_tpu_torch.core.wal import RoundWAL, durable_write
from fedml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("fedml_tpu_torch.obs.flightrec")

# ring capacity: enough for the last few rounds of a busy fleet (digests,
# alerts, WAL echoes) while keeping a dump at a few hundred KB worst-case
DEFAULT_CAPACITY = 512


class FlightRecorder:
    """One process's bounded flight ring. Thread-safe: the comm dispatch
    loop, the health checker, and the engine thread all record."""

    def __init__(self, rank: int = 0, run_id: str | None = None,
                 out_dir: str | None = None,
                 capacity: int = DEFAULT_CAPACITY,
                 registry: MetricsRegistry | None = None,
                 clock=time.time):
        self.rank = int(rank)
        self.run_id = run_id
        self.out_dir = out_dir
        self.registry = registry or REGISTRY
        self._clock = clock
        self._ring: deque[dict] = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._dumps = 0

    # -------------------------------------------------------------- recording
    def record(self, kind: str, **fields) -> None:
        rec = {"ts": self._clock(), "kind": str(kind)}
        rec.update(fields)
        rec.setdefault("rank", self.rank)
        with self._lock:
            self._ring.append(rec)

    def on_event(self, rec: dict) -> None:
        """EventLog observer: tee the emitted record into the ring and
        dump on an alert transition (the box must hold the state that
        *preceded* the alert, so the tee happens first)."""
        with self._lock:
            self._ring.append(dict(rec))
        if rec.get("kind") == "alert":
            self.dump("alert")

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    # ------------------------------------------------------------------ dump
    def dump(self, reason: str) -> str | None:
        """Durably write the box: ring + a compact scalar snapshot of the
        registry (counters/gauges only — histograms ride as summaries in
        the records that sampled them). Atomic latest-wins per rank; a
        failed dump logs and returns None (the recorder must never crash
        the crashing process harder)."""
        if not self.out_dir:
            return None
        path = os.path.join(self.out_dir, f"rank{self.rank}.json")
        with self._lock:
            self._dumps += 1
            blob = {
                "kind": "flight_dump",
                "ts": self._clock(),
                "rank": self.rank,
                "run": self.run_id,
                "reason": str(reason),
                "dumps": self._dumps,
                "ring": list(self._ring),
                "counters": self._scalar_snapshot(),
            }
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            durable_write(path, (json.dumps(blob, default=float) +
                                 "\n").encode())
        except OSError:
            log.exception("flight-record dump to %s failed", path)
            return None
        log.info("flight recorder: dumped %d records to %s (%s)",
                 len(blob["ring"]), path, reason)
        return path

    def _scalar_snapshot(self) -> dict:
        """Caller holds the lock. Counter/gauge families only, flattened
        to {name{labels}: value} — the registry state at dump time."""
        out: dict = {}
        for name, fam in self.registry.snapshot().items():
            for label_s, v in fam.items():
                if isinstance(v, (int, float)):
                    key = f"{name}{{{label_s}}}" if label_s else name
                    out[key] = v
        return out


# ------------------------------------------------------- process-wide singleton
_lock = threading.Lock()
_RECORDER: FlightRecorder | None = None


def install_flight_recorder(rank: int = 0, run_id: str | None = None,
                            out_dir: str | None = None,
                            capacity: int = DEFAULT_CAPACITY,
                            registry: MetricsRegistry | None = None,
                            clock=time.time) -> FlightRecorder:
    """Arm this process's flight recorder (idempotent: re-installing
    replaces it — the newest run's identity wins, matching how loopback
    simulations reuse one process across jobs)."""
    global _RECORDER
    with _lock:
        _RECORDER = FlightRecorder(rank=rank, run_id=run_id, out_dir=out_dir,
                                   capacity=capacity, registry=registry,
                                   clock=clock)
        return _RECORDER


def uninstall_flight_recorder() -> None:
    """Disarm (tests: one test's ring must not leak into the next)."""
    global _RECORDER
    with _lock:
        _RECORDER = None


def active_recorder() -> FlightRecorder | None:
    return _RECORDER


def flight_record(kind: str, **fields) -> None:
    """Record into the installed ring; a no-op (one global read) when no
    recorder is armed — hot paths call this unconditionally."""
    rec = _RECORDER
    if rec is not None:
        rec.record(kind, **fields)


def on_event(rec: dict) -> None:
    """The EventLog observer Telemetry attaches unconditionally — routes
    to the installed recorder, no-op otherwise (install order must not
    matter: a launcher may arm the recorder after Telemetry exists)."""
    r = _RECORDER
    if r is not None:
        r.on_event(rec)


def dump_active(reason: str) -> str | None:
    r = _RECORDER
    return r.dump(reason) if r is not None else None


def install_sigterm_dump() -> None:
    """Chain a flight dump in front of the existing SIGTERM disposition —
    the supervised-shutdown path. Launcher-only (libraries must not steal
    signal handlers); a non-main thread / exotic platform degrades to a
    no-op."""
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            dump_active("sigterm")
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _handler)
    except (ValueError, OSError):  # not the main thread / no signals here
        log.debug("SIGTERM flight-dump hook unavailable", exc_info=True)


# --------------------------------------------------------------- post-mortem
def read_flight_dumps(flight_dir: str) -> list[dict]:
    """Load every rank's dump from a flight directory (missing dir or a
    torn file → skipped; a crash artifact must never crash its reader)."""
    out: list[dict] = []
    if not flight_dir or not os.path.isdir(flight_dir):
        return out
    for name in sorted(os.listdir(flight_dir)):
        if not (name.startswith("rank") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(flight_dir, name), errors="replace") as f:
                blob = json.loads(f.read())
        except (OSError, ValueError):
            continue
        if isinstance(blob, dict):
            out.append(blob)
    return out


def _fmt_ts(ts, t0: float | None) -> str:
    if not isinstance(ts, (int, float)):
        return "        ?"
    if t0 is not None:
        return f"{ts - t0:+9.3f}s"
    return time.strftime("%H:%M:%S", time.localtime(ts))


def _fields_str(rec: dict, skip=("ts", "kind", "run")) -> str:
    parts = []
    for k, v in rec.items():
        if k in skip or v is None:
            continue
        if isinstance(v, float):
            v = f"{v:.4g}"
        elif isinstance(v, (dict, list)):
            v = json.dumps(v, default=float)
            if len(v) > 60:
                v = v[:57] + "..."
        parts.append(f"{k}={v}")
    return " ".join(parts)


def render_post_mortem(wal_dir: str | None = None,
                       flight_dir: str | None = None,
                       events: list[dict] | None = None,
                       window_s: float = 30.0) -> str:
    """Stitch WAL records + per-rank flight dumps + event-log alerts into
    one time-ordered crash timeline. The anchor is the newest ``restart``
    WAL record (the post-crash boot); everything inside ``window_s``
    before it is the pre-crash window the investigation reads first.
    Pre-PR inputs (a WAL whose records carry no ``ts``, no flight dir)
    degrade to a notice — same contract as report.py's columns."""
    entries: list[tuple[float, str, str]] = []  # (ts, source, line)
    undated = 0

    replay = RoundWAL.replay(wal_dir) if wal_dir else None
    restarts: list[dict] = []
    if replay is not None:
        for r in replay.records:
            ts = r.get("ts")
            kind = r.get("kind", "?")
            body = _fields_str(r, skip=("ts", "kind"))
            if kind == "restart":
                restarts.append(r)
                body = ">>> " + ("restart " + body).strip()
            else:
                body = f"{kind} {body}".strip()
            if isinstance(ts, (int, float)):
                entries.append((float(ts), "wal", body))
            else:
                undated += 1

    dumps = read_flight_dumps(flight_dir) if flight_dir else []
    for d in dumps:
        src = f"flight:{d.get('rank', '?')}"
        ts = d.get("ts")
        if isinstance(ts, (int, float)):
            entries.append((float(ts), src,
                            f"--- dump ({d.get('reason', '?')}, "
                            f"{len(d.get('ring', []))} records)"))
        for rec in d.get("ring", []):
            rts = rec.get("ts")
            if not isinstance(rts, (int, float)):
                undated += 1
                continue
            line = f"{rec.get('kind', '?')} " + _fields_str(rec)
            entries.append((float(rts), src, line.strip()))

    for rec in events or []:
        if rec.get("kind") not in ("alert", "run"):
            continue
        ts = rec.get("ts")
        if isinstance(ts, (int, float)):
            entries.append((float(ts), "events",
                            f"{rec['kind']} " + _fields_str(rec)))

    if not entries:
        return ("(no post-mortem inputs — the WAL/flight dumps are absent "
                "or predate the flight recorder; run with the fleet plane "
                "armed to record them)")

    # de-duplicate: an alert teed into the ring AND in the event log would
    # otherwise print twice at the same instant
    seen: set[tuple] = set()
    entries = [e for e in sorted(entries)
               if not (e in seen or seen.add(e))]

    anchor = None
    for r in restarts:
        if isinstance(r.get("ts"), (int, float)):
            anchor = float(r["ts"])
    lines = [
        "post-mortem timeline",
        f"  wal: {len(replay.records) if replay else 0} records, "
        f"{len(restarts)} restart(s)"
        + (f", restart epoch {restarts[-1].get('epoch')}" if restarts
           and restarts[-1].get("epoch") is not None else ""),
        f"  flight dumps: {len(dumps)} "
        f"(ranks {sorted({d.get('rank') for d in dumps})})" if dumps
        else "  flight dumps: none found",
    ]
    if undated:
        lines.append(f"  ({undated} undated record(s) skipped — inputs "
                     "predate the timestamped WAL/flight format)")
    if anchor is not None:
        lines.append(f"  crash anchor: last restart at "
                     f"{time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(anchor))}"
                     f" — pre-crash window is the {window_s:.0f}s before it")
    lines.append("")
    for ts, src, body in entries:
        mark = " "
        if anchor is not None and 0.0 <= anchor - ts <= window_s:
            mark = "*"  # inside the pre-crash window
        lines.append(f"{_fmt_ts(ts, anchor)} {mark} {src:<9} {body}")
    return "\n".join(lines)
