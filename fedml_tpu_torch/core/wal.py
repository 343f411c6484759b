"""Durable round write-ahead log — the server's crash-recovery journal.

Every robustness layer before this one hardens the fleet against *client*
failure; rank 0 stayed a single point of failure — a mid-round server death
lost the async buffer, the quarantine ledger deltas, and (worst) could
under-report the privacy ε the budget ledger promises to account exactly.
This module is the durability half of the fix (docs/ROBUSTNESS.md §Server
crash recovery): an append-only, CRC-framed, fsync-at-commit log of round
lifecycle events, so recovery = latest checkpoint + WAL replay reconstructs
the in-flight state with exactly-once round semantics:

- **no round folded twice** — the newest RESTORABLE checkpoint is the
  state authority (a round's fold is durable iff its checkpoint is);
  recovery resumes one past it and re-runs the open round under a fresh
  ``restart_epoch``, whose echo on every upload sheds the pre-crash
  duplicates. The ``commit`` record (fsync'd after the checkpoint rename)
  witnesses the commit and bounds ``since_last_commit`` — the in-flight
  set recovery must ledger;
- **no upload double-counted** — uploads accepted for the open round are
  journaled at accept; recovery ledgers each as ``server_restart`` (the
  payloads died with the process) and the epoch gate drops their late
  wire twins;
- **ε never under-reported** — the DP pre-charge record is fsync'd
  *before* the noise key is drawn, so a crash between charge and noise
  replays the charge (the conservative direction: the accountant may
  over-count by one round, never under-count). The same record carries
  the round's surviving client ids (``clients=[...]``), extending the
  contract to CLIENT granularity: the per-client privacy ledgers
  (core/privacy.ClientPrivacyLedger) ride no checkpoint — recovery
  rebuilds them by replaying every pre-charge record, so per-user ε
  survives a SIGKILL under the same never-under-report guarantee;

Record framing: the file opens with an 8-byte magic, then each record is
``[u32 length][u32 crc32(payload)][payload]`` with a canonical-JSON
payload. Replay stops at the first torn/corrupt frame (counted — a crash
mid-append must cost the tail, never a misparse) and everything before it
is intact by CRC.

The durable-write helpers at the bottom are the ONLY sanctioned way this
module, ``core/checkpoint.py``, and ``core/privacy.py`` open files for
writing — the fedlint ``fsync-discipline`` rule flags any bare
``open(..., 'w')`` in those modules, because a commit point that skips
the fsync turns "crash-safe" into "crash-safe until the page cache says
otherwise".
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field

log = logging.getLogger("fedml_tpu_torch.core.wal")

_MAGIC = b"FWAL0001"
_HDR = struct.Struct("<II")  # payload length, crc32(payload)

# one segment per directory: recovery replays are O(run length) scans of
# small JSON records — a soak's few thousand rounds is kilobytes, and a
# single append-only file keeps the torn-tail contract trivially true
_SEGMENT = "wal.log"


# ---------------------------------------------------------------- durability
def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY: the rename that publishes an atomic write is
    itself only durable once the directory entry is flushed."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms/filesystems without dir-fd semantics
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@contextlib.contextmanager
def durable_open(path: str, mode: str = "wb"):
    """Open-for-write that flushes + fsyncs before close — the shared
    fsync helper every WAL/checkpoint commit point must route through
    (fedlint ``fsync-discipline``)."""
    f = open(path, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
    finally:
        f.close()


def durable_replace(tmp: str, path: str) -> None:
    """Atomic publish: rename tmp over path, then fsync the directory so
    the rename survives power loss."""
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def durable_write(path: str, data: bytes) -> None:
    """tmp-file → fsync → atomic rename: a reader (or a post-crash
    recovery) sees either the old content or the complete new content,
    never a torn file under the real name."""
    tmp = path + ".tmp"
    try:
        with durable_open(tmp, "wb") as f:
            f.write(data)
        durable_replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


# -------------------------------------------------------------------- replay
@dataclass
class WalReplay:
    """Parsed view of a WAL directory — what recovery reasons over."""

    records: list[dict] = field(default_factory=list)
    torn: int = 0  # torn/corrupt tail frames dropped (0 or 1 per scan)

    @property
    def restart_epochs(self) -> int:
        """Prior server boots = the next boot's restart epoch (0 on a
        fresh directory)."""
        return sum(1 for r in self.records if r.get("kind") == "restart")

    @property
    def last_commit(self) -> int:
        """Highest committed round, -1 when none committed yet."""
        return max((int(r["round"]) for r in self.records
                    if r.get("kind") == "commit"), default=-1)

    def open_round(self, committed: int) -> int | None:
        """The in-flight round a crash interrupted: the highest
        ``broadcast`` round past ``committed`` (None = the crash fell
        between commits — nothing was in flight)."""
        r = max((int(r["round"]) for r in self.records
                 if r.get("kind") == "broadcast"), default=-1)
        return r if r > committed else None

    def for_round(self, round_idx: int, kind: str | None = None
                  ) -> list[dict]:
        return [r for r in self.records
                if int(r.get("round", -1)) == int(round_idx)
                and (kind is None or r.get("kind") == kind)]

    def of_kind(self, kind: str) -> list[dict]:
        return [r for r in self.records if r.get("kind") == kind]

    def since_last_commit(self, kinds=None) -> list[dict]:
        """Records appended after the last ``commit`` — the in-flight
        state a crash destroyed. Positional, not round-filtered: across a
        double crash in one round, each boot's lost work accumulates here
        until a commit finally lands (exactly the set recovery must
        ledger ``server_restart``)."""
        if isinstance(kinds, str):
            kinds = (kinds,)
        idx = -1
        for i, r in enumerate(self.records):
            if r.get("kind") == "commit":
                idx = i
        return [r for r in self.records[idx + 1:]
                if kinds is None or r.get("kind") in kinds]

    def dispatch_waves(self) -> dict[int, int]:
        """rank -> highest journaled async dispatch wave (recovery resumes
        each rank's wave counter past it, keeping the sampling chain
        monotonic across restarts)."""
        waves: dict[int, int] = {}
        for r in self.records:
            if r.get("kind") == "dispatch":
                rank = int(r["rank"])
                waves[rank] = max(waves.get(rank, -1), int(r["wave"]))
        return waves


class RoundWAL:
    """Append-only round journal. ``append(..., sync=True)`` is the commit
    discipline: buffered appends ride the OS cache (cheap, lost on crash
    = lost bookkeeping only), sync'd appends are durable before the call
    returns (anything correctness-critical: broadcast, upload accept,
    privacy pre-charge, commit, restart)."""

    def __init__(self, wal_dir: str):
        os.makedirs(wal_dir, exist_ok=True)
        self.wal_dir = wal_dir
        self.path = os.path.join(wal_dir, _SEGMENT)
        self._lock = threading.Lock()
        fresh = not os.path.exists(self.path) \
            or os.path.getsize(self.path) == 0
        if not fresh:
            # repair BEFORE appending: a torn tail (crash mid-append) must
            # be truncated away, or this boot's records land after bytes
            # every future replay stops at — invisible forever (restart
            # epochs undercount, commits vanish, lost uploads unledgered)
            fresh = self._durable_truncate_tail()
        self._f = self._durable_append_handle()
        if fresh:
            with self._lock:
                self._f.write(_MAGIC)
                self._f.flush()
                os.fsync(self._f.fileno())
            fsync_dir(wal_dir)

    def _durable_truncate_tail(self) -> bool:
        """Scan the existing segment and truncate past the last intact
        frame. Returns True when the file is unusable (bad magic — set
        aside, start fresh) so __init__ rewrites the header."""
        with open(self.path, "rb") as f:
            data = f.read()
        if data[:len(_MAGIC)] != _MAGIC:
            corrupt = self.path + ".corrupt"
            os.replace(self.path, corrupt)
            fsync_dir(self.wal_dir)
            log.warning("WAL at %s has a bad magic — set aside as %s, "
                        "starting a fresh segment", self.path, corrupt)
            return True
        off = len(_MAGIC)
        while off < len(data):
            if off + _HDR.size > len(data):
                break
            length, crc = _HDR.unpack_from(data, off)
            start, end = off + _HDR.size, off + _HDR.size + length
            if end > len(data) or zlib.crc32(data[start:end]) != crc:
                break
            off = end
        if off < len(data):
            with open(self.path, "r+b") as f:
                f.truncate(off)
                f.flush()
                os.fsync(f.fileno())
            log.warning("WAL at %s: truncated a torn tail at offset %d "
                        "so this boot's records stay replayable", self.path,
                        off)
        return False

    def _durable_append_handle(self):
        # the long-lived append handle: every sync'd append fsyncs it, so
        # the handle itself needs no close-time flush ceremony
        return open(self.path, "ab")

    # --------------------------------------------------------------- append
    def append(self, kind: str, sync: bool = False, **fields) -> None:
        rec = dict(fields)
        rec["kind"] = str(kind)
        # wall-clock stamp: the post-mortem timeline (obs/flightrec.py)
        # orders WAL records against flight-record dumps by it. setdefault
        # so a caller (or a replay-driven rewrite) can pin its own.
        rec.setdefault("ts", round(time.time(), 6))  # fedlint: disable=determinism — wall-clock stamp for the post-mortem timeline only; replay ignores it and a replay-driven rewrite pins its own
        payload = json.dumps(rec, sort_keys=True).encode()
        frame = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            if self._f.closed:
                return  # a post-close append is bookkeeping from teardown
            self._f.write(frame)
            if sync:
                self._f.flush()
                os.fsync(self._f.fileno())

    def commit(self, round_idx: int) -> None:
        """The round-commit record — fsync'd AFTER the checkpoint rename
        (the checkpoint is the state authority; the commit record makes
        the round's completion explicit even when checkpoint pruning or a
        save cadence skips the round)."""
        self.append("commit", sync=True, round=int(round_idx))

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()

    # --------------------------------------------------------------- replay
    @classmethod
    def replay(cls, wal_dir: str) -> WalReplay:
        """Scan the directory's WAL into a :class:`WalReplay`. Robust to a
        torn tail (counted, suffix dropped) and to a missing/short file
        (empty replay) — recovery must never crash on the artifact a
        crash produced."""
        out = WalReplay()
        path = os.path.join(wal_dir, _SEGMENT)
        if not os.path.exists(path):
            return out
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < len(_MAGIC) or data[:len(_MAGIC)] != _MAGIC:
            if data:
                out.torn = 1
                log.warning("WAL at %s has a bad/short magic (%d bytes) — "
                            "treating as empty", path, len(data))
            return out
        off = len(_MAGIC)
        while off < len(data):
            if off + _HDR.size > len(data):
                out.torn = 1
                break
            length, crc = _HDR.unpack_from(data, off)
            start, end = off + _HDR.size, off + _HDR.size + length
            if end > len(data) or zlib.crc32(data[start:end]) != crc:
                out.torn = 1
                log.warning("WAL at %s: torn/corrupt frame at offset %d — "
                            "dropping the tail (%d intact records kept)",
                            path, off, len(out.records))
                break
            try:
                out.records.append(json.loads(data[start:end]))
            except ValueError:
                out.torn = 1
                break
            off = end
        return out
