"""ChaosCommManager — executes a FaultPlan around any BaseCommManager.

The wrapper intercepts the two choke points every transport shares:

- **send**: ``send_message`` applies message-level faults (drop, delay,
  duplicate, reorder, straggle, partition, crash) before delegating; a
  send-direction *corrupt* is applied to the encoded bytes by hooking the
  inner manager's ``_encode`` (so it works identically for loopback, gRPC,
  and MQTT — all of which route their outbound frames through it);
- **recv**: the inner manager's ``_receive_frame`` is replaced, so inbound
  raw frames can be dropped / delayed / duplicated / reordered / corrupted
  *before* decode — which is exactly where a corrupt frame must then be
  caught by the CRC32 integrity check and counted, not raised
  (``comm/base.py``).

Fault semantics (chosen to mirror the deployment failure each models):

- ``drop``       the frame vanishes (lossy link);
- ``delay``      the frame arrives ``delay_s`` later, off-thread (latency
                 spike — subsequent frames are NOT held back);
- ``duplicate``  the frame is delivered twice (at-least-once redelivery);
                 on gRPC the SAME stamped (rank, epoch, seq) wire frame is
                 re-sent, so the receiver's exactly-once dedup gate is what
                 must drop it; seq-less transports re-deliver the message;
- ``reorder``    the frame is held until the next frame on its link passes
                 it (out-of-order delivery; a 0.2 s backstop timer releases
                 a held frame with no successor so protocols can't wedge);
- ``corrupt``    one byte of the wire frame is flipped (bit rot / truncated
                 write) — the receiver must drop-and-count, not crash;
- ``partition``  ranks in different groups black-hole each other's frames
                 (netsplit: silent loss, like a firewalled TCP link);
- ``crash``      the rank goes dark: its sends vanish, its inbound drops,
                 and sends TO it raise ConnectionError (connection refused
                 by a dead process) — which is what drives the server's
                 elastic undeliverable-rank bookkeeping and the dead-rank
                 reprobe rejoin when the window ends ("restart");
- ``straggle``   a synchronous ``delay_s`` sleep in the sender's thread
                 (slow client compute/uplink) — the round watchdog's prey.

Composition on one frame: the first firing rule of each fault kind wins;
``drop`` suppresses every other fault (nothing was delivered, so nothing
else "happened"); ``reorder`` supersedes ``delay`` (the hold IS a delay);
``duplicate``/``corrupt`` compose with either. The ledger and the
``comm_faults_injected_total`` metric record exactly the faults APPLIED
under these rules — never a decision that was then suppressed. Every
decision is deterministic per (seed, rule, link, link-seq) — see
chaos/plan.py.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

from fedml_tpu_torch.chaos.plan import FaultPlan
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.obs import comm_instrument as _obs

log = logging.getLogger("fedml_tpu_torch.chaos")

# fedavg tags frames with "round_idx" (distributed/fedavg/message_define);
# other protocols use "round" — either marks the frame's protocol round
_ROUND_KEYS = ("round_idx", "round")

_REORDER_BACKSTOP_S = 0.2

_Firing = collections.namedtuple("_Firing", ["idx", "rule"])


def corrupt_bytes(frame: bytes, seed: int, seq: int) -> bytes:
    """Flip one deterministically-chosen byte of the frame, never in the
    first 8: the magic survives (so the CRC path, not the unknown-frame
    path, is exercised) and so does byte range 4:8 — which in a
    zlib-wrapped frame is the ADVISORY raw_len the decoder ignores; a flip
    there would be a counted-but-no-op corruption. From byte 8 on, every
    position is integrity-checked in both framings (FMT2: the CRC field
    itself or the CRC-covered body; FMZ1: the deflate stream)."""
    import hashlib

    if len(frame) <= 9:
        return bytes([frame[0] ^ 0xFF]) + frame[1:] if frame else frame
    h = hashlib.sha256(f"corrupt|{seed}|{seq}".encode()).digest()
    pos = 8 + int.from_bytes(h[:8], "little") % (len(frame) - 8)
    return frame[:pos] + bytes([frame[pos] ^ 0xFF]) + frame[pos + 1:]


class ChaosCommManager:
    """Duck-typed BaseCommManager proxy executing a FaultPlan.

    Only built by ``chaos.maybe_wrap`` (via ``make_comm_manager``) when a
    plan is installed; with no plan the comm stack never sees this class.
    """

    def __init__(self, inner, plan: FaultPlan, rank: int):
        self.inner = inner
        self.plan = plan
        self.rank = int(rank)
        self._lock = threading.Lock()
        self._seq: dict[tuple, int] = {}        # link -> frames seen
        self._fired: dict[tuple, int] = {}      # (rule, link) -> injections
        self._round: dict[tuple, int] = {}      # link -> last round tag
        self._held: dict[tuple, object] = {}    # link -> reorder stash
        self._tls = threading.local()

        # hook the inner manager's shared frame choke points (instance
        # attributes, so each wrapped manager is hooked independently)
        self._orig_receive = inner._receive_frame
        inner._receive_frame = self._recv_hook
        self._orig_encode = inner._encode
        inner._encode = self._encode_hook
        # gRPC only: hook the stub so a 'duplicate' re-sends the SAME
        # stamped (rank, epoch, seq) wire frame — a true redelivery that
        # the receiver's exactly-once ``_accept_frame`` gate must drop.
        # (Calling send_message twice would stamp a fresh seq and slip
        # past dedup; transports without a seq layer — loopback/MQTT —
        # duplicate at the message level instead, exercising the
        # protocol's round-tag/slot-overwrite invariants.)
        self._orig_stub = getattr(inner, "_stub", None)
        if self._orig_stub is not None:
            inner._stub = self._stub_hook

    # --------------------------------------------------- BaseCommManager API
    @property
    def backend_name(self) -> str:
        return self.inner.backend_name

    def add_observer(self, observer) -> None:
        self.inner.add_observer(observer)

    def remove_observer(self, observer) -> None:
        self.inner.remove_observer(observer)

    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        self._flush_held()
        self.inner.stop_receive_message()

    # -------------------------------------------------------------- helpers
    def _next_seq(self, link: tuple) -> int:
        with self._lock:
            s = self._seq.get(link, 0)
            self._seq[link] = s + 1
            return s

    def _round_of(self, params: dict | None, link: tuple) -> int | None:
        """The frame's protocol round: its own tag when present (updates the
        link's last-known round), else the link's last-known round — both
        derived from frame content / per-link history only, so windowed
        rules stay deterministic under thread interleaving."""
        if params is not None:
            for k in _ROUND_KEYS:
                r = params.get(k)
                if isinstance(r, (int, float)):
                    with self._lock:
                        self._round[link] = int(r)
                    return int(r)
        with self._lock:
            return self._round.get(link)

    def _would_fire(self, rule_idx: int, direction: str, src, dst, seq: int,
                    round_idx) -> bool:
        """Decision only — does NOT charge max_per_link (a fault that a
        higher-priority fault then suppresses must not consume budget, or
        a capped rule composed after an always-drop could never apply)."""
        rule = self.plan.rules[rule_idx]
        if not rule.matches_link(direction, src, dst):
            return False
        if not rule.in_window(round_idx):
            return False
        if not self.plan.fires(rule_idx, direction, src, dst, seq):
            return False
        if rule.max_per_link is not None:
            with self._lock:
                if self._fired.get((rule_idx, direction, src, dst),
                                   0) >= rule.max_per_link:
                    return False
        return True

    def _charge(self, rule_idx: int, direction: str, src, dst) -> None:
        """Consume one unit of the rule's per-link budget — called only
        when its fault is actually APPLIED (after suppression resolution)."""
        if self.plan.rules[rule_idx].max_per_link is None:
            return
        key = (rule_idx, direction, src, dst)
        with self._lock:
            self._fired[key] = self._fired.get(key, 0) + 1

    def _record(self, fault: str, direction: str, src, dst, seq: int,
                round_idx) -> None:
        self.plan.ledger.record(fault, direction, src, dst, seq, round_idx)
        _obs.record_fault(self.backend_name, fault, direction)
        log.info("chaos: %s %s %s->%s seq=%s round=%s",
                 fault, direction, src, dst, seq, round_idx)

    def _crashed(self, rank, round_idx) -> bool:
        # rank 0 is exempt: a crash rule naming the server is a SUPERVISED
        # RESTART (docs/ROBUSTNESS.md §Server crash recovery) executed by
        # the supervision layer through the checkpoint + WAL recovery
        # path — black-holing the coordinator's wire would model a
        # permanent outage no protocol can survive, not a restart
        if rank == 0:
            return False
        return any(r.fault == "crash" and rank in (r.ranks or ())
                   and r.in_window(round_idx) for r in self.plan.rules)

    def _partition_cut(self, src, dst, round_idx):
        """Index of the first partition rule cutting this link, else None."""
        for i, r in enumerate(self.plan.rules):
            if (r.fault == "partition" and r.in_window(round_idx)
                    and r.partition_cut(src, dst)):
                return i
        return None

    # ----------------------------------------------------------------- send
    def send_message(self, msg: "Message") -> None:
        src, dst = self.rank, int(msg.get_receiver_id())
        link = ("send", src, dst)
        seq = self._next_seq(link)
        round_idx = self._round_of(msg.get_params(), link)

        # rank-level faults first: a dead process sends nothing, and a send
        # to a dead process fails like a refused connection (the elastic
        # server's transport-error path; see module docstring)
        if self._crashed(src, round_idx):
            self._record("crash", "send", src, dst, seq, round_idx)
            return
        if self._crashed(dst, round_idx):
            self._record("crash", "send", src, dst, seq, round_idx)
            raise ConnectionError(
                f"chaos: rank {dst} crashed (round {round_idx})")
        cut = self._partition_cut(src, dst, round_idx)
        if cut is not None:
            self._record("partition", "send", src, dst, seq, round_idx)
            return  # netsplit: silent black hole

        # decide-then-apply: collect every firing rule first, record ONLY
        # what is actually applied (a drop suppresses everything else;
        # reorder supersedes delay) — the ledger must never claim a fault
        # that did not happen
        eff = self._firing_faults("send", src, dst, seq, round_idx,
                                  skip=("partition", "crash"))

        def apply(fault):  # ledger + metric + per-link budget, on APPLY only
            self._record(fault, "send", src, dst, seq, round_idx)
            self._charge(eff[fault].idx, "send", src, dst)

        if "drop" in eff:
            apply("drop")
            return
        # gRPC duplicates at the WIRE level (same stamped seq — the dedup
        # gate's prey); seq-less transports re-deliver the message instead
        wire_dup = "duplicate" in eff and self._orig_stub is not None
        copies = 2 if ("duplicate" in eff and not wire_dup) else 1
        corrupt_seq = seq if "corrupt" in eff else None
        for f in ("duplicate", "corrupt"):
            if f in eff:
                apply(f)
        if "straggle" in eff:
            apply("straggle")
            time.sleep(eff["straggle"].rule.delay_s)
        if "reorder" in eff:  # supersedes delay (the hold IS the delay)
            apply("reorder")
            self._hold(link, (msg, corrupt_seq, copies, wire_dup))
            return
        deliver = lambda: self._deliver_send(link, msg, corrupt_seq, copies,
                                             wire_dup)
        if "delay" in eff:
            apply("delay")
            t = threading.Timer(eff["delay"].rule.delay_s, deliver)
            t.daemon = True
            t.start()
        else:
            deliver()

    def _firing_faults(self, direction, src, dst, seq, round_idx, skip=()):
        """{fault: first firing rule of that kind} for this frame. The
        caller records + ``_charge``s exactly the faults it applies."""
        eff: dict[str, "_Firing"] = {}
        for i, rule in enumerate(self.plan.rules):
            if rule.fault in skip or rule.fault in eff:
                continue
            if self._would_fire(i, direction, src, dst, seq, round_idx):
                eff[rule.fault] = _Firing(i, rule)
        return eff

    def _deliver_send(self, link, msg, corrupt_seq, copies=1,
                      wire_dup=False) -> None:
        for _ in range(copies):
            if corrupt_seq is not None:
                self._tls.corrupt_seq = corrupt_seq
            if wire_dup:
                self._tls.wire_dup = True
            try:
                self.inner.send_message(msg)
            finally:
                self._tls.corrupt_seq = None
                self._tls.wire_dup = False
        self._release_held(link)

    def _encode_hook(self, msg, codec=None) -> bytes:
        frame = self._orig_encode(msg, codec)
        seq = getattr(self._tls, "corrupt_seq", None)
        if seq is not None:
            frame = corrupt_bytes(frame, self.plan.seed, seq)
        return frame

    def _stub_hook(self, dest):
        call = self._orig_stub(dest)

        def invoke(frame, **kw):
            out = call(frame, **kw)
            if getattr(self._tls, "wire_dup", False):
                self._tls.wire_dup = False
                try:  # identical stamped bytes: at-least-once redelivery
                    call(frame, **kw)
                except Exception:  # noqa: BLE001 — the dup IS the chaos;
                    # its delivery failing is just loss, not a send error
                    log.warning("chaos: wire-duplicate to %s failed", dest,
                                exc_info=True)
            return out

        return invoke

    # ----------------------------------------------------------------- recv
    def _peek(self, data: bytes):
        """(sender, params) from the raw frame — chaos-path only (the clean
        path decodes exactly once, in ``_receive_frame``). An undecodable
        frame (e.g. already corrupted by the sender's chaos) yields
        (None, None): src-filtered rules stay quiet and the frame proceeds
        to the integrity check."""
        try:
            msg = Message.from_bytes(data)
            return int(msg.get_sender_id()), msg.get_params()
        except Exception:  # noqa: BLE001 — expected under sender-side chaos
            # quiet by design (the integrity check downstream counts the
            # frame), but never invisible: a peek failing for a NON-chaos
            # reason (protocol drift, framing bug) must be diagnosable
            log.debug("chaos: peek failed on a %d-byte frame (proceeding "
                      "to the integrity check)", len(data), exc_info=True)
            return None, None

    def _recv_hook(self, data: bytes) -> None:
        dst = self.rank
        src, params = self._peek(data)
        link = ("recv", src, dst)
        seq = self._next_seq(link)
        round_idx = self._round_of(params, link)

        if self._crashed(dst, round_idx) or self._crashed(src, round_idx):
            self._record("crash", "recv", src, dst, seq, round_idx)
            return
        if self._partition_cut(src, dst, round_idx) is not None:
            self._record("partition", "recv", src, dst, seq, round_idx)
            return

        eff = self._firing_faults("recv", src, dst, seq, round_idx,
                                  skip=("partition", "crash", "straggle"))

        def apply(fault):  # ledger + metric + per-link budget, on APPLY only
            self._record(fault, "recv", src, dst, seq, round_idx)
            self._charge(eff[fault].idx, "recv", src, dst)

        if "drop" in eff:
            apply("drop")
            return
        copies = 2 if "duplicate" in eff else 1
        if "corrupt" in eff:
            apply("corrupt")
            data = corrupt_bytes(data, self.plan.seed, seq)
        if "duplicate" in eff:
            apply("duplicate")
        if "reorder" in eff:  # supersedes delay (the hold IS the delay)
            apply("reorder")
            self._hold(link, (data, copies))
            return
        deliver = lambda: self._deliver_recv(link, data, copies)
        if "delay" in eff:
            apply("delay")
            t = threading.Timer(eff["delay"].rule.delay_s, deliver)
            t.daemon = True
            t.start()
        else:
            deliver()

    def _deliver_recv(self, link, data, copies=1) -> None:
        for _ in range(copies):
            self._orig_receive(data)
        self._release_held(link)

    # -------------------------------------------------------------- reorder
    def _hold(self, link, item) -> None:
        """Stash a frame until the link's next frame passes it. A frame
        with no successor (last of its link) is released by a backstop
        timer so a reordered FINISH can't wedge the protocol forever. The
        timer is pinned to ITS item: a stale timer whose hold was already
        released by a successor must not prematurely release a newer hold
        on the same link."""
        with self._lock:
            prev = self._held.pop(link, None)
            self._held[link] = item
        if prev is not None:  # two holds back-to-back: release the older
            self._emit(link, prev)
        t = threading.Timer(_REORDER_BACKSTOP_S,
                            lambda: self._release_held(link, only=item))
        t.daemon = True
        t.start()

    def _release_held(self, link, only=None) -> None:
        """Release the link's held frame; with ``only`` set, release it
        only if it is still that exact frame (backstop-timer identity)."""
        with self._lock:
            item = self._held.get(link)
            if item is None or (only is not None and item is not only):
                return
            del self._held[link]
        self._emit(link, item)

    def _emit(self, link, item) -> None:
        try:
            if link[0] == "send":
                msg, corrupt_seq, copies, wire_dup = item
                for _ in range(copies):
                    if corrupt_seq is not None:
                        self._tls.corrupt_seq = corrupt_seq
                    if wire_dup:
                        self._tls.wire_dup = True
                    try:
                        self.inner.send_message(msg)
                    finally:
                        self._tls.corrupt_seq = None
                        self._tls.wire_dup = False
            else:
                data, copies = item
                for _ in range(copies):
                    self._orig_receive(data)
        except Exception:  # noqa: BLE001 — a held frame is already "in the
            # network"; its delayed delivery failing (peer gone) is loss,
            # not a sender error to re-raise on an unrelated thread
            log.warning("chaos: releasing held frame on %s failed", link,
                        exc_info=True)

    def _flush_held(self) -> None:
        with self._lock:
            held = list(self._held.items())
            self._held.clear()
        for link, item in held:
            self._emit(link, item)
