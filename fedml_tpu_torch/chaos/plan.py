"""FaultPlan — the declarative, seeded schedule the chaos layer executes.

A plan is JSON-serializable so a soak run can be replayed bit-for-bit from
its seed (``scripts/chaos_soak.py``, ``--chaos-plan`` on the launcher)::

    {
      "seed": 1234,
      "rules": [
        {"fault": "drop",      "direction": "send", "src": [1], "dst": [0],
         "rounds": [1, 3], "prob": 0.5},
        {"fault": "corrupt",   "direction": "recv", "dst": [0], "prob": 0.2},
        {"fault": "duplicate", "direction": "send", "src": [2], "dst": [0]},
        {"fault": "partition", "groups": [[0, 1], [2, 3]], "rounds": [2, 4]},
        {"fault": "crash",     "ranks": [3], "rounds": [1, 3]},
        {"fault": "straggle",  "src": [2], "delay_s": 0.3}
      ]
    }

Determinism contract: whether a rule fires on a given frame is a pure
function of ``(plan.seed, rule index, direction, src, dst, link_seq)``
where ``link_seq`` is that (direction, src, dst) link's frame counter.
Link counters are deterministic because each link's frames are emitted in
one thread's program order; nothing reads the wall clock or a shared RNG,
so concurrent links cannot perturb each other's draws. The global
interleaving OF links still varies run to run — which is why the ledger's
``canonical()`` view is sorted — but the *set* of injected faults, and
each link's injection order, replays exactly.
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field
from typing import Any

FAULTS = ("drop", "delay", "duplicate", "reorder", "corrupt",
          "partition", "crash", "straggle")
DIRECTIONS = ("send", "recv")


def _decide(seed: int, rule_idx: int, direction: str, src, dst,
            seq: int) -> float:
    """Uniform [0, 1) draw, pure in its arguments (sha256 counter mode)."""
    key = f"{seed}|{rule_idx}|{direction}|{src}|{dst}|{seq}".encode()
    h = hashlib.sha256(key).digest()
    return int.from_bytes(h[:8], "little") / 2.0 ** 64


@dataclass
class FaultRule:
    """One (fault, round-window, rank, direction) schedule entry.

    ``src``/``dst`` filter by sender/receiver rank (None = any);
    ``rounds`` is a half-open [lo, hi) window of protocol rounds (None =
    always); ``prob`` is the per-frame firing probability; ``max_per_link``
    caps injections per (direction, src, dst) link — per-link, not global,
    so the cap is deterministic under thread interleaving. ``delay_s``
    parameterizes delay/straggle; ``groups`` parameterizes partition
    (ranks in different groups cannot reach each other); ``ranks``
    parameterizes crash (those ranks go dark for the window).

    A crash rule naming RANK 0 is a **server crash** (docs/ROBUSTNESS.md
    §Server crash recovery): the wire layer does not black-hole it — the
    supervision layer executes it as a deterministic kill-and-restart
    through the checkpoint + WAL recovery path (``run_simulated`` in
    loopback; the real process dies under ``--supervise``).
    ``after_uploads`` refines WHERE in the window's first round the
    server dies: None = between commits (entering the round, before any
    frame of it leaves); an integer m >= 0 = mid-round, once m uploads of
    the round were accepted (their WAL records durable, their payloads
    lost with the process); -1 = at the secure-aggregation reveal
    fan-out (the masked tier's recovery state machine — the crash must
    shed the round, never half-recover the fold)."""

    fault: str
    direction: str = "send"
    src: list[int] | None = None
    dst: list[int] | None = None
    rounds: list[int] | None = None
    prob: float = 1.0
    delay_s: float = 0.05
    max_per_link: int | None = None
    groups: list[list[int]] | None = None
    ranks: list[int] | None = None
    after_uploads: int | None = None

    def __post_init__(self):
        if self.fault not in FAULTS:
            raise ValueError(f"unknown fault {self.fault!r} (one of {FAULTS})")
        if self.direction not in DIRECTIONS:
            raise ValueError(
                f"unknown direction {self.direction!r} (send|recv)")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        if self.rounds is not None and len(self.rounds) != 2:
            raise ValueError(f"rounds must be [lo, hi), got {self.rounds}")
        if self.fault == "partition" and not self.groups:
            raise ValueError("partition rule needs 'groups': [[...], [...]]")
        if self.fault == "crash" and not self.ranks:
            raise ValueError("crash rule needs 'ranks': [...]")
        if self.after_uploads is not None and self.fault != "crash":
            raise ValueError("after_uploads only parameterizes crash rules")
        if self.after_uploads is not None and self.after_uploads < -1:
            # -1 = the secagg reveal fan-out; anything below can never
            # match a crash point and would be silently inert
            raise ValueError(
                f"after_uploads must be >= -1, got {self.after_uploads}")
        if self.fault == "crash" and 0 in (self.ranks or ()) \
                and self.rounds is None:
            # a rank-0 crash is a supervised server restart: an unbounded
            # window would re-kill the server the moment it recovered,
            # forever — demand an explicit round
            raise ValueError("a crash rule naming rank 0 (server restart) "
                             "needs a 'rounds' window")

    def in_window(self, round_idx: int | None) -> bool:
        if self.rounds is None:
            return True
        if round_idx is None:
            return False  # round unknown -> a windowed rule stays quiet
        return self.rounds[0] <= round_idx < self.rounds[1]

    def matches_link(self, direction: str, src: int | None,
                     dst: int | None) -> bool:
        if self.direction != direction:
            return False
        if self.src is not None and src not in self.src:
            return False
        if self.dst is not None and dst not in self.dst:
            return False
        return True

    def partition_cut(self, src: int | None, dst: int | None) -> bool:
        """True when src and dst sit in different partition groups."""
        g_src = g_dst = None
        for i, g in enumerate(self.groups or ()):
            if src in g:
                g_src = i
            if dst in g:
                g_dst = i
        return g_src is not None and g_dst is not None and g_src != g_dst


class FaultLedger:
    """Thread-safe record of every injected fault — the replay artifact.

    ``canonical()`` sorts entries into a thread-interleaving-independent
    order; two runs of the same plan over the same workload produce equal
    canonical ledgers (the determinism acceptance test)."""

    def __init__(self):
        self._entries: list[dict] = []
        self._lock = threading.Lock()

    def record(self, fault: str, direction: str, src, dst, seq: int,
               round_idx) -> None:
        with self._lock:
            self._entries.append({
                "fault": fault, "direction": direction, "src": src,
                "dst": dst, "seq": seq, "round": round_idx,
            })

    def canonical(self) -> list[tuple]:
        def key(t):
            # src/round can be None (an undecodable frame has no sender /
            # no round tag) — map None below any int so mixed ledgers sort
            return tuple(-1 if v is None else v for v in t[2:]), t[:2]

        with self._lock:
            return sorted(
                ((e["fault"], e["direction"], e["src"], e["dst"], e["seq"],
                  e["round"]) for e in self._entries), key=key)

    def for_round(self, round_idx, faults: tuple[str, ...] | None = None
                  ) -> list[dict]:
        """Entries of one round (optionally one fault subset) — an O(n)
        filtered scan, no sort/full copy: per-round consumers (the trace
        stitcher cross-references straggle/delay per upload) must not
        re-canonicalize a soak run's whole ledger every frame."""
        with self._lock:
            return [dict(e) for e in self._entries
                    if e["round"] == round_idx
                    and (faults is None or e["fault"] in faults)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        with self._lock:
            for e in self._entries:
                out[e["fault"]] = out.get(e["fault"], 0) + 1
        return out


@dataclass
class FaultPlan:
    """A seed plus an ordered rule list; carries the run's ledger."""

    seed: int = 0
    rules: list[FaultRule] = field(default_factory=list)
    ledger: FaultLedger = field(default_factory=FaultLedger, repr=False)

    # ------------------------------------------------------------- decisions
    def fires(self, rule_idx: int, direction: str, src, dst,
              seq: int) -> bool:
        rule = self.rules[rule_idx]
        if rule.prob >= 1.0:
            return True
        return _decide(self.seed, rule_idx, direction, src, dst,
                       seq) < rule.prob

    def server_crash_points(self) -> list[tuple[int, int | None]]:
        """The supervision schedule a rank-0 crash rule encodes (docs/
        ROBUSTNESS.md §Server crash recovery): sorted ``(round,
        after_uploads)`` points, one per rule, each consumed by exactly
        one kill-and-restart. The wire injector ignores rank 0 in crash
        rules — a dead server is a restart, not a black hole."""
        return sorted(
            ((int(r.rounds[0]), r.after_uploads)
             for r in self.rules
             if r.fault == "crash" and 0 in (r.ranks or ())),
            # None (between commits) sorts before any mid-round point of
            # the same round; mixing None and int must not TypeError
            key=lambda p: (p[0], p[1] is not None, p[1] or 0))

    # --------------------------------------------------------- serialization
    @classmethod
    def from_json(cls, spec: str | dict[str, Any]) -> "FaultPlan":
        doc = json.loads(spec) if isinstance(spec, str) else spec
        rules = [FaultRule(**r) for r in doc.get("rules", [])]
        return cls(seed=int(doc.get("seed", 0)), rules=rules)

    @classmethod
    def from_file(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """The CLI dual form — a JSON file path or inline JSON (the one
        dispatch rule every --*-plan flag shares)."""
        import os

        return cls.from_file(spec) if os.path.exists(spec) \
            else cls.from_json(spec)

    def to_json(self) -> str:
        def rule_doc(r: FaultRule) -> dict:
            doc = {"fault": r.fault, "direction": r.direction}
            for k in ("src", "dst", "rounds", "max_per_link", "groups",
                      "ranks", "after_uploads"):
                v = getattr(r, k)
                if v is not None:
                    doc[k] = v
            if r.prob != 1.0:
                doc["prob"] = r.prob
            if r.fault in ("delay", "straggle"):
                doc["delay_s"] = r.delay_s
            return doc

        return json.dumps({"seed": self.seed,
                           "rules": [rule_doc(r) for r in self.rules]})

    def fresh(self) -> "FaultPlan":
        """Same schedule, empty ledger — for replaying a plan."""
        return FaultPlan(seed=self.seed, rules=list(self.rules))
