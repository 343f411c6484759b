"""Buffered asynchronous rounds, port of fedml_tpu/core/async_buffer.py (the
host half): staleness policies and the bounded staging buffer of the
cross-process server's buffered-async mode (FedBuff-style,
arXiv:2106.06639), plus the chaos plan's duration model.

The synchronous server is a round barrier: one straggling or crashed rank
owns the round's critical path. Buffered-async rounds remove it:

- clients train and upload **continuously** against possibly-stale globals;
- the server aggregates as soon as a buffer of K sanitized arrivals fills
  (or a deadline fires), weighting each update by a pluggable **staleness
  discount** (constant / polynomial / exponential — in torch, each with a
  numpy oracle twin, test-enforced);
- **admission control** rejects-and-requeues updates staler than a bound
  and skips dispatching to ranks whose ``fed_last_heartbeat_age_seconds``
  marks them suspect;
- **backpressure**: the staging buffer is bounded — overflow sheds the
  stalest pending update (counted in ``fed_async_shed_total{reason}``),
  never blocks dispatch.

Degenerate contract (test-enforced): ``K = cohort`` with staleness bound 0
reduces **bitwise** to the synchronous path — model bits AND quarantine
ledger — because every composition point (the per-client fit, the gate,
the fold) is the code the sync barrier runs, invoked from the event loop.

The consumer here is the cross-process ``FedAvgServerManager(
async_buffer_k=...)`` (distributed/fedavg/server_manager.py). The
reference's second consumer, the engine's virtual-clock simulator
``VirtualClockAsyncRunner`` (with ``FedAvgAPI.run_async``), is queued in
ROADMAP.md (queue A, item 8); :func:`straggle_delay_s`,
:func:`crashed_in_wave` and :func:`sync_virtual_wallclock` are its
duration model, ported with the buffer.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np
import torch

log = logging.getLogger("fedml_tpu_torch.async_buffer")

STALENESS_KINDS = ("constant", "polynomial", "exponential")

# shed-reason vocabulary for fed_async_shed_total{reason}; admission and
# backpressure verdicts share it so dashboards see one family ('suspect'
# is the cross-process server's heartbeat-admission skip; 'undecodable' is
# an encoded uplink — top-k / delta / quantized, comm/delta.py — whose
# payload was structural garbage: quarantined at decode, requeued). Note
# encoded uplinks also shed 'stale' when their versioned base was evicted
# from the server's bounded broadcast stash.
# 'server_restart' is the crash-recovery shed (docs/ROBUSTNESS.md §Server
# crash recovery): work that was in flight when the server died — the
# WAL-journaled buffer entries lost with the process, and post-restart
# arrivals whose echoed restart_epoch predates the recovery.
# 'offline' is SCHEDULED unavailability (chaos/churn.py ChurnTrace): the
# slot/rank is away by the trace, not dead — skipped silently with no
# suspect bookkeeping or reprobe churn, counted here so the export still
# shows where round capacity went.
SHED_REASONS = ("stale", "overflow", "nonfinite", "crash", "suspect",
                "undecodable", "server_restart", "offline")


# ------------------------------------------------------ staleness discounts
def make_staleness_fn(kind: str, a: float = 0.5) -> Callable:
    """Discount ``s -> weight multiplier`` over an int/float staleness
    tensor (s = server version at aggregation minus the version the update
    trained against), in torch on the tensor's device. The
    FedBuff/FedAsync menu:

    - ``constant``:    1 (staleness-blind — the FedBuff paper's default);
    - ``polynomial``:  (1 + s)^-a  (FedAsync's poly discount);
    - ``exponential``: exp(-a * s).

    ``constant`` multiplies by exactly 1.0, so the staleness-0 weights are
    BITWISE the synchronous sample weights (the degenerate-parity
    contract's weight half).
    """
    if kind not in STALENESS_KINDS:
        raise ValueError(f"unknown staleness kind {kind!r} "
                         f"(one of {STALENESS_KINDS})")
    a = float(a)
    f32 = lambda s: torch.as_tensor(s, dtype=torch.float32)  # noqa: E731
    if kind == "constant":
        return lambda s: torch.ones_like(f32(s))
    if kind == "polynomial":
        return lambda s: (1.0 + f32(s)) ** (-a)
    return lambda s: torch.exp(-a * f32(s))


def staleness_oracle(kind: str, a: float = 0.5) -> Callable:
    """Numpy twin of :func:`make_staleness_fn` — the test oracle, and what
    the cross-process server uses host-side (weights are [K] scalars; a
    device round trip per flush would be pure overhead)."""
    if kind not in STALENESS_KINDS:
        raise ValueError(f"unknown staleness kind {kind!r} "
                         f"(one of {STALENESS_KINDS})")
    a = float(a)
    if kind == "constant":
        return lambda s: np.ones_like(np.asarray(s, np.float32))
    if kind == "polynomial":
        return lambda s: (1.0 + np.asarray(s, np.float32)) ** (-a)
    return lambda s: np.exp(-a * np.asarray(s, np.float32)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class StalenessPolicy:
    """Discount kind + parameter + admission bound, with the CLI spec
    parser (``--staleness``): 'constant' | 'poly:0.5' | 'exp:0.3'.

    ``bound``: an arriving update with staleness > bound is REJECTED and
    its rank requeued with the fresh model (admission control); None = any
    staleness admitted (discount-only). ``bound == 0`` additionally parks
    uploaded ranks until the next flush — work started pre-flush would be
    born stale and rejected, so bound-0 IS the synchronous barrier
    expressed in the async machinery (the degenerate-parity mode).
    """

    kind: str = "constant"
    a: float = 0.5
    bound: int | None = None

    def __post_init__(self):
        if self.kind not in STALENESS_KINDS:
            raise ValueError(f"unknown staleness kind {self.kind!r} "
                             f"(one of {STALENESS_KINDS})")
        if self.bound is not None and self.bound < 0:
            raise ValueError(f"staleness bound must be >= 0, got {self.bound}")

    @classmethod
    def from_spec(cls, spec, bound: int | None = None) -> "StalenessPolicy":
        """'constant' | 'poly:A' | 'polynomial:A' | 'exp:A' |
        'exponential:A' (A = the discount's decay parameter), or an
        already-built policy (passed through; ``bound`` then overrides
        only when given)."""
        if isinstance(spec, StalenessPolicy):
            if bound is None:
                return spec
            return dataclasses.replace(spec, bound=bound)
        name, _, arg = str(spec or "constant").partition(":")
        name = {"poly": "polynomial", "exp": "exponential"}.get(
            name.strip().lower(), name.strip().lower())
        return cls(kind=name, a=float(arg) if arg else 0.5, bound=bound)

    def discount(self) -> Callable:
        return make_staleness_fn(self.kind, self.a)

    def discount_np(self) -> Callable:
        return staleness_oracle(self.kind, self.a)

    def admits(self, staleness: int) -> bool:
        return self.bound is None or staleness <= self.bound

    @property
    def synchronous(self) -> bool:
        """bound == 0: park-until-flush (see class docstring)."""
        return self.bound == 0


# --------------------------------------------------------------- the buffer
@dataclasses.dataclass
class BufferedUpdate:
    """One sanitized arrival staged for the next buffered aggregate.
    ``payload`` is runtime-shaped: staged wire leaves cross-process, a
    per-client NetState in the simulator. ``version`` is the global model
    version the update trained against (staleness at flush = current
    version - this)."""

    rank: int          # 1-based worker rank (sim: slot + 1)
    client: int        # the client id this dispatch trained
    version: int
    wave: int          # the rank's dispatch counter (sampling key)
    payload: object
    nsamp: float
    seq: int           # global arrival sequence (deterministic tie-break)
    t_arrival: float


class AsyncBuffer:
    """Bounded staging buffer between ingest and the buffered aggregate.

    ``add`` never blocks: past ``capacity`` the STALEST pending update
    (lowest trained-against version, oldest arrival on ties) is shed and
    returned to the caller to count (``fed_async_shed_total{overflow}``) —
    backpressure degrades the oldest information first instead of stalling
    the dispatch path. NOTE the inline-flush drivers (the simulator and
    the async server both flush the moment ``ready`` trips, inside the
    same lock/loop that staged the arrival) keep ``len`` structurally at
    or below ``flush_threshold`` <= ``capacity``, so for them the bound is
    enforced by immediate flushing and the shed path is the backstop for
    any driver that defers flushes (a future queue-the-flush server).
    ``drain`` returns entries sorted by (rank, seq): a deterministic
    stacking order — at K = cohort exactly the sync engine's slot order,
    which is half of the bitwise-parity contract.

    Not thread-safe by itself: the cross-process server mutates it under
    its round lock; the simulator is single-threaded.
    """

    def __init__(self, k: int, capacity: int | None = None, journal=None):
        k = int(k)
        if k < 1:
            raise ValueError(f"async buffer k must be >= 1, got {k}")
        self.k = k
        self.capacity = int(capacity) if capacity is not None else 2 * k
        if self.capacity < 1:
            raise ValueError(f"buffer capacity must be >= 1, "
                             f"got {self.capacity}")
        # crash-recovery journal hook (docs/ROBUSTNESS.md §Server crash
        # recovery): callable(event, entry) invoked on 'admit'/'shed' so
        # the server's WAL records buffer membership — a restarted server
        # ledgers exactly the entries that died with the process. None =
        # the pre-WAL behavior, zero extra work.
        self.journal = journal
        self._entries: list[BufferedUpdate] = []

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def flush_threshold(self) -> int:
        """K, clamped by capacity (a capacity below K must still flush)."""
        return min(self.k, self.capacity)

    @property
    def ready(self) -> bool:
        return len(self._entries) >= self.flush_threshold

    def first_arrival_t(self) -> float | None:
        return min((e.t_arrival for e in self._entries), default=None)

    def add(self, entry: BufferedUpdate) -> list[BufferedUpdate]:
        """Stage one arrival; returns the entries shed to stay within
        capacity (stalest first), possibly including the new entry itself
        when it is the stalest of the lot."""
        self._entries.append(entry)
        if self.journal is not None:
            self.journal("admit", entry)
        shed: list[BufferedUpdate] = []
        while len(self._entries) > self.capacity:
            victim = min(self._entries, key=lambda e: (e.version, e.seq))
            self._entries.remove(victim)
            shed.append(victim)
            if self.journal is not None:
                self.journal("shed", victim)
        return shed

    def drain(self) -> list[BufferedUpdate]:
        entries, self._entries = self._entries, []
        return sorted(entries, key=lambda e: (e.rank, e.seq))


# ------------------------------------------------- virtual-clock simulator
def straggle_delay_s(plan, rank: int, wave: int) -> float:
    """Total chaos straggle delay for a (rank, wave) dispatch under a
    FaultPlan — the virtual clock's duration model. Matches rules with the
    injector's own ``matches_link`` on the UPLINK (direction 'send',
    rank -> server 0 — exactly the link the wire injector sleeps on), so
    a plan written for the wire runtime means the same schedule here; a
    'recv'-direction rule never applies. ``link_seq`` := wave, so
    probabilistic rules stay a pure function of (seed, rule, rank, wave)
    and the simulated run replays bit-for-bit."""
    if plan is None:
        return 0.0
    total = 0.0
    for i, rule in enumerate(plan.rules):
        if rule.fault != "straggle" or not rule.in_window(wave):
            continue
        if not rule.matches_link("send", rank, 0):
            continue
        if plan.fires(i, "send", rank, 0, wave):
            total += rule.delay_s
    return total


def crashed_in_wave(plan, rank: int, wave: int) -> bool:
    if plan is None:
        return False
    return any(r.fault == "crash" and rank in (r.ranks or ())
               and r.in_window(wave) for r in plan.rules)


def sync_virtual_wallclock(plan, n_ranks: int, num_rounds: int,
                           base_duration_s: float = 1.0) -> float:
    """The synchronous barrier's virtual wall-clock under the same duration
    model the async simulator uses: each round costs the MAX over the
    cohort's dispatch durations (the straggler owns the round — PR 3's
    critical-path attribution, now a closed form). The async-beats-sync
    acceptance compares the simulator's clock against this."""
    total = 0.0
    for r in range(num_rounds):
        total += max(base_duration_s + straggle_delay_s(plan, rank, r)
                     for rank in range(1, n_ranks + 1))
    return total
