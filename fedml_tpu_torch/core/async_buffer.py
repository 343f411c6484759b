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

Two consumers share these pieces:

- :class:`VirtualClockAsyncRunner` — a discrete-event simulator over a
  ``FedAvgAPI`` engine (``FedAvgAPI.run_async``). The clock is virtual
  (each dispatch takes ``base_duration_s`` plus any chaos straggle delay
  scheduled for its (rank, wave): :func:`straggle_delay_s`), so
  async-vs-sync wall-clock claims (:func:`sync_virtual_wallclock`) are
  deterministic and replay bit for bit;
- the cross-process ``FedAvgServerManager(async_buffer_k=...)``
  (distributed/fedavg/server_manager.py), driving the real event-driven
  wire loop.
"""

from __future__ import annotations

import dataclasses
import heapq
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


class VirtualClockAsyncRunner:
    """Discrete-event buffered-async driver over a ``FedAvgAPI`` engine.

    Worker slots (one per cohort position, mirroring the cross-process
    worker ranks) train continuously: slot j's wave-w dispatch trains
    client ``engine._sampled_ids(w)[j]`` against a snapshot of the global
    model at dispatch time. Its fit is the engine's ``local_update``, and
    the slots a single event dispatches together (the same snapshot and
    wave, e.g. the whole cohort after a bound-0 flush) are fitted as ONE
    cohort — the very call ``run_round`` makes, which is what keeps the
    degenerate mode bitwise on any device; a lone dispatch is a cohort of
    one. Arrivals pass admission (staleness bound -> requeue; non-finite ->
    quarantined, NEVER buffered) into the :class:`AsyncBuffer`; a full
    buffer (or a virtual deadline) flushes: ``agg_weights x
    discount(staleness)`` through the engine's gate / estimator
    (``gated_aggregate``) or ``tree_weighted_mean``, then the engine's
    ``_update_from_aggregate`` with the key the sync round would draw, so a
    post-aggregate hook (DP noise) applies on top of the buffered aggregate
    as it does synchronously.

    Everything is a pure function of (engine seed, chaos plan, policy), so
    a seeded async chaos run replays bit for bit. The reference's
    refusals stand: no ``client_result_hook``, no in-graph adversary (an
    ``adversary_plan`` here perturbs each arrival on the wire leaves, as a
    Byzantine client would).
    """

    def __init__(self, engine, buffer_k: int, staleness="constant",
                 staleness_bound: int | None = None,
                 deadline_s: float | None = None,
                 capacity: int | None = None,
                 chaos_plan=None, adversary_plan=None,
                 base_duration_s: float = 1.0):
        from fedml_tpu_torch.obs import perf_instrument as _perf

        if engine.client_result_hook is not None or \
                engine._adversary is not None:
            raise ValueError(
                "the async simulator composes adversaries per-arrival "
                "(adversary_plan=) and has no per-client hook path — build "
                "the engine without client_result_hook/adversary_plan")
        self.engine = engine
        self.policy = StalenessPolicy.from_spec(staleness,
                                                bound=staleness_bound)
        self.buffer = AsyncBuffer(buffer_k, capacity=capacity)
        self.deadline_s = deadline_s
        self.chaos_plan = chaos_plan
        self.adversary_plan = adversary_plan
        self.base_duration_s = float(base_duration_s)
        self._discount = self.policy.discount()
        _perf.ensure_async_shed_families()
        self.version = 0
        self.clock = 0.0
        self.shed_counts = {r: 0 for r in SHED_REASONS}
        self.staleness_seen: list[int] = []
        self.history: list[dict] = []
        self._seq = 0
        self._epoch = 0  # buffer epoch: stale deadline events are ignored
        n = engine.cfg.client_num_per_round
        self._wave = [0] * n
        self._parked: list[int] = []  # bound-0 mode: slots awaiting a flush
        # (t, version, wave) -> the slots one event dispatched together
        # and, once the first of them arrives, their batched fit
        self._groups: dict[tuple, dict] = {}

    # ---------------------------------------------------------------- queue
    def _dispatch(self, heap, slot: int, t: float):
        """Slot becomes free at virtual time ``t``: assign its next wave's
        client, snapshot the current global, schedule the arrival."""
        wave = self._wave[slot]
        self._wave[slot] += 1
        dur = self.base_duration_s + straggle_delay_s(
            self.chaos_plan, slot + 1, wave)
        self._seq += 1
        ids = self.engine._sampled_ids(wave)
        if slot >= len(ids):
            # scheduled-offline (churn trace): this wave's available
            # cohort is smaller than the slot count — the slot idles
            # through the wave and retries the next one. Deliberately NOT
            # the dead path: no suspect bookkeeping, just the 'offline'
            # shed counter so stats() show where wave capacity went
            heapq.heappush(heap, (t + dur, self._seq, "arrival",
                                  {"slot": slot, "wave": wave,
                                   "offline": True}))
            return
        item = {
            "slot": slot, "wave": wave,
            "client": int(ids[slot]),
            "version": self.version,
            "net": self.engine.net,  # snapshot ref (replaced, never mutated)
            "dead": crashed_in_wave(self.chaos_plan, slot + 1, wave),
        }
        if not item["dead"]:
            key = (t, self.version, wave)
            group = self._groups.setdefault(
                key, {"key": key, "slots": [], "ids": ids,
                      "net": self.engine.net, "wave": wave, "out": None})
            group["slots"].append(slot)
            item["group"] = group
        heapq.heappush(heap, (t + dur, self._seq, "arrival", item))

    def _fit_group(self, group: dict) -> None:
        """The batched fit of one dispatch group: the engine's packing
        and ``local_update`` over its clients in slot order."""
        from fedml_tpu_torch.algorithms.fedavg import float32_compute

        eng = self.engine
        slots = sorted(group["slots"])
        cids = np.asarray([int(group["ids"][s]) for s in slots], np.int64)
        x, y, mask, nsamp = eng._round_batch(group["wave"], cids)
        with float32_compute():
            nets, _ = eng.local_update(group["net"], x, y, mask)
        nsamp = nsamp.cpu().numpy()
        group["out"] = {s: ({k: v[i] for k, v in nets.items()},
                            float(nsamp[i])) for i, s in enumerate(slots)}
        group["net"] = None

    def _compute_arrival(self, item):
        """The arrival's local fit (its dispatch group's row), then the
        plan's attack on the wire leaves, as a Byzantine client lies."""
        group = item["group"]
        if group["out"] is None:
            self._fit_group(group)
        net_k, nsamp = group["out"].pop(item["slot"])
        if not group["out"]:
            self._groups.pop(group["key"], None)
        if self.adversary_plan is not None:
            from fedml_tpu_torch.chaos.adversary import perturb_leaves
            from fedml_tpu_torch.comm.message import pack_pytree, unpack_pytree
            from fedml_tpu_torch.convert import num_heads_of

            heads = num_heads_of(self.engine.task.module)
            leaves = perturb_leaves(
                self.adversary_plan, pack_pytree(net_k, heads),
                pack_pytree(item["net"], heads), item["slot"] + 1,
                item["wave"])
            net_k = unpack_pytree(net_k, leaves, heads)
        return net_k, nsamp

    def _shed(self, reason: str):
        from fedml_tpu_torch.obs import perf_instrument as _perf

        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1
        _perf.record_async_shed(reason)

    @staticmethod
    def _finite(net: dict) -> bool:
        return all(bool(torch.isfinite(v).all()) for v in net.values()
                   if v.is_floating_point())

    # ---------------------------------------------------------------- flush
    def _flush(self, t: float):
        from fedml_tpu_torch.algorithms.fedavg import (agg_weights,
                                                       float32_compute)
        from fedml_tpu_torch.core.robust_agg import gated_aggregate
        from fedml_tpu_torch.obs import perf_instrument as _perf
        from fedml_tpu_torch.utils import prng
        from fedml_tpu_torch.utils.tree import tree_weighted_mean

        eng = self.engine
        entries = self.buffer.drain()
        self._epoch += 1
        if not entries:
            return
        stale = [self.version - e.version for e in entries]
        self.staleness_seen.extend(stale)
        for s in stale:
            _perf.record_update_staleness(s)
        first_t = min(e.t_arrival for e in entries)
        _perf.record_buffer_fill(t - first_t)

        stacked = {k: torch.stack([e.payload[k] for e in entries])
                   for k in eng.net}
        nsamp = torch.tensor([e.nsamp for e in entries], dtype=torch.float32,
                             device=eng.device)
        stale_v = torch.tensor(stale, dtype=torch.int32, device=eng.device)
        # the sync driver's exact key chain (one split per global update,
        # the round's three-way split mirrored for the post hook's key)
        eng.rng, rk = prng.split(eng.rng)
        _, _, kp = prng.split(rk, 3)
        old_net = eng.net
        with float32_compute():
            w = agg_weights(nsamp, eng.uniform_avg) * self._discount(stale_v)
            if eng._needs_stacked:
                avg, _, reasons = gated_aggregate(
                    stacked, eng.net, w, robust_fn=eng._robust_agg,
                    norm_mult=eng._sanitize_mult)
            else:
                avg = tree_weighted_mean(stacked, w)
                reasons = None
            eng.net, eng.server_opt_state = eng._update_from_aggregate(
                eng.net, avg, eng.server_opt_state, kp)
        if reasons is not None:
            eng.quarantine.record_codes(
                self.version, reasons.cpu().numpy(),
                clients=[e.client for e in entries],
                ranks=[e.rank for e in entries])
        rec = {
            "update": self.version, "t": round(t, 6), "k": len(entries),
            "staleness": stale, "buffer_fill_s": round(t - first_t, 6),
            "shed": dict(self.shed_counts),
            "clients": [e.client for e in entries],
        }
        self.history.append(rec)
        if eng.telemetry is not None:
            upd = float(torch.sqrt(sum(((eng.net[k] - old_net[k]) ** 2).sum()
                                       for k in eng.net)))
            q = eng.quarantine.for_round(self.version)
            eng.telemetry.emit_round(
                self.version, clients=[e.client for e in entries],
                metrics={"update_norm": upd,
                         "num_samples": float(nsamp.sum())},
                **{"async": {"k": len(entries), "staleness": stale,
                             "buffer_fill_s": round(t - first_t, 6),
                             "shed": dict(self.shed_counts)}},
                **({"quarantine": q} if q else {}),
                **eng._privacy_extra())
        self.version += 1

    # ------------------------------------------------------------------ run
    def run(self, num_updates: int):
        """Drive the event loop until ``num_updates`` buffered aggregates
        landed; returns the engine's net. ``self.clock`` is the virtual
        wall-clock of the last flush — compare against
        :func:`sync_virtual_wallclock` for the async-beats-sync claim."""
        eng = self.engine
        heap: list = []
        for slot in range(eng.cfg.client_num_per_round):
            self._dispatch(heap, slot, 0.0)
        events_since_flush = 0
        while self.version < num_updates:
            if not heap:
                raise RuntimeError(
                    "async simulator starved: every slot is parked and the "
                    "buffer cannot fill (k > cohort with bound 0?)")
            if events_since_flush > 10_000:
                # no-progress guard: e.g. a rank crashed for the whole run
                # holds the buffer below K forever with no deadline to
                # flush partial — fail loudly instead of spinning
                raise RuntimeError(
                    f"async simulator made no progress over "
                    f"{events_since_flush} events (buffer {len(self.buffer)}"
                    f"/{self.buffer.flush_threshold}, shed "
                    f"{self.shed_counts}) — a dark rank can hold the buffer "
                    "below K forever; lower buffer_k or set deadline_s")
            events_since_flush += 1
            t, _, kind, item = heapq.heappop(heap)
            if kind == "deadline":
                if item["epoch"] == self._epoch and len(self.buffer):
                    self._flush(t)
                    self.clock = t
                    events_since_flush = 0
                    for slot in self._drain_parked():
                        self._dispatch(heap, slot, t)
                continue
            slot = item["slot"]
            if item.get("offline"):
                # scheduled-offline wave: retry at the next wave's cohort
                self._shed("offline")
                self._dispatch(heap, slot, t)
                continue
            if item["dead"]:
                # a crashed rank's dispatch produces nothing; the slot
                # burns the wave and re-dispatches (rejoin after window)
                self._shed("crash")
                self._dispatch(heap, slot, t)
                continue
            staleness = self.version - item["version"]
            if not self.policy.admits(staleness):
                # admission control: reject-and-requeue with a fresh model
                self._drop_from_group(item)
                self._shed("stale")
                self._dispatch(heap, slot, t)
                continue
            net_k, nsamp = self._compute_arrival(item)
            if not self._finite(net_k):
                # quarantine at the door: a non-finite arrival never
                # enters the buffer (the in-buffer gate still covers norm
                # outliers, where the verdict needs the cohort's median)
                from fedml_tpu_torch.obs import comm_instrument as _obs

                eng.quarantine.record(self.version, slot + 1, "nonfinite",
                                      client=item["client"])
                _obs.record_update_rejected("nonfinite")
                self._shed("nonfinite")
                self._dispatch(heap, slot, t)
                continue
            self._seq += 1
            if len(self.buffer) == 0 and self.deadline_s is not None:
                heapq.heappush(heap, (t + self.deadline_s, self._seq,
                                      "deadline", {"epoch": self._epoch}))
                self._seq += 1
            for _victim in self.buffer.add(BufferedUpdate(
                    rank=slot + 1, client=item["client"],
                    version=item["version"], wave=item["wave"],
                    payload=net_k, nsamp=nsamp, seq=self._seq,
                    t_arrival=t)):
                # counting is all a victim needs — its slot already got its
                # park-or-redispatch when the shed entry was consumed
                self._shed("overflow")
            if self.policy.synchronous:
                # bound 0 = the barrier: work dispatched now would be born
                # stale post-flush — park the slot until the flush lands
                self._parked.append(slot)
            else:
                self._dispatch(heap, slot, t)
            if self.buffer.ready:
                self._flush(t)
                self.clock = t
                events_since_flush = 0
                for s in self._drain_parked():
                    self._dispatch(heap, s, t)
        return eng.net

    def _drop_from_group(self, item) -> None:
        """A rejected arrival's fit is never needed: drop its slot from
        its group (fitted already or not)."""
        group = item["group"]
        pending = group["slots"] if group["out"] is None else group["out"]
        if group["out"] is None:
            pending.remove(item["slot"])
        else:
            pending.pop(item["slot"], None)
        if not pending:
            self._groups.pop(group["key"], None)

    def _drain_parked(self) -> list[int]:
        parked, self._parked = self._parked, []
        return parked

    def stats(self) -> dict:
        st = self.staleness_seen
        return {
            "updates": self.version,
            "wallclock": round(self.clock, 6),
            "shed": dict(self.shed_counts),
            "staleness_mean": float(np.mean(st)) if st else 0.0,
            "staleness_max": int(max(st)) if st else 0,
        }
