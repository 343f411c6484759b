"""ChurnTrace / ScenarioPlan — scheduled client availability, declaratively.

Chaos faults (``plan.py``) model the *abnormal*: dropped frames, dead
peers, byzantine uploads. This module models the *normal* state of a real
fleet — most clients are simply not there most of the time (FedJAX
arXiv:2108.02117 and FL_PyTorch arXiv:2202.03099 both treat availability
traces as a first-class experiment axis). A :class:`ChurnTrace` is a
seeded, declarative schedule of **scheduled** unavailability::

    {
      "seed": 7,
      "base": 0.6, "amplitude": 0.35, "period": 24, "tz_spread": 0.5,
      "rounds_per_window": 2,
      "arrival_spread": 8, "departure_rate": 0.001,
      "device_classes": [
        {"name": "phone",  "weight": 0.8, "size_scale": 0.5},
        {"name": "tablet", "weight": 0.2, "size_scale": 2.0}
      ],
      "rank_base": 0.9, "rank_amplitude": 0.1
    }

Per client: a diurnal sine curve (``base`` ± ``amplitude`` over ``period``
windows, phase-shifted per client across ``tz_spread`` of the cycle — the
time-zone picture), an arrival window (staggered over the first
``arrival_spread`` windows) and a geometric permanent-departure window
(per-window hazard ``departure_rate``) — the arrival/dropout point
processes. ``device_classes`` assigns each client a class by weighted
draw; ``size_skew``/``skewed_sizes`` feed the size-bucketed packer so
device heterogeneity shows up as data-size heterogeneity.

Determinism contract (the churn × chaos replay invariant): every draw is
a pure sha256 function of ``(trace seed, stream, entity, window)`` under
the ``"churn|"`` namespace — a stream *independent* of FaultPlan's
``_decide`` (which hashes ``seed|rule|direction|src|dst|seq`` with no
namespace), so composing a trace with a fault plan and an adversary plan
replays bit-for-bit: same seeds ⇒ same availability timeline, same
injected faults, same final model, same quarantine ledger.

Offline vs dead (docs/ROBUSTNESS.md §Fleet campaigns & client churn):
*scheduled-offline* — the trace says the rank is away; the server skips
it silently (no suspect bookkeeping, no reprobe/backoff churn, quorum
denominators shrink). *Suspected-dead* — the trace says it should be
here and it is not; the existing heartbeat/undeliverable machinery fires.

Client availability carries a **min-one floor**: if a window's Bernoulli
draws leave the active population empty, the active client with the
lowest draw is deemed available (deterministic) — a planetary fleet is
never literally empty, and the floor keeps single-process engines live
through troughs. Rank availability has NO floor: an all-offline window
is a legitimate idle round, handled by the watchdog's idle rate-limit.
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np


def _draw(seed: int, stream: str, entity, window: int) -> float:
    """Uniform [0, 1), pure in its arguments. The leading ``churn|`` tag
    keeps this stream disjoint from FaultPlan's ``_decide`` even for
    colliding argument tuples — churn × chaos draws never correlate."""
    key = f"churn|{seed}|{stream}|{entity}|{window}".encode()
    h = hashlib.sha256(key).digest()
    return int.from_bytes(h[:8], "little") / 2.0 ** 64


@dataclass
class DeviceClass:
    """One hardware tier: ``weight`` is the population share (normalized
    over the class list), ``size_scale`` multiplies the client's local
    dataset size for the size-bucketed packer, ``speed_scale`` divides
    its virtual-clock dispatch duration (reserved for duration models)."""

    name: str
    weight: float = 1.0
    size_scale: float = 1.0
    speed_scale: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"device class {self.name!r}: weight must be "
                             f"> 0, got {self.weight}")
        if self.size_scale <= 0 or self.speed_scale <= 0:
            raise ValueError(f"device class {self.name!r}: scales must be "
                             "> 0")


@dataclass
class ChurnTrace:
    """A seeded availability schedule over (client | rank, window).

    ``base``/``amplitude``/``period``/``tz_spread`` shape the diurnal
    curve; ``rounds_per_window`` maps protocol rounds onto trace windows;
    ``arrival_spread``/``departure_rate`` are the point processes;
    ``rank_base``/``rank_amplitude`` (None = always-on) give cross-process
    worker RANKS their own curve on an independent stream — engines
    sample *clients*, the server schedules *ranks*."""

    seed: int = 0
    base: float = 1.0
    amplitude: float = 0.0
    period: int = 24
    rounds_per_window: int = 1
    tz_spread: float = 1.0
    arrival_spread: int = 0
    departure_rate: float = 0.0
    device_classes: list[DeviceClass] = field(default_factory=list)
    rank_base: float | None = None
    rank_amplitude: float | None = None

    def __post_init__(self):
        if not 0.0 <= self.base <= 1.0:
            raise ValueError(f"base must be in [0, 1], got {self.base}")
        if self.amplitude < 0.0:
            raise ValueError(f"amplitude must be >= 0, got {self.amplitude}")
        if self.period < 1:
            raise ValueError(f"period must be >= 1, got {self.period}")
        if self.rounds_per_window < 1:
            raise ValueError("rounds_per_window must be >= 1, got "
                             f"{self.rounds_per_window}")
        if not 0.0 <= self.tz_spread <= 1.0:
            raise ValueError(f"tz_spread must be in [0, 1], got "
                             f"{self.tz_spread}")
        if self.arrival_spread < 0:
            raise ValueError("arrival_spread must be >= 0")
        if not 0.0 <= self.departure_rate < 1.0:
            raise ValueError("departure_rate must be in [0, 1), got "
                             f"{self.departure_rate}")
        if self.rank_base is not None and not 0.0 <= self.rank_base <= 1.0:
            raise ValueError(f"rank_base must be in [0, 1], got "
                             f"{self.rank_base}")
        self.device_classes = [
            c if isinstance(c, DeviceClass) else DeviceClass(**c)
            for c in self.device_classes]

    # ------------------------------------------------------------- windowing
    def window(self, round_idx: int) -> int:
        """The trace window a protocol round (or async wave) falls in."""
        return int(round_idx) // self.rounds_per_window

    # ------------------------------------------------------ client processes
    def arrival_window(self, client: int) -> int:
        if self.arrival_spread <= 0:
            return 0
        return int(_draw(self.seed, "arrive", client, 0)
                   * self.arrival_spread)

    def departure_window(self, client: int) -> int | None:
        """The window this client permanently drops out (None = never) —
        a geometric draw with per-window hazard ``departure_rate``,
        offset past the client's arrival."""
        if self.departure_rate <= 0.0:
            return None
        u = _draw(self.seed, "depart", client, 0)
        life = int(math.log(1.0 - u) / math.log(1.0 - self.departure_rate))
        return self.arrival_window(client) + 1 + life

    def _phase(self, stream: str, entity) -> float:
        return (_draw(self.seed, stream, entity, 0)
                * self.period * self.tz_spread)

    def _curve(self, base: float, amplitude: float, phase: float,
               window: int) -> float:
        p = base + amplitude * math.sin(
            2.0 * math.pi * (window + phase) / self.period)
        return min(1.0, max(0.0, p))

    def availability(self, client: int, window: int) -> float:
        """The curve value p(client, window) in [0, 1] — 0 outside the
        client's [arrival, departure) lifetime."""
        if window < self.arrival_window(client):
            return 0.0
        dep = self.departure_window(client)
        if dep is not None and window >= dep:
            return 0.0
        return self._curve(self.base, self.amplitude,
                           self._phase("phase", client), window)

    def is_available(self, client: int, window: int) -> bool:
        p = self.availability(client, window)
        if p >= 1.0:
            return True
        if p <= 0.0:
            return False
        return _draw(self.seed, "avail", client, window) < p

    def available_clients(self, window: int, n_total: int) -> np.ndarray:
        """Sorted int64 ids available in ``window``, with the min-one
        floor (the lowest-draw active client — or overall, if nobody is
        active — is available even when every Bernoulli draw misses)."""
        avail = [c for c in range(n_total) if self.is_available(c, window)]
        if not avail:
            active = [c for c in range(n_total)
                      if self.availability(c, window) > 0.0] \
                or list(range(n_total))
            avail = [min(active,
                         key=lambda c: _draw(self.seed, "avail", c, window))]
        return np.asarray(avail, np.int64)

    def availability_timeline(self, windows: int, n_total: int) -> list[int]:
        """Available-cohort size per window — the determinism oracle's
        artifact and the docs' curve illustration."""
        return [len(self.available_clients(w, n_total))
                for w in range(windows)]

    # --------------------------------------------------------- rank schedule
    def rank_available(self, rank: int, window: int) -> bool:
        """Scheduled availability of a cross-process worker rank — its own
        ``"rank"`` stream and curve, so the same trace drives engines
        (clients) and the server (ranks) without draw coupling. Rank 0 is
        the server: always on (its failures are chaos, not churn)."""
        if rank == 0 or self.rank_base is None:
            return True
        amp = self.rank_amplitude if self.rank_amplitude is not None else 0.0
        p = self._curve(self.rank_base, amp,
                        self._phase("rank_phase", rank), window)
        if p >= 1.0:
            return True
        if p <= 0.0:
            return False
        return _draw(self.seed, "rank", rank, window) < p

    def scheduled_offline_ranks(self, round_idx: int,
                                world_size: int) -> set[int]:
        """Ranks 1..world_size-1 the trace marks away for this round's
        window — the set every server-side skip/admission path consults."""
        w = self.window(round_idx)
        return {r for r in range(1, world_size)
                if not self.rank_available(r, w)}

    # -------------------------------------------------------- device classes
    def device_class(self, client: int) -> DeviceClass | None:
        if not self.device_classes:
            return None
        total = sum(c.weight for c in self.device_classes)
        u = _draw(self.seed, "class", client, 0) * total
        acc = 0.0
        for c in self.device_classes:
            acc += c.weight
            if u < acc:
                return c
        return self.device_classes[-1]

    def size_skew(self, n_total: int) -> np.ndarray:
        """Per-client dataset-size multipliers (all-ones without classes)
        — the device-class skew the size-bucketed packer consumes."""
        if not self.device_classes:
            return np.ones(n_total, np.float64)
        return np.asarray([self.device_class(c).size_scale
                           for c in range(n_total)], np.float64)

    def skewed_sizes(self, base_sizes) -> np.ndarray:
        """Apply the class skew to a base per-client size vector, floored
        at 1 sample (a device class never empties a client)."""
        base = np.asarray(base_sizes, np.float64)
        scaled = base * self.size_skew(len(base))
        return np.maximum(1, np.round(scaled)).astype(np.int64)

    # --------------------------------------------------------- serialization
    @classmethod
    def from_json(cls, spec: str | dict[str, Any]) -> "ChurnTrace":
        doc = json.loads(spec) if isinstance(spec, str) else dict(spec)
        classes = [DeviceClass(**c) for c in doc.pop("device_classes", [])]
        return cls(device_classes=classes, **doc)

    @classmethod
    def from_file(cls, path: str) -> "ChurnTrace":
        with open(path) as f:
            return cls.from_json(json.load(f))

    @classmethod
    def from_spec(cls, spec: str) -> "ChurnTrace":
        """The CLI dual form — a JSON file path or inline JSON (the same
        dispatch rule --chaos-plan uses)."""
        import os

        return cls.from_file(spec) if os.path.exists(spec) \
            else cls.from_json(spec)

    def to_json(self) -> str:
        doc: dict[str, Any] = {"seed": self.seed}
        defaults = ChurnTrace()
        for k in ("base", "amplitude", "period", "rounds_per_window",
                  "tz_spread", "arrival_spread", "departure_rate",
                  "rank_base", "rank_amplitude"):
            v = getattr(self, k)
            if v != getattr(defaults, k):
                doc[k] = v
        if self.device_classes:
            doc["device_classes"] = [
                {"name": c.name, "weight": c.weight,
                 "size_scale": c.size_scale, "speed_scale": c.speed_scale}
                for c in self.device_classes]
        return json.dumps(doc)


@dataclass
class ScenarioPlan:
    """One named campaign scenario: a churn trace × a fault plan × an
    adversary plan, serialized as a single committed document — the unit
    ``scripts/fleet_campaign.py`` profiles carry and replay. Each member
    keeps its own independent seed stream, so the composition replays
    bit-for-bit whenever each member does."""

    name: str = ""
    churn: ChurnTrace | None = None
    faults: Any = None        # chaos.plan.FaultPlan
    adversary: Any = None     # chaos.adversary.AdversaryPlan
    meta: dict = field(default_factory=dict)

    @classmethod
    def from_json(cls, spec: str | dict[str, Any]) -> "ScenarioPlan":
        from fedml_tpu_torch.chaos.adversary import AdversaryPlan
        from fedml_tpu_torch.chaos.plan import FaultPlan

        doc = json.loads(spec) if isinstance(spec, str) else spec
        return cls(
            name=str(doc.get("name", "")),
            churn=(ChurnTrace.from_json(doc["churn"])
                   if doc.get("churn") else None),
            faults=(FaultPlan.from_json(doc["faults"])
                    if doc.get("faults") else None),
            adversary=(AdversaryPlan.from_json(doc["adversary"])
                       if doc.get("adversary") else None),
            meta=dict(doc.get("meta", {})))

    @classmethod
    def from_file(cls, path: str) -> "ScenarioPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    @classmethod
    def from_spec(cls, spec: str) -> "ScenarioPlan":
        import os

        return cls.from_file(spec) if os.path.exists(spec) \
            else cls.from_json(spec)

    def to_json(self) -> str:
        doc: dict[str, Any] = {}
        if self.name:
            doc["name"] = self.name
        if self.churn is not None:
            doc["churn"] = json.loads(self.churn.to_json())
        if self.faults is not None:
            doc["faults"] = json.loads(self.faults.to_json())
        if self.adversary is not None:
            doc["adversary"] = json.loads(self.adversary.to_json())
        if self.meta:
            doc["meta"] = self.meta
        return json.dumps(doc)

    def fresh(self) -> "ScenarioPlan":
        """Same scenario, fresh fault ledger — the replay idiom."""
        return ScenarioPlan(
            name=self.name, churn=self.churn,
            faults=self.faults.fresh() if self.faults is not None else None,
            adversary=self.adversary, meta=dict(self.meta))
