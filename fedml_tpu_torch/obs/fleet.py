"""Fleet observability plane — in-band telemetry rollup to one pane of glass.

Every signal the obs stack exports is **per-rank**: ``--metrics_port``
binds PORT+rank per process, so "watch the fleet" meant scraping hundreds
of ports. This module folds the fleet back into rank 0 the same way
tracing does (obs/tracing.py): each client/edge rank periodically packs a
compact **digest** — round/wave progress, counter deltas for the
``fed_``/``comm_`` families, a p50/p95/p99 sketch of its local phase
timings, ε when known, host-RSS/device bytes — into a ``__telemetry``
blob piggybacked on the uplink frames it already sends. Stock peers
ignore the key; with the plane off no frame carries it (wire
byte-identical, test-enforced).

Rank 0's :class:`FleetCollector` merges digests into a rank-labeled fleet
registry served as ``/fleetz`` (obs/httpd.py — aggregated JSON: per-rank
liveness/round/staleness/bytes/ε, fleet rollups, status) and federates
O(1) rollup gauges into ``/metrics``:

    fed_fleet_digests_total{run,job}                 digests ingested
    fed_fleet_ranks_reporting{run,job}               distinct ranks seen
    fed_fleet_round_min{run,job} / _round_max        progress spread
    fed_fleet_digest_staleness_max_seconds{run,job}  oldest rank's silence
    fed_fleet_epsilon_max{run,job}                   worst reported ε

Per-rank detail deliberately stays in the ``/fleetz`` JSON, never as
per-rank metric children — the export must not grow O(world_size) lines
(the same cardinality rule the heartbeat gauges follow above their cap).
``run`` and the reserved ``job`` label namespace the rollups per run so
the multi-tenant scheduler inherits the plane instead of rebuilding it.

Enablement is in-band and zero-config on clients, exactly like
``__trace``: the server attaches a marker to its broadcast frames when
``Telemetry(fleet=True)`` armed a collector; a client that sees the
marker lazily creates a :class:`DigestEmitter` and starts piggybacking.
In a 2-tier topology the edge collects its block's digests and forwards
ONE folded blob on its partial frame, so root ingress stays O(edges).

Byte budget: a digest is a few hundred bytes of JSON header scalars.
Every attach is accounted under ``comm_bytes_total{codec=json,
direction=telemetry}`` — a direction ``directional_bytes()`` deliberately
excludes, so round records' uplink/downlink fields stay clean — and tests
assert the per-rank-per-round average stays ≤ ``DIGEST_BYTE_BUDGET``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque

from fedml_tpu_torch.obs.comm_instrument import record_wire_bytes
from fedml_tpu_torch.obs.flightrec import flight_record
from fedml_tpu_torch.obs.memwatch import device_memory_stats, host_rss_bytes
from fedml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

# The in-band digest key — a JSON-header scalar on existing frames, like
# tracing's ``__trace``. MyMessage.MSG_ARG_KEY_TELEMETRY mirrors this
# constant (test-pinned equal): the protocol vocabulary lives in
# message_define, the obs layer owns the semantics.
TELEMETRY_KEY = "__telemetry"

# Documented per-rank per-round digest byte budget (docs/OBSERVABILITY.md
# §Fleet rollup): asserted from comm_bytes_total{direction=telemetry} in
# tests — a digest that outgrows this is a schema regression, not tuning.
DIGEST_BYTE_BUDGET = 1024

# counter vocabulary a digest's ``ctr`` block carries (deltas since the
# rank's previous digest) — the flat comm_counters() names
_CTR_KEYS = ("messages_sent", "bytes_sent", "messages_received",
             "bytes_received", "bytes_uplink", "bytes_downlink")

# a rank silent longer than this is marked stale in /fleetz (and drives
# the fleet_staleness health rule via the staleness-max rollup gauge)
DEFAULT_STALE_AFTER_S = 60.0


def _quantiles(samples) -> list[float]:
    """[p50, p95, p99] of a small sample list (exact-by-sort: the per-rank
    reservoir is bounded, so sorting is cheap)."""
    s = sorted(samples)
    n = len(s)
    out = []
    for q in (0.50, 0.95, 0.99):
        out.append(round(s[min(int(q * (n - 1) + 0.5), n - 1)], 6))
    return out


class DigestEmitter:
    """A client/edge rank's digest builder — created lazily the first time
    a broadcast carries the fleet marker (zero client-side config, the
    ``ClientSpanBuffer`` pattern). ``phase()`` times local phases into a
    bounded reservoir; ``digest()`` packs the blob one uplink carries."""

    def __init__(self, rank: int, run_id: str | None = None,
                 registry: MetricsRegistry | None = None,
                 max_phase_samples: int = 64, clock=time.perf_counter):
        self.rank = int(rank)
        self.run_id = run_id
        self.registry = registry or REGISTRY
        self._clock = clock
        self._phases: dict[str, deque] = {}
        self._max_samples = int(max_phase_samples)
        self._last_ctr: dict[str, float] = {}
        # duty-cycle accounting (docs/PERFORMANCE.md §Round economics):
        # phase() accumulates busy seconds; digest() divides by the
        # inter-digest interval — one float per digest, well inside the
        # byte budget
        self._busy = 0.0
        self._last_digest_t: float | None = None
        # scheduled availability (chaos/churn.py): adopted from a churn-
        # armed server's broadcast marker, echoed on each digest so the
        # fleet view's ``avail`` column reads straight off the rank rows.
        # None = no trace anywhere = the blob is byte-identical to pre-
        # churn digests (fedtop renders '-')
        self._avail: float | None = None
        self._lock = threading.Lock()

    def on_downlink(self, marker: dict) -> None:
        """Adopt the server's run identity from the broadcast marker (the
        digest must label itself with the SERVER's run id — a client
        process has no Telemetry bundle of its own)."""
        run = marker.get("run")
        if run:
            self.run_id = str(run)
        av = marker.get("avail")
        if av is not None:
            self._avail = float(av)

    # ---------------------------------------------------------- phase timing
    class _Phase:
        __slots__ = ("_em", "_name", "_t0")

        def __init__(self, em, name):
            self._em, self._name = em, name

        def __enter__(self):
            self._t0 = self._em._clock()
            return self

        def __exit__(self, *exc):
            dt = self._em._clock() - self._t0
            with self._em._lock:
                buf = self._em._phases.get(self._name)
                if buf is None:
                    buf = deque(maxlen=self._em._max_samples)
                    self._em._phases[self._name] = buf
                buf.append(dt)
                self._em._busy += dt
            return False

    def phase(self, name: str):
        """Context manager timing one local phase (unpack/local_fit/pack)
        into the quantile reservoir — independent of tracing, so the fleet
        view works on untraced runs."""
        return self._Phase(self, name)

    # --------------------------------------------------------------- the blob
    def digest(self, round_idx: int, wave=None, eps=None,
               gflops=None, avail=None) -> dict:
        """The compact uplink blob: round/wave progress, comm counter
        deltas since this rank's previous digest, per-phase [p50,p95,p99],
        duty cycle (phase-busy seconds over the inter-digest interval),
        GFLOPs/s when the caller knows one, ε when the caller knows one,
        and host/device memory. Also drops a ``digest`` record into the
        flight ring — in a crash timeline these are the 'what was this
        rank doing' breadcrumbs."""
        from fedml_tpu_torch.obs.comm_instrument import comm_counters

        now = comm_counters(self.registry)
        t = self._clock()
        with self._lock:
            ctr = {k: int(now.get(k, 0.0) - self._last_ctr.get(k, 0.0))
                   for k in _CTR_KEYS}
            self._last_ctr = {k: now.get(k, 0.0) for k in _CTR_KEYS}
            spans = {name: _quantiles(buf)
                     for name, buf in self._phases.items() if buf}
            interval = (t - self._last_digest_t
                        if self._last_digest_t is not None else None)
            busy, self._busy = self._busy, 0.0
            self._last_digest_t = t
        duty = (min(busy / interval, 1.0)
                if interval and interval > 0 else None)
        blob: dict = {"rank": self.rank, "round": int(round_idx)}
        if duty is not None:
            blob["duty"] = round(duty, 3)
        if gflops is not None:
            blob["gf"] = round(float(gflops), 3)
        if self.run_id:
            blob["run"] = self.run_id
        if wave is not None:
            blob["wave"] = int(wave)
        if any(ctr.values()):
            blob["ctr"] = {k: v for k, v in ctr.items() if v}
        if spans:
            blob["spans"] = spans
        if eps is not None:
            blob["eps"] = round(float(eps), 6)
        if avail is None:
            avail = self._avail  # the marker-adopted value, if any
        if avail is not None:
            blob["avail"] = round(float(avail), 3)
        rss = host_rss_bytes()
        if rss is not None:
            blob["rss"] = int(rss)
        devs = device_memory_stats()
        if devs:
            blob["dev"] = int(sum(st["bytes_in_use"] for st in devs.values()))
        flight_record("digest", rank=self.rank, round=int(round_idx),
                      wave=None if wave is None else int(wave))
        return blob


def attach_digest(msg, blob: dict) -> None:
    """Attach a digest (or an edge's folded blob) to an outgoing frame and
    account its serialized size under ``comm_bytes_total{codec=json,
    direction=telemetry}`` — the measured half of the byte-budget claim.
    The direction is deliberately NOT uplink: ``directional_bytes()``
    ignores it, so round records' wire fields never include plane
    overhead."""
    record_wire_bytes("json", "telemetry",
                      len(json.dumps(blob, default=float).encode()))
    msg.add_params(TELEMETRY_KEY, blob)


class FleetCollector:
    """Rank 0's fleet registry: ingests digests (flat uploads and edges'
    folded blobs), serves the ``/fleetz`` JSON, and federates O(1) rollup
    gauges into the metrics registry. All methods are thread-safe (the
    comm dispatch loop ingests while scrapes snapshot)."""

    def __init__(self, run_id: str | None = None, job: str = "",
                 registry: MetricsRegistry | None = None,
                 expected_ranks: int | None = None,
                 stale_after_s: float = DEFAULT_STALE_AFTER_S,
                 clock=time.time, health=None):
        self.run_id = run_id
        self.job = str(job)
        self.registry = registry or REGISTRY
        self.expected_ranks = expected_ranks
        self.stale_after_s = float(stale_after_s)
        self.health = health
        self._clock = clock
        self._lock = threading.Lock()
        # rank -> {digest fields + seen_ts + cumulative byte tallies}
        self._ranks: dict[int, dict] = {}
        self._digests = 0
        # pre-register the rollup families at zero so a clean fleet run's
        # export reads 'nothing reported yet', not 'metric missing'
        for name in ("fed_fleet_digests_total",):
            self._counter(name)
        for name in ("fed_fleet_ranks_reporting", "fed_fleet_round_min",
                     "fed_fleet_round_max", "fed_fleet_epsilon_max",
                     "fed_fleet_digest_staleness_max_seconds"):
            self._gauge(name)

    def _labels(self) -> dict:
        # per-run namespacing + the reserved multi-tenant ``job`` label
        return {"run": self.run_id or "", "job": self.job}

    def _gauge(self, name: str):
        # families are literal at the pre-registration site above — this
        # helper only folds in the run/job labels
        return self.registry.gauge(name, **self._labels())  # fedlint: disable=metric-discipline

    def _counter(self, name: str):
        return self.registry.counter(name, **self._labels())  # fedlint: disable=metric-discipline

    # ----------------------------------------------------------------- marker
    def marker(self) -> dict:
        """The s2c enablement marker (attached next to the ``__trace``
        context when the plane is armed): tells every downstream rank to
        start digesting, and under which run identity."""
        m = {"run": self.run_id or ""}
        if self.job:
            m["job"] = self.job
        return m

    # ----------------------------------------------------------------- ingest
    def ingest(self, blob) -> None:
        """Fold one inbound ``__telemetry`` blob in. An edge's folded blob
        carries its block's digests under ``block`` — each child lands as
        its own rank row, then the edge's own digest, so the per-rank view
        is tier-agnostic while root ingress stays O(edges) frames."""
        if not isinstance(blob, dict):
            return
        for child in blob.get("block", ()):
            if isinstance(child, dict):
                self._ingest_one(child)
        self._ingest_one({k: v for k, v in blob.items() if k != "block"})
        self.refresh()

    def _ingest_one(self, d: dict) -> None:
        try:
            rank = int(d["rank"])
        except (KeyError, TypeError, ValueError):
            return  # a blob with no rank identity is unplaceable
        now = self._clock()
        with self._lock:
            row = self._ranks.setdefault(rank, {"bytes_uplink": 0,
                                                "bytes_downlink": 0})
            ctr = d.get("ctr") or {}
            row["bytes_uplink"] += int(ctr.get("bytes_uplink", 0))
            row["bytes_downlink"] += int(ctr.get("bytes_downlink", 0))
            for k in ("round", "wave", "eps", "rss", "dev", "spans", "run",
                      "duty", "gf", "avail"):
                if d.get(k) is not None:
                    row[k] = d[k]
            row["seen_ts"] = now
            self._digests += 1
        self._counter("fed_fleet_digests_total").inc()
        flight_record("fleet_ingest", rank=rank, round=d.get("round"))

    def note_avail(self, offline: set, world_size: int) -> None:
        """Server-side availability stamp (chaos/churn.py): a scheduled-
        offline rank sends no digests while away, so its row would keep
        the last avail it echoed — rank 0, which owns the trace, overrides
        the column on EXISTING rows (never creates one: a phantom row
        would inflate ``fed_fleet_ranks_reporting`` and skew the
        fleet-quorum denominator)."""
        with self._lock:
            for rank, row in self._ranks.items():
                if 0 < rank < world_size:
                    row["avail"] = 0.0 if rank in offline else 1.0

    def note_server(self, round_idx: int, eps=None, duty=None,
                    gflops=None) -> None:
        """Rank 0's own row — fed from ``Telemetry.emit_round`` (every
        engine that emits round records updates the server line, including
        its ε and round-economics figures, without a wire hop)."""
        now = self._clock()
        with self._lock:
            row = self._ranks.setdefault(0, {"bytes_uplink": 0,
                                             "bytes_downlink": 0})
            row["round"] = int(round_idx)
            if eps is not None:
                row["eps"] = round(float(eps), 6)
            if duty is not None:
                row["duty"] = round(float(duty), 3)
            if gflops is not None:
                row["gf"] = round(float(gflops), 3)
            rss = host_rss_bytes()
            if rss is not None:
                row["rss"] = int(rss)
            row["seen_ts"] = now
        self.refresh()

    # ---------------------------------------------------------------- rollups
    def refresh(self) -> None:
        """Recompute the O(1) rollup gauges (staleness grows between
        digests, so exporters refresh right before reading — the
        ``refresh_liveness`` discipline)."""
        now = self._clock()
        with self._lock:
            rows = list(self._ranks.values())
        if not rows:
            return
        rounds = [int(r["round"]) for r in rows if r.get("round") is not None]
        epss = [float(r["eps"]) for r in rows if r.get("eps") is not None]
        stale = [max(0.0, now - r["seen_ts"]) for r in rows
                 if r.get("seen_ts")]
        self._gauge("fed_fleet_ranks_reporting").set(len(rows))
        if rounds:
            self._gauge("fed_fleet_round_min").set(min(rounds))
            self._gauge("fed_fleet_round_max").set(max(rounds))
        if epss:
            self._gauge("fed_fleet_epsilon_max").set(max(epss))
        if stale:
            self._gauge("fed_fleet_digest_staleness_max_seconds").set(
                round(max(stale), 3))

    # ----------------------------------------------------------------- fleetz
    def snapshot(self) -> dict:
        """The ``/fleetz`` body: per-rank rows (liveness, round/wave,
        cumulative wire bytes, ε, memory, phase sketch), fleet rollups,
        and the overall status — ``waiting`` (no digest yet) | ``ok`` |
        ``degraded`` (some rank stale past ``stale_after_s``)."""
        self.refresh()
        now = self._clock()
        with self._lock:
            ranks = {r: dict(row) for r, row in self._ranks.items()}
            digests = self._digests
        out_ranks: dict[str, dict] = {}
        any_stale = False
        for r in sorted(ranks):
            row = ranks[r]
            staleness = (round(max(0.0, now - row["seen_ts"]), 3)
                         if row.get("seen_ts") else None)
            stale = staleness is not None and staleness > self.stale_after_s
            any_stale = any_stale or stale
            out_ranks[str(r)] = {
                "round": row.get("round"),
                "wave": row.get("wave"),
                "staleness_s": staleness,
                "bytes_uplink": row.get("bytes_uplink", 0),
                "bytes_downlink": row.get("bytes_downlink", 0),
                "eps": row.get("eps"),
                "rss_bytes": row.get("rss"),
                "device_bytes": row.get("dev"),
                "spans": row.get("spans"),
                "duty": row.get("duty"),
                "gflops": row.get("gf"),
                "avail": row.get("avail"),
                "status": "stale" if stale else "ok",
            }
        rounds = [v["round"] for v in out_ranks.values()
                  if v["round"] is not None]
        status = ("waiting" if not out_ranks
                  else "degraded" if any_stale else "ok")
        alerts = []
        if self.health is not None:
            try:
                alerts = self.health.snapshot().get("alerts", [])
            except Exception:  # noqa: BLE001 — /fleetz must answer anyway
                logging.getLogger("fedml_tpu_torch.obs.fleet").warning(
                    "health snapshot failed during /fleetz render",
                    exc_info=True)
                alerts = []
        return {
            "run": self.run_id,
            "job": self.job or None,
            "status": status,
            "expected_ranks": self.expected_ranks,
            "ranks_reporting": len(out_ranks),
            "digests_total": digests,
            "ranks": out_ranks,
            "rollup": {
                "round_min": min(rounds) if rounds else None,
                "round_max": max(rounds) if rounds else None,
                "staleness_max_s": max(
                    (v["staleness_s"] for v in out_ranks.values()
                     if v["staleness_s"] is not None), default=None),
                "eps_max": max((v["eps"] for v in out_ranks.values()
                                if v["eps"] is not None), default=None),
                "bytes_uplink": sum(v["bytes_uplink"]
                                    for v in out_ranks.values()),
                "bytes_downlink": sum(v["bytes_downlink"]
                                      for v in out_ranks.values()),
            },
            "alerts": alerts,
        }
