"""Run-health monitor — a declarative rule table over the live run.

FL_PyTorch (arXiv:2202.03099) and FedJAX (arXiv:2108.02117) both treat
live experiment tracking as a first-class simulator capability; here the
live view is a ``HealthMonitor`` evaluating a JSON-loadable rule table
against the metrics registry and the stream of round/eval records, firing
**edge-triggered, deduplicated** alerts:

    rule            fires when
    ------------    ------------------------------------------------------
    convergence     the training/eval loss goes non-finite, or the last
                    ``evals_rising`` consecutive evals strictly rose
    slowdown        p50 round time over the last ``recent`` rounds exceeds
                    ``factor`` x the p50 of the trailing ``window`` rounds
    quarantine      gate/robust-aggregator rejections per round (averaged
                    over ``window`` rounds) exceed ``max_per_round``
    shed            async admission/backpressure sheds per round exceed
                    ``max_per_round`` (same windowing)
    quorum          ``fed_ranks_alive`` dropped below ``min_fraction`` of
                    the expected cohort (elastic undeliverable / crashed
                    ranks) — resolves when a reprobe brings them back
    device_memory   any device's ``bytes_in_use`` exceeds ``max_fraction``
                    of its ``bytes_limit`` (needs obs/memwatch gauges; a
                    backend without allocator stats never fires)
    stall           no round/eval progress for ``after_s`` seconds

An alert *fires* once when its condition transitions false->true and
*resolves* once on the way back — never once per round while the
condition persists. Each transition is a structured ``alert`` event in
the run's EventLog (rendered by ``scripts/report.py --alerts``) and a
``fed_alerts_total{rule,severity}`` increment (fired transitions only);
the active set + status ride ``/healthz`` (obs/httpd.py):

    status = stalled   (no progress past the stall threshold)
           | degraded  (any alert currently active)
           | ok

The rule table is data, not code: pass a list of dicts, a JSON string, or
a path to ``Telemetry(health_rules=...)`` / ``rules_from_json`` —
``DEFAULT_RULES`` documents the schema and default thresholds
(docs/OBSERVABILITY.md §Health rules).
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time

from fedml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("fedml_tpu_torch.obs.health")

# The default rule table — the documented schema. Every entry needs
# ``rule`` (one of the kinds above) and ``severity`` (free-form label,
# conventionally warning|critical); the rest are per-rule thresholds.
DEFAULT_RULES: list[dict] = [
    {"rule": "convergence", "severity": "critical", "evals_rising": 3},
    {"rule": "slowdown", "severity": "warning",
     "window": 20, "recent": 5, "factor": 2.0},
    {"rule": "quarantine", "severity": "warning",
     "window": 5, "max_per_round": 2.0},
    {"rule": "shed", "severity": "warning",
     "window": 5, "max_per_round": 4.0},
    {"rule": "quorum", "severity": "critical", "min_fraction": 1.0},
    {"rule": "device_memory", "severity": "critical", "max_fraction": 0.92},
    {"rule": "stall", "severity": "critical", "after_s": 300.0},
    # privacy-budget ledger (docs/ROBUSTNESS.md §Privacy ledger): fires
    # once when the DP accountant's cumulative ε crosses the budget. Not
    # evaluable (never fires) on runs without a ``privacy`` block on
    # their round records; override max_epsilon per deployment.
    {"rule": "privacy_budget", "severity": "warning", "max_epsilon": 10.0},
    # server crash recovery (docs/ROBUSTNESS.md §Server crash recovery):
    # fires when the supervised server has restarted more than
    # max_restarts times — a crash LOOP (bad checkpoint, poisoned WAL,
    # deterministic fault) that supervision alone would retry forever.
    # Not evaluable on runs that never restart (family absent or zero).
    {"rule": "restart_storm", "severity": "critical", "max_restarts": 3.0},
    # fleet observability plane (docs/OBSERVABILITY.md §Fleet rollup) —
    # the quorum/staleness rules evaluated over the FLEET view (in-band
    # digests) instead of the transport's heartbeat gauges. Only
    # evaluable once at least one digest arrived (fed_fleet_digests_total
    # > 0), so a plane-off or just-booted run never false-fires.
    # fleet_quorum: reporting ranks dropped below min_fraction of the
    # expected cohort (+1 because rank 0's own row always reports).
    # Additionally gated on the fleet reaching round 1 — during round 0
    # ramp-up "reporting < expected" is boot order, not an outage.
    {"rule": "fleet_quorum", "severity": "critical", "min_fraction": 1.0},
    # fleet_staleness: the oldest rank's digest silence exceeded max_age_s
    # — a rank that stopped uploading (wedged, partitioned, crashed)
    # while the rest of the fleet rounds on.
    {"rule": "fleet_staleness", "severity": "warning", "max_age_s": 120.0},
]

_KNOWN_RULES = {r["rule"] for r in DEFAULT_RULES}


def rules_from_json(spec) -> list[dict]:
    """Normalize a rule-table spec: a list of rule dicts passes through, a
    string is inline JSON or a path to a JSON file (a typo'd path fails as
    file-not-found, not 'Expecting value'). Unknown rule kinds are loud —
    a misspelled rule silently never firing is the failure mode this
    layer exists to prevent."""
    if isinstance(spec, (list, tuple)):
        rules = [dict(r) for r in spec]
    else:
        text = spec
        if os.path.exists(spec):
            with open(spec) as f:
                text = f.read()
        elif not spec.lstrip().startswith("["):
            raise FileNotFoundError(f"health rule file not found: {spec!r}")
        rules = json.loads(text)
    for r in rules:
        kind = r.get("rule")
        if kind not in _KNOWN_RULES:
            raise ValueError(f"unknown health rule {kind!r} "
                             f"(known: {sorted(_KNOWN_RULES)})")
        r.setdefault("severity", "warning")
    return rules


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class HealthMonitor:
    """Evaluates the rule table at every round/eval record (the engines'
    per-round hook rides ``Telemetry.emit_round``) and, when ``start()``
    is armed, from a background thread between records — a fully stalled
    run emits no records, so only the thread can say so."""

    def __init__(self, telemetry=None, rules=None,
                 registry: MetricsRegistry | None = None,
                 expected_ranks: int | None = None, clock=time.time):
        self.telemetry = telemetry
        self.registry = registry or REGISTRY
        self.rules = rules_from_json(rules if rules is not None
                                     else DEFAULT_RULES)
        # cohort size the quorum rule measures against; set explicitly or
        # inferred from the run header's world_size (Telemetry.run_header)
        self.expected_ranks = expected_ranks
        self._clock = clock
        self._lock = threading.RLock()
        self.round_idx: int | None = None
        self._start_t = clock()
        self._progress_t = clock()
        # trailing windows (bounded by the largest rule window)
        max_win = max([r.get("window", 0) + r.get("recent", 0)
                       for r in self.rules] + [8])
        self._max_win = max_win
        self._round_times: list[float] = []
        self._last_round_ts: float | None = None
        self._eval_losses: list[float] = []
        self._nonfinite_seen = False
        self._quar_per_round: list[float] = []
        self._shed_per_round: list[float] = []
        # cumulative DP ε from the newest round record's privacy block
        # (None = not a DP run; the privacy_budget rule stays quiet)
        self._privacy_eps: float | None = None
        # worst per-client ε (docs/ROBUSTNESS.md §Hierarchical secure
        # aggregation: per-client ledger) — None until a round record
        # carries the client-granular summary
        self._privacy_eps_client: float | None = None
        self._last_quar = self.registry.total("fed_updates_rejected_total")
        self._last_shed = self.registry.total("fed_async_shed_total")
        # edge-trigger state + the full fired/resolved ledger
        self._active: dict[str, dict] = {}
        self.alerts: list[dict] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # pre-register the configured alert children at zero so a clean
        # run's export reads 'no alerts', not 'metric missing'
        for r in self.rules:
            self.registry.counter("fed_alerts_total", rule=r["rule"],
                                  severity=r["severity"])

    # -------------------------------------------------------------- intake
    def on_round(self, rec: dict) -> None:
        """One round record (any engine: standalone, pipelined drain, sync
        server, async flush). Updates the trailing windows and runs a
        check — the per-round health hook."""
        now = self._clock()
        with self._lock:
            self._progress_t = now
            if rec.get("round") is not None:
                self.round_idx = int(rec["round"])
            # round duration: the engine's host 'round' span when present
            # (standalone), else the inter-record timestamp delta (the
            # cross-process managers time aggregate/eval, not the wire
            # wait that a straggler actually stretches)
            span = (rec.get("spans") or {}).get("round")
            ts = rec.get("ts")
            if span is not None and span > 0:
                self._push(self._round_times, float(span))
            elif isinstance(ts, (int, float)):
                if self._last_round_ts is not None and ts > self._last_round_ts:
                    self._push(self._round_times, float(ts - self._last_round_ts))
                self._last_round_ts = float(ts)
            for v in (rec.get("metrics") or {}).values():
                if isinstance(v, float) and not math.isfinite(v):
                    self._nonfinite_seen = True
            eps = (rec.get("privacy") or {}).get("eps")
            if isinstance(eps, (int, float)):
                self._privacy_eps = float(eps)
            eps_cli = (rec.get("privacy") or {}).get("eps_client_max")
            if isinstance(eps_cli, (int, float)):
                self._privacy_eps_client = float(eps_cli)
            if rec.get("eval"):
                self._fold_eval(rec["eval"])
            # per-round quarantine/shed movement from the registry totals
            # (uniform across engines; the record's quarantine list only
            # exists on engines that carry a ledger)
            quar = self.registry.total("fed_updates_rejected_total")
            shed = self.registry.total("fed_async_shed_total")
            self._push(self._quar_per_round, max(0.0, quar - self._last_quar))
            self._push(self._shed_per_round, max(0.0, shed - self._last_shed))
            self._last_quar, self._last_shed = quar, shed
        self.check()

    def on_eval(self, rec: dict) -> None:
        with self._lock:
            self._progress_t = self._clock()
            if rec.get("round") is not None:
                self.round_idx = int(rec["round"])
            self._fold_eval(rec.get("eval") or rec)
        self.check()

    def _fold_eval(self, ev: dict) -> None:
        """Caller holds the lock. Track the loss the convergence rule
        watches (test loss when evaluated, else train loss)."""
        loss = None
        for key in ("test_loss", "train_loss", "loss"):
            if isinstance(ev.get(key), (int, float)):
                loss = float(ev[key])
                break
        if loss is None:
            return
        if not math.isfinite(loss):
            self._nonfinite_seen = True
        self._push(self._eval_losses, loss)

    def _push(self, buf: list[float], v: float) -> None:
        buf.append(v)
        del buf[:-self._max_win]

    # ---------------------------------------------------------------- rules
    def _eval_rule(self, rule: dict, snap: dict):
        """-> (firing, value, threshold) or None when not evaluable yet.
        ``snap`` is the ONE registry snapshot this check() took — the
        gauge-reading rules must not each re-copy every family on the
        per-round hot path. Caller holds the lock."""
        kind = rule["rule"]
        if kind == "convergence":
            n = int(rule.get("evals_rising", 3))
            if self._nonfinite_seen:
                return True, float("nan"), 0.0
            if len(self._eval_losses) < n + 1:
                return None
            tail = self._eval_losses[-(n + 1):]
            rising = all(b > a for a, b in zip(tail, tail[1:]))
            return rising, tail[-1], tail[0]
        if kind == "slowdown":
            recent = int(rule.get("recent", 5))
            window = int(rule.get("window", 20))
            factor = float(rule.get("factor", 2.0))
            times = self._round_times[-(window + recent):]
            base = times[:-recent]
            if len(base) < max(2, window // 4) or len(times) < recent + 2:
                return None
            p50_recent = _median(times[-recent:])
            thresh = factor * _median(base)
            return p50_recent > thresh, p50_recent, thresh
        if kind in ("quarantine", "shed"):
            window = int(rule.get("window", 5))
            buf = (self._quar_per_round if kind == "quarantine"
                   else self._shed_per_round)[-window:]
            if not buf:
                return None
            rate = sum(buf) / len(buf)
            thresh = float(rule.get("max_per_round", 2.0))
            return rate > thresh, rate, thresh
        if kind == "quorum":
            if self.expected_ranks is None or "fed_ranks_alive" not in snap:
                return None
            alive = float(sum(snap["fed_ranks_alive"].values()))
            # churn-aware denominator: ranks the trace scheduled offline
            # (chaos/churn.py) come out of BOTH sides — the server's alive
            # gauge already subtracts them, and here they shrink the
            # expected cohort — so a diurnal trough reads alive == thresh
            # (no fire) while one genuine crash inside the available set
            # still reads alive < thresh (fires once, edge-triggered).
            off = float(sum(
                snap.get("fed_ranks_scheduled_offline", {}).values()))
            expected = max(0.0, self.expected_ranks - off)
            thresh = float(rule.get("min_fraction", 1.0)) * expected
            return alive < thresh, alive, thresh
        if kind == "device_memory":
            in_use = snap.get("fed_device_bytes_in_use", {})
            limits = snap.get("fed_device_bytes_limit", {})
            fracs = [in_use[k] / limits[k] for k in in_use
                     if limits.get(k)]
            if not fracs:
                return None
            thresh = float(rule.get("max_fraction", 0.92))
            worst = max(fracs)
            return worst > thresh, worst, thresh
        if kind == "stall":
            age = self._clock() - self._progress_t
            thresh = float(rule.get("after_s", 300.0))
            return age > thresh, age, thresh
        if kind == "privacy_budget":
            if self._privacy_eps is None:
                return None  # not a DP run (no privacy block seen)
            thresh = float(rule.get("max_epsilon", 10.0))
            return self._privacy_eps > thresh, self._privacy_eps, thresh
        if kind == "restart_storm":
            fam = snap.get("fed_server_restarts_total")
            if not fam:
                return None  # WAL never armed / no restart yet
            restarts = float(sum(fam.values()))
            if restarts <= 0:
                return None  # family pre-registered but the run is clean
            thresh = float(rule.get("max_restarts", 3.0))
            return restarts > thresh, restarts, thresh
        if kind in ("fleet_quorum", "fleet_staleness"):
            # fleet-view rules: read the collector's rollup gauges
            # (obs/fleet.py). Not evaluable until a digest arrived — a
            # plane-off run's families are absent, an armed-but-quiet
            # boot reads zero digests; both stay silent.
            digests = sum(snap.get("fed_fleet_digests_total", {}).values())
            if not digests:
                return None
            if kind == "fleet_quorum":
                if self.expected_ranks is None:
                    return None
                # ramp-up gate: rows only exist once a rank's FIRST digest
                # lands, so during round 0 "reporting < expected" is just
                # boot order, not an outage. Round 1 anywhere in the fleet
                # means round 0 completed — every live rank had its chance
                # to report, and a missing row is now a real absence.
                rmax = snap.get("fed_fleet_round_max", {})
                if not rmax or max(rmax.values()) < 1:
                    return None
                reporting = float(sum(
                    snap.get("fed_fleet_ranks_reporting", {}).values()))
                # +1: rank 0's own row reports alongside the cohort.
                # Scheduled-offline ranks (churn trace) shrink the
                # expected cohort like the process-quorum rule above —
                # collector rows persist once ingested, so churn alone
                # can't drop `reporting`, but a rank held offline since
                # boot never produces a row and must not read as missing.
                off = float(sum(
                    snap.get("fed_ranks_scheduled_offline", {}).values()))
                thresh = (float(rule.get("min_fraction", 1.0))
                          * (max(0.0, self.expected_ranks - off) + 1))
                return reporting < thresh, reporting, thresh
            stale_fam = snap.get(
                "fed_fleet_digest_staleness_max_seconds", {})
            if not stale_fam:
                return None
            age = max(float(v) for v in stale_fam.values())
            thresh = float(rule.get("max_age_s", 120.0))
            return age > thresh, age, thresh
        return None

    def check(self) -> list[dict]:
        """Evaluate every rule, emit the edge transitions, return the
        transitions emitted this call. Safe from any thread (the round
        emit path and the background checker race by design)."""
        fired: list[dict] = []
        # staleness grows between digests: refresh the fleet rollup gauges
        # before snapshotting so the background checker sees real ages
        # (outside our lock — the collector has its own)
        fleet = getattr(self.telemetry, "fleet", None)
        if fleet is not None:
            fleet.refresh()
        with self._lock:
            snap = self.registry.snapshot()
            for i, rule in enumerate(self.rules):
                verdict = self._eval_rule(rule, snap)
                if verdict is None:
                    continue
                firing, value, thresh = verdict
                # edge-trigger state keyed per rule INSTANCE, not kind: a
                # two-tier table (same kind, warning + critical
                # thresholds) must not clobber one shared entry and emit
                # a fired/resolved pair on every check
                key = f"{rule['rule']}:{i}"
                active = key in self._active
                if firing and not active:
                    fired.append(self._emit(rule, key, "fired",
                                            value, thresh))
                elif not firing and active:
                    fired.append(self._emit(rule, key, "resolved",
                                            value, thresh))
        return fired

    def _emit(self, rule: dict, key: str, state: str, value, thresh) -> dict:
        """Caller holds the lock. One edge transition: ledger + event log
        + (on fired) the metrics family."""
        rec = {
            "rule": rule["rule"], "severity": rule["severity"],
            "state": state, "round": self.round_idx,
            "value": None if value is None or not math.isfinite(value)
            else round(float(value), 6),
            "threshold": round(float(thresh), 6),
        }
        if state == "fired":
            self._active[key] = rec
            self.registry.counter("fed_alerts_total", rule=rule["rule"],
                                  severity=rule["severity"]).inc()
        else:
            self._active.pop(key, None)
        if self.telemetry is not None:
            emitted = self.telemetry.events.emit("alert", **rec)
        else:
            emitted = dict(rec)
        self.alerts.append(emitted)
        log.log(logging.WARNING if state == "fired" else logging.INFO,
                "health: %s alert %s (value %s vs threshold %s, round %s)",
                rule["rule"], state, rec["value"], rec["threshold"],
                rec["round"])
        return emitted

    # ------------------------------------------------------------- healthz
    def snapshot(self) -> dict:
        """The /healthz verdict. Status is computed live (a scrape between
        checks still sees a stall), alerts are the currently-active set."""
        with self._lock:
            age = self._clock() - self._progress_t
            stall_after = next((float(r.get("after_s", 300.0))
                                for r in self.rules
                                if r["rule"] == "stall"), 300.0)
            stall_active = any(a["rule"] == "stall"
                               for a in self._active.values())
            if stall_active or age > stall_after:
                status = "stalled"
            elif self._active:
                status = "degraded"
            else:
                status = "ok"
            run_id = (self.telemetry.events.run_id
                      if self.telemetry is not None else None)
            return {
                "run": run_id,
                "status": status,
                "round": self.round_idx,
                "ranks_alive": self.registry.total("fed_ranks_alive"),
                "expected_ranks": self.expected_ranks,
                "last_progress_age_s": round(age, 3),
                "uptime_s": round(self._clock() - self._start_t, 3),
                "quarantine_total": self.registry.total(
                    "fed_updates_rejected_total"),
                "shed_total": self.registry.total("fed_async_shed_total"),
                # cumulative DP ε (null outside DP runs) — the live twin
                # of the round records' privacy block / fed_privacy_epsilon
                "privacy_epsilon": self._privacy_eps,
                # worst per-client ε (null until a per-client ledger run
                # reports) — live twin of fed_privacy_client_epsilon
                "eps_client_max": self._privacy_eps_client,
                # server crash recovery (docs/ROBUSTNESS.md §Server crash
                # recovery): the WAL's restart epoch (0 = never crashed)
                "restart_epoch": int(self.registry.total(
                    "fed_restart_epoch")),
                "alerts_fired_total": self.registry.total("fed_alerts_total"),
                "alerts": sorted(self._active.values(),
                                 key=lambda a: a["rule"]),
            }

    # ------------------------------------------------------------ lifecycle
    def start(self, interval_s: float = 5.0) -> "HealthMonitor":
        """Arm the background checker (idempotent). Needed only for
        between-round firing (stall detection on a dark fleet); the
        per-round hook alone covers everything that emits records."""
        if self._thread is not None:
            return self
        self._interval_s = float(interval_s)
        self._thread = threading.Thread(target=self._loop,
                                        name="obs-health", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self.check()
            except Exception:  # noqa: BLE001 — health must never kill a run
                log.exception("health check failed (continuing)")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
