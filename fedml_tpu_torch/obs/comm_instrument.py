"""Comm-layer instrumentation — wire accounting every backend reports alike.

``BaseCommManager`` calls these hooks at the three points all transports
share (obs must not import comm, so the dependency points this way):

- ``record_send``    — at encode time (``_encode``): messages/bytes out,
  labeled by backend, codec tier, and msg_type;
- ``record_receive`` — at decode time (``_receive_frame``): messages/bytes in;
- ``record_dispatch_latency`` — in the receive loop: seconds a decoded
  message waited in the inbound queue before its handler ran (the reference's
  MPI poll loop put a 0.3 s floor here, mpi/com_manager.py:71-78 — this
  histogram is the proof ours doesn't).

Counters land in the process-wide ``metrics.REGISTRY`` so loopback (many
managers, one process), gRPC, and MQTT runs all read through the same names:

    comm_messages_sent_total{backend,type}
    comm_bytes_sent_total{backend,codec}
    comm_bytes_total{codec,direction}        (direction = uplink|downlink)
    comm_messages_received_total{backend}
    comm_bytes_received_total{backend}
    comm_dispatch_latency_seconds{backend}   (histogram)
"""

from __future__ import annotations

import threading
import time
from functools import lru_cache

from fedml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

# Child metrics are memoized so the per-message hot path is just an inc()
# under that metric's own lock — no registry-lock + family-dict + sorted
# label-tuple work per frame. Key cardinality is bounded: a handful of
# backends, codecs, and protocol msg_types. Safe because REGISTRY is
# process-immortal (never reset).


@lru_cache(maxsize=512)
def _sent_msgs(backend: str, msg_type: str):
    return REGISTRY.counter("comm_messages_sent_total", backend=backend,
                            type=msg_type)


@lru_cache(maxsize=64)
def _sent_bytes(backend: str, codec: str):
    return REGISTRY.counter("comm_bytes_sent_total", backend=backend,
                            codec=codec)


@lru_cache(maxsize=16)
def _recv(backend: str):
    return (REGISTRY.counter("comm_messages_received_total", backend=backend),
            REGISTRY.counter("comm_bytes_received_total", backend=backend))


@lru_cache(maxsize=16)
def _dispatch_hist(backend: str):
    return REGISTRY.histogram("comm_dispatch_latency_seconds",
                              backend=backend)


def record_send(backend: str, codec: str, nbytes: int, msg_type: str) -> None:
    _sent_msgs(backend, msg_type).inc()
    _sent_bytes(backend, codec).inc(nbytes)


@lru_cache(maxsize=128)
def _bytes_total(codec: str, direction: str):
    return REGISTRY.counter("comm_bytes_total", codec=codec,
                            direction=direction)


def record_wire_bytes(codec: str, direction: str, nbytes: int) -> None:
    """Per-direction wire accounting (``comm_bytes_total{codec,direction}``,
    direction = uplink | downlink): at fleet fan-in the two directions have
    opposite economics — broadcast dominates downlink, per-client updates
    dominate uplink, and the uplink is the byte budget the delta/quantized
    tiers optimize (docs/PERFORMANCE.md §Wire efficiency). ``codec`` is the
    EFFECTIVE tier: the update codec (topk / delta / delta-int8 /
    delta-sign1) composed with the frame codec when both apply, else the
    frame codec alone — so the A/B evidence separates 'dense f32 frames'
    from 'quantized delta frames' without a second label."""
    _bytes_total(codec, direction).inc(nbytes)


# message types whose wire bytes are accounted under their OWN direction
# label instead of the receiver-derived uplink/downlink split. Registered
# by the protocol module that owns the frame type (the hierarchical tier
# registers e2s_evidence -> 'evidence' and s2e_verdict -> 'verdict', so
# the cross-tier robust protocol's control-plane bytes are separable from
# the update-frame budget in comm_bytes_total — the measured half of the
# O(cohort)-evidence / O(edges)-traffic claim). directional_bytes() sums
# uplink/downlink only, so overridden directions never pollute the
# per-round uplink/downlink record fields.
_DIRECTION_OVERRIDES: dict[str, str] = {}


def register_direction_override(msg_type: str, direction: str) -> None:
    """Account ``msg_type`` frames under ``comm_bytes_total{direction=}``
    with the given label (idempotent; conflicting re-registration is a
    programming error and raises)."""
    prev = _DIRECTION_OVERRIDES.get(str(msg_type))
    if prev is not None and prev != direction:
        raise ValueError(f"direction override for {msg_type!r} already "
                         f"registered as {prev!r} (got {direction!r})")
    _DIRECTION_OVERRIDES[str(msg_type)] = str(direction)


def direction_override(msg_type) -> str | None:
    return _DIRECTION_OVERRIDES.get(str(msg_type))


def directional_bytes(registry: MetricsRegistry | None = None) -> dict:
    """{'uplink': bytes, 'downlink': bytes} summed over codecs (0.0 for a
    direction with no traffic / pre-PR-9 processes)."""
    reg = registry or REGISTRY
    out = {"uplink": 0.0, "downlink": 0.0}
    fam = reg.snapshot().get("comm_bytes_total", {})
    for label_s, v in fam.items():
        for d in out:
            if f"direction={d}" in label_s:
                out[d] += float(v)
    return out


def record_receive(backend: str, nbytes: int) -> None:
    msgs, byts = _recv(backend)
    msgs.inc()
    byts.inc(nbytes)


_tls = threading.local()


def record_dispatch_latency(backend: str, seconds: float) -> None:
    _dispatch_hist(backend).observe(seconds)
    # stash for the handler about to run on THIS thread (the dispatch loop
    # notifies observers right after timing) — the tracing layer reads it
    # to attribute inbound queue wait on the client_round span
    _tls.last_dispatch_s = seconds


def last_dispatch_latency() -> float | None:
    """Queue wait of the message currently being dispatched on this thread
    (None outside a dispatch-loop handler)."""
    return getattr(_tls, "last_dispatch_s", None)


@lru_cache(maxsize=16)
def _retransmits(backend: str):
    return (REGISTRY.counter("comm_retransmits_total", backend=backend),
            REGISTRY.counter("comm_retransmit_bytes_total", backend=backend))


def record_retransmit(backend: str, nbytes: int) -> None:
    """A frame transmitted AGAIN after a delivery failure. ``*_sent_total``
    counts logical frames (one per message, at encode time); this counter
    exposes the extra wire traffic retries add — the number that diagnoses
    a flaky link."""
    msgs, byts = _retransmits(backend)
    msgs.inc()
    byts.inc(nbytes)


@lru_cache(maxsize=32)
def _send_retries(backend: str, reason: str):
    return REGISTRY.counter("comm_send_retries_total", backend=backend,
                            reason=reason)


def record_send_retry(backend: str, reason: str) -> None:
    """A send the transport is about to RETRY after a transient failure,
    labeled by the failure reason (gRPC status-code name: ``unavailable``,
    ``deadline_exceeded``). Complements ``comm_retransmits_total`` (bytes
    moved again) with the per-cause attempt count a flaky-channel
    diagnosis needs; permanent failures are raised, never counted here."""
    _send_retries(backend, reason).inc()


@lru_cache(maxsize=16)
def _duplicates(backend: str):
    return REGISTRY.counter("comm_duplicates_dropped_total", backend=backend)


def record_duplicate(backend: str) -> None:
    """An inbound frame dropped by exactly-once dedup before decode —
    received wire traffic that ``*_received_total`` (decoded frames)
    deliberately excludes."""
    _duplicates(backend).inc()


@lru_cache(maxsize=16)
def _corrupt(backend: str):
    return REGISTRY.counter("comm_corrupt_frames_total", backend=backend)


def record_corrupt_frame(backend: str) -> None:
    """An inbound frame that failed integrity/decode (CRC32 mismatch, bad
    magic, damaged deflate) and was dropped by ``_receive_frame`` instead
    of crashing the dispatch loop. Counted IN ``*_received_total`` (the
    bytes did arrive) but never dispatched."""
    _corrupt(backend).inc()


@lru_cache(maxsize=256)
def _faults(backend: str, fault: str, direction: str):
    return REGISTRY.counter("comm_faults_injected_total", backend=backend,
                            fault=fault, direction=direction)


def record_fault(backend: str, fault: str, direction: str) -> None:
    """A fault the chaos layer (fedml_tpu/chaos) injected on purpose —
    labeled by fault kind and direction so a soak run's summary can assert
    the planned chaos actually happened."""
    _faults(backend, fault, direction).inc()


# ----------------------------------------------------- robust aggregation
# Quarantine bookkeeping (core/robust_agg.py + distributed aggregator):
# the sanitation gate / robust aggregators report every rejected or
# suspected update here so a soak dashboard can watch a poisoning attempt
# the same way it watches wire faults.


@lru_cache(maxsize=16)
def _rejected(reason: str):
    return REGISTRY.counter("fed_updates_rejected_total", reason=reason)


def record_update_rejected(reason: str) -> None:
    """An uploaded update the sanitation gate rejected or a robust
    aggregator suspected, labeled by quarantine reason
    (nonfinite | norm_outlier | suspected)."""
    _rejected(reason).inc()


@lru_cache(maxsize=256)
def _suspected(rank: int):
    return REGISTRY.counter("fed_suspected_rank", rank=rank)


def record_suspected_rank(rank: int) -> None:
    """Per-rank quarantine tally — which worker keeps getting flagged."""
    _suspected(int(rank)).inc()


@lru_cache(maxsize=16)
def _stale(reason: str):
    return REGISTRY.counter("comm_stale_uploads_total", reason=reason)


def record_stale_upload(reason: str) -> None:
    """An upload the aggregator refused to slot: ``stale`` (round tag
    behind/ahead of the current round) or ``unknown_rank`` (index outside
    the worker table) — previously these silently overwrote state."""
    _stale(reason).inc()


# --------------------------------------------------------------- liveness
# Heartbeat/liveness gauges, fed by the machinery that already exists:
# every decoded inbound frame proves its sender alive (BaseCommManager.
# _receive_frame), a gRPC dedup-dropped duplicate still proves liveness
# (grpc_backend.recv), and the elastic server's undeliverable/reprobe
# bookkeeping sets the alive count. Ages are recomputed on snapshot
# (refresh_liveness) so the Prometheus dump and per-round comm deltas
# carry fresh values.

_hb_lock = threading.Lock()
_hb_last_seen: dict[int, float] = {}

# Gauge-cardinality cap for fleet-sized cohorts (docs/OBSERVABILITY.md
# §Fleet rollup): up to HEARTBEAT_RANK_CAP ranks every rank keeps its own
# ``fed_last_heartbeat_age_seconds{rank}`` child (the small-cohort view
# dashboards already use). Above the cap the export would grow
# O(world_size) lines, so refresh_liveness keeps only the
# HEARTBEAT_KEEP_STALEST stalest ranks (the ones an operator actually
# looks for) plus a three-line rollup family
# ``fed_heartbeat_age_rollup{stat=min|max|count}``; the full per-rank
# ages stay queryable via ``heartbeat_ages()`` and the /fleetz view.
HEARTBEAT_RANK_CAP = 64
HEARTBEAT_KEEP_STALEST = 16


@lru_cache(maxsize=256)
def _hb_gauge(rank: int):
    return REGISTRY.gauge("fed_last_heartbeat_age_seconds", rank=rank)


def record_rank_seen(rank) -> None:
    """A frame from ``rank`` arrived — reset its heartbeat age. Runs on
    the per-frame receive path, so the gauge child is memoized like the
    other hot-path hooks (no registry-lock traffic per frame). Above the
    cardinality cap the per-rank gauge write is skipped — the stamps
    (not the gauges) are the source of truth, and refresh_liveness owns
    which children exist."""
    try:
        rank = int(rank)
    except (TypeError, ValueError):
        return  # interop peers may ship non-integer sender ids
    with _hb_lock:
        _hb_last_seen[rank] = time.time()
        over = len(_hb_last_seen) > HEARTBEAT_RANK_CAP
    if not over:
        _hb_gauge(rank).set(0.0)


def refresh_liveness() -> None:
    """Recompute the heartbeat-age gauges from the last-seen stamps (ages
    grow between frames; a gauge is a snapshot, so exporters call this
    right before reading). At or below HEARTBEAT_RANK_CAP ranks: one
    gauge child per rank. Above it: only the HEARTBEAT_KEEP_STALEST
    stalest ranks keep children (the rest are dropped from the family)
    plus the min/max/count rollup — bounded export at any world size."""
    now = time.time()
    with _hb_lock:
        items = list(_hb_last_seen.items())
    if len(items) <= HEARTBEAT_RANK_CAP:
        for rank, ts in items:
            _hb_gauge(rank).set(max(0.0, now - ts))
        return
    ages = {rank: max(0.0, now - ts) for rank, ts in items}
    keep = set(sorted(ages, key=ages.get, reverse=True)
               [:HEARTBEAT_KEEP_STALEST])
    for rank, age in ages.items():
        if rank in keep:
            REGISTRY.gauge("fed_last_heartbeat_age_seconds",
                           rank=rank).set(age)
        else:
            REGISTRY.remove("fed_last_heartbeat_age_seconds", rank=rank)
    # the memo may hold children just removed from the family — writes
    # through it would land on orphans the export never sees
    _hb_gauge.cache_clear()
    vals = list(ages.values())
    REGISTRY.gauge("fed_heartbeat_age_rollup", stat="min").set(min(vals))
    REGISTRY.gauge("fed_heartbeat_age_rollup", stat="max").set(max(vals))
    REGISTRY.gauge("fed_heartbeat_age_rollup", stat="count").set(len(vals))


def heartbeat_ages(now: float | None = None) -> dict[int, float]:
    """rank -> seconds since its last decoded frame (the raw stamps behind
    ``fed_last_heartbeat_age_seconds``), for the heartbeat-driven cohort
    admission gate (docs/ROBUSTNESS.md §Asynchronous buffered rounds). A
    rank with no frame yet is absent — never seen is 'unknown', not
    'infinitely suspect' (a cohort must be dispatchable at boot)."""
    if now is None:
        now = time.time()
    with _hb_lock:
        return {r: max(0.0, now - ts) for r, ts in _hb_last_seen.items()}


def reset_heartbeats() -> None:
    """Clear the per-process last-seen table (tests: loopback simulations
    share the process-wide stamps, so a previous job's silence must not
    mark the next job's ranks suspect)."""
    with _hb_lock:
        _hb_last_seen.clear()
    # the memo may reference children a capped refresh removed — the next
    # job must re-create real ones, not write through orphans
    _hb_gauge.cache_clear()


def suspect_ranks(ranks, max_age_s: float | None, round_idx: int,
                  reprobe_every: int = 4,
                  ages: dict[int, float] | None = None) -> set[int]:
    """The heartbeat admission verdict, as a pure function (unit-testable
    with injected ``ages``): a rank is suspect when its heartbeat age
    exceeds the FRESHEST cohort member's age by more than ``max_age_s`` —
    RELATIVE, not absolute, because ranks are only heard from once per
    round: during a server-side stall every healthy rank's absolute age
    grows past any fixed threshold together (and an absolute rule would
    exclude the whole cohort and deadlock the barrier), while a dead rank
    keeps falling behind its liveliest peer without bound. Suspects are
    re-invited on reprobe rounds (every ``reprobe_every``-th) so a rank
    that resumed (crash window over, partition healed) can rejoin: its
    next frame resets the age and readmits it everywhere. A rank with no
    frame yet is unknown, not suspect (the cohort must be dispatchable at
    boot)."""
    if max_age_s is None:
        return set()
    if ages is None:
        ages = heartbeat_ages()
    if reprobe_every > 0 and round_idx % reprobe_every == 0:
        return set()
    known = [ages[int(r)] for r in ranks if ages.get(int(r)) is not None]
    if not known:
        return set()
    base = min(known)
    return {int(r) for r in ranks
            if ages.get(int(r)) is not None
            and ages[int(r)] - base > max_age_s}


def set_ranks_alive(n: int) -> None:
    """``fed_ranks_alive``: peer ranks currently considered reachable —
    set by the elastic server from its undeliverable/reprobe bookkeeping
    (world - 1 at start, decremented on delivery failure, restored when a
    reprobe succeeds). A server driven by a churn trace also subtracts
    its SCHEDULED-offline ranks, so alive and the quorum rule's shrunken
    expected denominator move together through diurnal troughs."""
    REGISTRY.gauge("fed_ranks_alive").set(n)


def set_ranks_scheduled_offline(n: int) -> None:
    """``fed_ranks_scheduled_offline``: ranks the active churn trace
    (chaos/churn.py) marks away for the current round's window. The
    quorum/fleet_quorum health rules subtract this from their expected
    denominator — a diurnal trough is the fleet's normal state, never an
    outage (docs/ROBUSTNESS.md §Fleet campaigns & client churn). Zero
    (and pre-registered by the churn-driven server) on trace-less runs."""
    REGISTRY.gauge("fed_ranks_scheduled_offline").set(n)


def record_round_idle() -> None:
    """``fed_rounds_idle_total``: rounds the server skipped because every
    undelivered rank was SCHEDULED-offline (an empty night-time cohort —
    the watchdog idles the round instead of re-broadcasting forever)."""
    REGISTRY.counter("fed_rounds_idle_total").inc()


def ensure_churn_families() -> None:
    """Pre-register the churn families at zero the moment a server boots
    with a trace armed — a churn-driven run's export must read 'no idle
    rounds yet', not 'metric missing'. Trace-less runs never call this,
    keeping their export byte-identical."""
    REGISTRY.gauge("fed_ranks_scheduled_offline")
    REGISTRY.counter("fed_rounds_idle_total")


def comm_counters(registry: MetricsRegistry | None = None) -> dict:
    """Flat cumulative totals (all labels summed) — the snapshot Telemetry
    diffs between rounds to put per-round byte/message counts in the event
    log. Includes dispatch-latency quantiles when any message was timed."""
    refresh_liveness()  # age gauges must be fresh in any snapshot
    reg = registry or REGISTRY
    dirs = directional_bytes(reg)
    out = {
        "messages_sent": reg.total("comm_messages_sent_total"),
        "bytes_sent": reg.total("comm_bytes_sent_total"),
        "messages_received": reg.total("comm_messages_received_total"),
        "bytes_received": reg.total("comm_bytes_received_total"),
        # per-direction split (comm_bytes_total{codec,direction}): uplink
        # is the byte budget the delta/quantized tiers optimize; one
        # undirected counter hides that broadcast dominates downlink
        "bytes_uplink": dirs["uplink"],
        "bytes_downlink": dirs["downlink"],
    }
    snap = reg.snapshot().get("comm_dispatch_latency_seconds", {})
    n = sum(s.get("count", 0) for s in snap.values())
    if n:
        out["dispatch_count"] = n
        # single-backend runs (the norm) have one child; multi-backend runs
        # get the max — a conservative "slowest transport" view
        out["dispatch_p95_s"] = max(s.get("p95", 0.0) for s in snap.values())
    return out
