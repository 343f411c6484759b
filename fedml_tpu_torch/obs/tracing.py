"""Cross-rank distributed tracing — stitched per-round timelines.

The PR-1 telemetry layer counts *what* happened per round; this module says
*where wall-clock went across ranks*. Every round gets a trace id and every
span carries (trace id, span id, parent id, rank):

- **server** (rank 0): ``round`` (the whole round), ``broadcast`` (the
  serialize+send loop), per-rank ``downlink`` / ``uplink`` wire spans, and
  whatever the engine's ``RoundTracer`` records (``aggregate``, ``eval``);
- **client** (rank k): ``client_round`` (handler entry to upload), with
  ``unpack`` / ``local_fit`` / ``pack`` children.

Context propagation rides in the existing FMT2 JSON header scalars: the
server adds a ``__trace`` param ({tid, sid, t1}) to each broadcast, the
client echoes it back on its upload extended with its clock stamps and its
finished span buffer — so loopback, gRPC, and MQTT propagate identically
(it is just another scalar message param) and a stock peer that ignores the
key still interoperates. The server rebases client timestamps onto its own
clock with the NTP-style estimator in ``obs/clock.py`` (the broadcast ->
upload exchange IS the T1..T4 handshake) and stitches one timeline per
round.

On top of the stitched timeline, ``finish_round`` computes the per-round
**critical path**: which rank bounded the round (the straggler — last
uplink to arrive), its phase breakdown, per-rank slack, and — when a chaos
``FaultPlan`` is active — the injected straggle/delay seconds
cross-referenced from the fault ledger, so a planned 200 ms straggle
surfaces as that rank owning the critical path with a labeled span.

Span ids are pure sha256 functions of (run id, round, rank, counter) — no
RNG, no wall-clock entropy — so a run with an injected fake clock exports a
byte-stable Chrome trace (the golden test). All of this is host-side:
tracing never touches the jitted round program, and with tracing off no
``__trace`` param is ever added (frames are byte-identical to the
untraced build).

Exports: ``obs/trace_export.py`` (Chrome trace-event JSON for
Perfetto / chrome://tracing, plus the critical-path text renderer behind
``scripts/report.py --critical-path``).
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from collections import defaultdict
from functools import lru_cache

from fedml_tpu_torch.obs.clock import ClockSync
from fedml_tpu_torch.obs.metrics import REGISTRY

# message param carrying trace context (a JSON-header scalar on the wire).
# Server -> client: {"tid", "sid", "t1"}; client -> server: that plus
# {"t2", "t3", "spans": [span dicts]} — the piggybacked client buffer.
TRACE_KEY = "__trace"

# canonical phase order for reports (extra span names append after these)
PHASES = ("downlink", "unpack", "local_fit", "pack", "uplink",
          "aggregate", "eval")


def make_trace_id(run_id: str, round_idx: int) -> str:
    """Deterministic per-(run, round) trace id — 16 hex chars."""
    key = f"trace|{run_id}|{int(round_idx)}".encode()
    return hashlib.sha256(key).hexdigest()[:16]


def make_span_id(trace_id: str, rank: int, n: int) -> str:
    """Deterministic span id: pure in (trace, rank, per-rank counter)."""
    key = f"span|{trace_id}|{int(rank)}|{int(n)}".encode()
    return hashlib.sha256(key).hexdigest()[:16]


def _span(tid: str, sid: str, parent: str | None, rank: int, name: str,
          t0: float, t1: float, attrs: dict | None = None) -> dict:
    s = {"tid": tid, "sid": sid, "parent": parent, "rank": int(rank),
         "name": name, "t0": float(t0), "t1": float(t1)}
    if attrs:
        s["attrs"] = attrs
    return s


# --------------------------------------------------------------- RoundTracer
@lru_cache(maxsize=256)
def _span_hist(name: str):
    # process-wide histogram family so RoundTracer spans and the Prometheus
    # export read from ONE timing path (pre-PR-3 they were disjoint)
    return REGISTRY.histogram("fed_span_seconds", span=name)


class RoundTracer:
    """Per-round named span timing with aggregate statistics.

    The seed-era host-side span timer (was ``utils/tracing.py``), absorbed
    into the obs tracing path: every ``span()`` observation now also feeds
    the process-wide ``fed_span_seconds{span=...}`` histogram (so
    ``summary()`` totals and the Prometheus export agree — the histogram
    counts observations, ``summary()`` aggregates per round), and an
    optional ``sink`` (a :class:`DistributedTracer`) receives each span's
    wall-clock interval for the stitched per-round timeline. With
    ``sink=None`` the extra cost is one histogram observe per span.
    """

    def __init__(self, sink: "DistributedTracer | None" = None):
        self.rounds: list[dict[str, float]] = [{}]
        self._sink = sink

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        w0 = time.time()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            cur = self.rounds[-1]
            cur[name] = cur.get(name, 0.0) + dt
            _span_hist(name).observe(dt)
            if self._sink is not None:
                self._sink.record_span(name, w0, w0 + dt)

    def next_round(self):
        self.rounds.append({})

    def summary(self) -> dict[str, dict[str, float]]:
        """name -> {mean, p50, p95, max, total} over completed rounds."""
        import numpy as np

        per_name = defaultdict(list)
        for r in self.rounds:
            for k, v in r.items():
                per_name[k].append(v)
        out = {}
        for k, vs in per_name.items():
            a = np.asarray(vs)
            out[k] = {
                "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "max": float(a.max()),
                "total": float(a.sum()),
                "count": len(vs),
            }
        return out

    def totals(self) -> dict[str, float]:
        """name -> total seconds across all rounds (the bench span report)."""
        return {k: v["total"] for k, v in self.summary().items()}


# --------------------------------------------------------- client-side buffer
class ClientSpanBuffer:
    """Client-rank span buffer — created lazily by a client manager the
    first time an inbound broadcast carries ``__trace`` context, so clients
    trace exactly when the server does (no client-side configuration).

    ``on_broadcast`` adopts the server's context (T1, and T2 = now);
    ``span`` records children of this round's ``client_round`` root;
    ``upload_blob`` stamps T3, closes the root, and returns the dict the
    manager piggybacks on the uplink frame.
    """

    def __init__(self, rank: int, clock=time.time):
        self.rank = int(rank)
        self._clock = clock
        self._tid: str | None = None
        self._parent: str | None = None
        self._root: str | None = None
        self._t1 = 0.0
        self._t2 = 0.0
        self._n = 0
        self._spans: list[dict] = []
        self._root_attrs: dict = {}

    def on_broadcast(self, blob: dict) -> None:
        from fedml_tpu_torch.obs import comm_instrument as _obs

        self._tid = str(blob.get("tid"))
        self._parent = blob.get("sid")
        self._t1 = float(blob.get("t1", 0.0))
        self._t2 = self._clock()
        self._n = 0
        self._spans = []
        self._root = make_span_id(self._tid, self.rank, 0)
        self._root_attrs = {}
        q = _obs.last_dispatch_latency()
        if q is not None:  # seconds the frame waited in the inbound queue
            self._root_attrs["queue_s"] = q

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t0 = self._clock()
        try:
            yield
        finally:
            t1 = self._clock()
            self._n += 1
            sid = make_span_id(self._tid, self.rank, self._n)
            self._spans.append(_span(self._tid, sid, self._root, self.rank,
                                     name, t0, t1, attrs or None))

    def upload_blob(self) -> dict:
        """Stamp T3, close the ``client_round`` root, return the uplink
        piggyback: trace context + clock stamps + the finished spans."""
        t3 = self._clock()
        root = _span(self._tid, self._root, self._parent, self.rank,
                     "client_round", self._t2, t3,
                     self._root_attrs or None)
        return {"tid": self._tid, "sid": self._root,
                "t1": self._t1, "t2": self._t2, "t3": t3,
                "spans": self._spans + [root]}


# ------------------------------------------------------------- chaos lookup
def chaos_delays(round_idx: int) -> dict[int, float]:
    """rank -> seconds of straggle/delay the active chaos plan injected
    this round (from its fault ledger), so injected latency is attributed
    — not just observed — on the critical path. Empty when no plan is
    installed. Import is lazy: obs must not import chaos at module load
    (chaos imports obs)."""
    try:
        from fedml_tpu_torch import chaos as _chaos
    except Exception:  # pragma: no cover - chaos always ships, but obs
        return {}      # must degrade if the package is trimmed
    plan = _chaos.active_plan()
    if plan is None:
        return {}
    out: dict[int, float] = {}
    for e in plan.ledger.for_round(round_idx, faults=("straggle", "delay")):
        fault, direction = e["fault"], e["direction"]
        src, dst = e["src"], e["dst"]
        # attribute to the CLIENT end of the link: a delayed downlink
        # (src = server rank 0) slows the destination rank's round, and
        # the server never uploads — src-only attribution would lose it
        rank = src if src not in (None, 0) else dst
        if rank is None:
            continue
        for rule in plan.rules:
            if (rule.fault == fault and rule.in_window(round_idx)
                    and rule.matches_link(direction, src, dst)):
                out[int(rank)] = out.get(int(rank), 0.0) + rule.delay_s
                break
    return out


# --------------------------------------------------------- server-side trace
class DistributedTracer:
    """The stitching tracer — one per Telemetry bundle (rank 0 / the
    standalone engine). Collects this process's spans, rebases and adopts
    piggybacked client spans, and computes the per-round critical path.

    Driven by the server manager::

        tr.begin_round(r)
        for rank in ...: msg.add_params(TRACE_KEY, tr.broadcast_ctx(rank))
        tr.end_broadcast()
        ... on each upload: tr.on_upload(rank, msg_params.get(TRACE_KEY))
        ... RoundTracer(sink=tr) records aggregate/eval via record_span
        cp = tr.finish_round()          # the round record's critical_path

    The standalone engine drives only ``begin_round`` + the RoundTracer
    sink: no arrivals means ``finish_round`` returns None (single-rank
    timelines have no straggler) while the spans still export.
    """

    def __init__(self, run_id: str, rank: int = 0, clock=time.time):
        self.run_id = str(run_id)
        self.rank = int(rank)
        self._clock = clock
        self.clock_sync = ClockSync()
        self._spans: list[dict] = []
        self._lock = threading.Lock()
        self._cur: dict | None = None

    # ------------------------------------------------------------ round flow
    def begin_round(self, round_idx: int) -> None:
        """Open round ``round_idx``'s trace (auto-finishing any open one)."""
        with self._lock:
            if self._cur is not None:
                self._finish_round_locked()
            tid = make_trace_id(self.run_id, round_idx)
            self._cur = {
                "round": int(round_idx), "tid": tid, "t0": self._clock(),
                "n": 0, "round_sid": make_span_id(tid, self.rank, 0),
                "bcast_sid": None, "bcast_t0": None, "dests": set(),
                "arrivals": {}, "client_phases": {}, "offsets": {},
                "server_spans": {}, "chaos": {},
            }

    def _next_sid(self) -> str:
        cur = self._cur
        cur["n"] += 1
        return make_span_id(cur["tid"], self.rank, cur["n"])

    def broadcast_ctx(self, dest_rank: int) -> dict:
        """The ``__trace`` param for one outgoing broadcast (stamps T1;
        opens the ``broadcast`` span on first call)."""
        with self._lock:
            cur = self._cur
            if cur is None:
                return {}
            if cur["bcast_sid"] is None:
                cur["bcast_sid"] = self._next_sid()
                cur["bcast_t0"] = self._clock()
            cur["dests"].add(int(dest_rank))
            return {"tid": cur["tid"], "sid": cur["bcast_sid"],
                    "t1": self._clock()}

    def end_broadcast(self) -> None:
        with self._lock:
            cur = self._cur
            if cur is None or cur["bcast_sid"] is None:
                return
            self._spans.append(_span(
                cur["tid"], cur["bcast_sid"], cur["round_sid"], self.rank,
                "broadcast", cur["bcast_t0"], self._clock()))

    def on_upload(self, rank: int, blob: dict | None) -> None:
        """Fold one client upload in: arrival time (T4), clock-offset
        sample, the rebased client span buffer, and the downlink/uplink
        wire spans. ``blob=None`` (stock peer, tracing-off client) still
        records the arrival so slack stays computable."""
        now = self._clock()
        rank = int(rank)
        with self._lock:
            cur = self._cur
            if cur is None:
                return
            if rank in cur["arrivals"]:
                # chaos-duplicated uplink: the first delivery is the real
                # wire time — re-recording would double the client spans
                # (same ids) and corrupt slack with the copy's arrival
                return
            cur["arrivals"][rank] = now
            if not isinstance(blob, dict) or blob.get("tid") != cur["tid"]:
                return  # no context (or a stale trace id): arrival only
            try:
                t1, t2, t3 = (float(blob["t1"]), float(blob["t2"]),
                              float(blob["t3"]))
            except (KeyError, TypeError, ValueError):
                return  # malformed peer blob must not kill the handler
            off = self.clock_sync.update(rank, t1, t2, t3, now)
            cur["offsets"][rank] = off
            phases: dict[str, float] = {}
            for s in blob.get("spans", ()):
                if not isinstance(s, dict):
                    continue
                try:
                    s = dict(s, t0=float(s["t0"]) - off,
                             t1=float(s["t1"]) - off)
                except (KeyError, TypeError, ValueError):
                    continue  # skip a damaged span, keep the rest
                self._spans.append(s)
                if s.get("name") != "client_round":
                    phases[s["name"]] = (phases.get(s["name"], 0.0)
                                         + (s["t1"] - s["t0"]))
            # clamp the rebased wire endpoints: the min-RTT offset came
            # from a different exchange, so an asymmetric round can land
            # t2-off before t1 (or t3-off after t4) — a negative-duration
            # span would flunk the schema on timing jitter
            t2s = max(t2 - off, t1)
            t3s = min(t3 - off, now)
            parent = cur["bcast_sid"] or cur["round_sid"]
            self._spans.append(_span(cur["tid"], self._next_sid(), parent,
                                     rank, "downlink", t1, t2s))
            phases["downlink"] = t2s - t1
            delays = self._round_chaos_delays(cur)
            attrs = None
            if rank in delays:
                attrs = {"chaos": "injected_delay",
                         "chaos_delay_s": delays[rank]}
                cur["chaos"][rank] = delays[rank]
            self._spans.append(_span(cur["tid"], self._next_sid(),
                                     blob.get("sid"), rank, "uplink", t3s,
                                     now, attrs))
            phases["uplink"] = now - t3s
            cur["client_phases"][rank] = phases

    def _round_chaos_delays(self, cur: dict) -> dict[int, float]:
        """chaos_delays for the open round, recomputed only when the fault
        ledger grew since the last lookup (ledger len is O(1)): N uploads
        must not each rescan a soak run's whole ledger."""
        try:
            from fedml_tpu_torch import chaos as _chaos
        except Exception:  # pragma: no cover
            return {}
        plan = _chaos.active_plan()
        n = len(plan.ledger) if plan is not None else 0
        if cur.get("chaos_ledger_n") != n:
            cur["chaos_ledger_n"] = n
            cur["chaos_cache"] = chaos_delays(cur["round"])
        return cur["chaos_cache"]

    def record_span(self, name: str, t0: float, t1: float,
                    attrs: dict | None = None) -> None:
        """Record one local span under the open round (the RoundTracer
        sink path: aggregate/eval on the server, pack/round/eval
        standalone). No open round -> dropped (nothing to parent to)."""
        with self._lock:
            cur = self._cur
            if cur is None:
                return
            self._spans.append(_span(cur["tid"], self._next_sid(),
                                     cur["round_sid"], self.rank, name,
                                     t0, t1, attrs))
            cur["server_spans"][name] = (cur["server_spans"].get(name, 0.0)
                                         + (t1 - t0))

    def finish_round(self) -> dict | None:
        """Close the round span and return the critical-path record (None
        when no round is open or no client ever reported — standalone)."""
        with self._lock:
            return self._finish_round_locked()

    def finish(self) -> None:
        """Close any open round (Telemetry.close)."""
        with self._lock:
            if self._cur is not None:
                self._finish_round_locked()

    def _finish_round_locked(self) -> dict | None:
        cur, self._cur = self._cur, None
        now = self._clock()
        self._spans.append(_span(cur["tid"], cur["round_sid"], None,
                                 self.rank, "round", cur["t0"], now))
        arrivals = cur["arrivals"]
        if not arrivals:
            return None
        straggler = max(sorted(arrivals), key=arrivals.get)
        last = arrivals[straggler]
        phases = dict(cur["client_phases"].get(straggler, {}))
        phases.update(cur["server_spans"])
        cp = {
            "straggler": straggler,
            "round_s": now - cur["t0"],
            "phases": phases,
            "slack_s": {r: last - t for r, t in sorted(arrivals.items())},
        }
        missing = sorted(cur["dests"] - set(arrivals))
        if missing:
            cp["missing"] = missing  # elastic partial: never reported
        if cur["chaos"]:
            cp["chaos_delay_s"] = dict(cur["chaos"])
        if cur["offsets"]:
            cp["clock_offset_s"] = dict(sorted(cur["offsets"].items()))
        # registry: the report's aggregate view of the same numbers
        for name, secs in phases.items():
            REGISTRY.histogram("fed_phase_seconds", phase=name).observe(secs)
        REGISTRY.counter("fed_round_critical_path_total",
                         rank=straggler).inc()
        for r, s in cp["slack_s"].items():
            if r != straggler:
                REGISTRY.histogram("fed_straggler_slack_seconds").observe(s)
        return cp

    # ---------------------------------------------------------------- export
    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)
