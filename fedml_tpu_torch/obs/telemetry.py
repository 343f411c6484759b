"""Telemetry — the bundle engines and launchers pass around, port of
fedml_tpu/obs/telemetry.py.

One object ties together the obs primitives:

- a ``MetricsRegistry`` (defaults to the process-wide one, so comm-layer
  counters recorded by the backends show up in this run's round records);
- an ``EventLog`` over a rotating JSONL file (``log_dir/events.jsonl``) or
  an in-memory sink (tests);
- the ``torch.profiler`` bridge (``profile(logdir)`` — the opt-in device
  trace, reusing utils.tracing.trace);
- optionally a ``DistributedTracer`` (``trace_dir=``/``trace=True``) — the
  cross-rank per-round trace stitcher (obs/tracing.py); ``close()`` writes
  its Chrome trace-event JSON next to the event log;
- optionally the live run-health layer (docs/OBSERVABILITY.md §Live
  endpoints): ``http_port=`` binds a per-rank ``/metrics`` + ``/healthz``
  HTTP server (obs/httpd.py; port 0 = ephemeral, the bound port rides the
  run header), ``memwatch=`` samples device memory (the CUDA caching
  allocator's) + host RSS into gauges
  and a ``mem`` block on round records (obs/memwatch.py), and
  ``health=``/``health_rules=`` arm the rule-driven ``HealthMonitor``
  (obs/health.py) whose alerts land in this event log. ``http_port``
  alone implies memwatch + health — a live endpoint with no health
  verdict behind it would be an empty promise; pass ``memwatch=False`` /
  ``health=False`` to strip them.

Contract with the engines: a ``telemetry=None`` engine is bit-identical to
the pre-telemetry engine — no extra device syncs, no FLOP count, no host
work beyond the reference's. All cost is opt-in, and the new layers
follow the same rule: with http/memwatch/health off (the default) this
bundle starts zero threads and binds zero sockets.
"""

from __future__ import annotations

import os

from fedml_tpu_torch.obs.comm_instrument import comm_counters
from fedml_tpu_torch.obs.events import EventLog, JsonlSink, MemorySink
from fedml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry


class Telemetry:
    def __init__(self, log_dir: str | None = None,
                 registry: MetricsRegistry | None = None,
                 sink=None, run_id: str | None = None,
                 round_stats: bool = True,
                 rotate_bytes: int = 64 << 20, backups: int = 3,
                 trace_dir: str | None = None, trace: bool = False,
                 trace_clock=None,
                 http_port: int | None = None, http_host: str = "127.0.0.1",
                 memwatch: bool | None = None, mem_interval_s: float = 5.0,
                 health: bool | None = None, health_rules=None,
                 health_interval_s: float = 5.0,
                 expected_ranks: int | None = None,
                 fleet: bool = False, fleet_job: str = ""):
        self.log_dir = log_dir
        # ``registry`` is where THIS bundle's own metrics live and what
        # close() dumps. Comm deltas always read the process-wide REGISTRY
        # regardless — the comm backends hard-wire their counters there
        # (they have no construction-time hook to receive another), so
        # honoring a custom registry for comm would silently report zero
        # traffic on a run that moved gigabytes.
        self.registry = registry or REGISTRY
        if sink is None:
            sink = (JsonlSink(os.path.join(log_dir, "events.jsonl"),
                              max_bytes=rotate_bytes, backups=backups)
                    if log_dir else MemorySink())
        self.events = EventLog(sink, run_id=run_id)
        # round_stats=False: keep the event stream but skip the in-graph
        # update-norm/drift outputs (an engine knob; comm counters stay on)
        self.round_stats = round_stats
        # cross-rank distributed tracing (obs/tracing.py): opt-in via
        # trace_dir (Chrome trace-event JSON written at close) or
        # trace=True (spans kept in memory — tests read tracer.spans()).
        # Off (the default): self.tracer is None, the engines add no trace
        # context to any frame, and the wire is byte-identical.
        self.trace_dir = trace_dir
        self.tracer = None
        if trace or trace_dir:
            import time as _time

            from fedml_tpu_torch.obs.tracing import DistributedTracer

            self.tracer = DistributedTracer(
                self.events.run_id, clock=trace_clock or _time.time)
        # --- live run-health layer (all opt-in; docs/OBSERVABILITY.md
        # §Live endpoints / §Memory telemetry / §Health rules). None means
        # "follow http_port": a live endpoint without memory gauges or a
        # health verdict would scrape hollow.
        self.health = None
        self.memwatch = None
        self.httpd = None
        self.http_port = None
        if health is None:
            health = (health_rules is not None or http_port is not None
                      or fleet)
        if memwatch is None:
            memwatch = http_port is not None
        if health:
            from fedml_tpu_torch.obs.health import HealthMonitor

            self.health = HealthMonitor(telemetry=self, rules=health_rules,
                                        registry=self.registry,
                                        expected_ranks=expected_ranks)
            self.health.start(health_interval_s)
        if memwatch:
            from fedml_tpu_torch.obs.memwatch import MemoryWatcher

            self.memwatch = MemoryWatcher(interval_s=mem_interval_s,
                                          registry=self.registry).start()
        # --- fleet observability plane (docs/OBSERVABILITY.md §Fleet
        # rollup): rank 0's digest collector. The engines read
        # ``telemetry.fleet`` to decide whether broadcasts carry the
        # in-band marker; off (the default) keeps the wire byte-identical.
        self.fleet = None
        if fleet:
            from fedml_tpu_torch.obs.fleet import FleetCollector

            self.fleet = FleetCollector(run_id=self.events.run_id,
                                        job=fleet_job,
                                        registry=self.registry,
                                        expected_ranks=expected_ranks,
                                        health=self.health)
            # with the plane armed and a file-backed run, arm the crash
            # flight recorder too (no recorder installed yet — a launcher
            # that installed its own wins): its dumps land next to the
            # event log, where report.py --post-mortem looks first
            from fedml_tpu_torch.obs import flightrec as _flightrec

            if log_dir and _flightrec.active_recorder() is None:
                _flightrec.install_flight_recorder(
                    rank=0, run_id=self.events.run_id,
                    out_dir=os.path.join(log_dir, "flightrec"),
                    registry=self.registry)
        if http_port is not None:
            from fedml_tpu_torch.obs.httpd import MetricsHTTPServer

            self.httpd = MetricsHTTPServer(port=http_port, host=http_host,
                                           registry=self.registry,
                                           health=self.health,
                                           fleet=self.fleet)
            self.http_port = self.httpd.port
        # the flight recorder tees every emitted record into its crash
        # ring and dumps on alert-fire; the observer routes through the
        # module-level hook so install order does not matter (no-op until
        # a recorder is armed)
        from fedml_tpu_torch.obs import flightrec as _flightrec

        self.events.add_observer(_flightrec.on_event)
        # round-economics families (obs/goodput.py, obs/perf_instrument.py
        # §compile observatory) pre-register at zero the moment a run arms
        # telemetry — a clean export must carry them, not omit them
        from fedml_tpu_torch.obs import goodput as _goodput
        from fedml_tpu_torch.obs import perf_instrument as _perf_instr

        _goodput.ensure_goodput_families()
        _perf_instr.ensure_compile_attr_families()
        self._header_emitted = False
        self._last_comm = comm_counters(REGISTRY)

    # ------------------------------------------------------------- records
    def run_header(self, config: dict | None = None, **fields) -> None:
        """Emit the run-header record once (idempotent — standalone train()
        and a wrapping launcher may both call it)."""
        if self._header_emitted:
            return
        self._header_emitted = True
        if self.http_port is not None:
            # the bound port (http_port=0 asked for an ephemeral one) —
            # the run header is where a log reader learns where to scrape
            fields.setdefault("http_port", self.http_port)
        if (self.health is not None and self.health.expected_ranks is None
                and isinstance(fields.get("world_size"), int)):
            # the quorum rule's cohort: everyone but the server rank
            self.health.expected_ranks = fields["world_size"] - 1
        if (self.fleet is not None and self.fleet.expected_ranks is None
                and isinstance(fields.get("world_size"), int)):
            self.fleet.expected_ranks = fields["world_size"] - 1
        self.events.emit("run", config=config or {}, **fields)

    def comm_delta(self) -> dict:
        """Comm counter movement since the previous call — the per-round
        byte/message accounting, read from the process-wide registry the
        comm backends record into (see __init__). Cumulative totals ride
        along under ``total_`` so a record is interpretable on its own."""
        now = comm_counters(REGISTRY)
        delta = {k: now[k] - self._last_comm.get(k, 0.0)
                 for k in ("messages_sent", "bytes_sent",
                           "messages_received", "bytes_received",
                           "bytes_uplink", "bytes_downlink")}
        delta["total_bytes_sent"] = now["bytes_sent"]
        delta["total_messages_sent"] = now["messages_sent"]
        # dispatch stats come from a run-cumulative histogram (no per-round
        # reset), so they carry the total_ prefix like the other cumulatives
        if "dispatch_p95_s" in now:
            delta["total_dispatch_p95_s"] = now["dispatch_p95_s"]
            delta["total_dispatch_count"] = now["dispatch_count"]
        self._last_comm = now
        return delta

    def emit_round(self, round_idx: int, clients=None, spans=None,
                   metrics=None, evals=None, **extra) -> dict:
        """The standard per-round record: sampled client ids, host span
        timings (RoundTracer's dict for the round), scalar metrics (already
        floated by the caller), optional eval block, and the comm delta
        since the last round record."""
        rec: dict = {"round": int(round_idx)}
        if clients is not None:
            rec["clients"] = [int(c) for c in clients]
        if spans:
            rec["spans"] = {k: float(v) for k, v in spans.items()}
        if metrics:
            rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        if evals:
            rec["eval"] = {k: (float(v) if isinstance(v, (int, float)) else v)
                           for k, v in evals.items()}
        rec["comm"] = self.comm_delta()
        if self.memwatch is not None:
            # exact-at-emit memory block (the background thread only keeps
            # the gauges fresh between rounds for live scrapes)
            mem = self.memwatch.sample()
            if mem:
                rec["mem"] = mem
        rec.update(extra)
        out = self.events.emit("round", **rec)
        if self.fleet is not None:
            # rank 0's own /fleetz row: round progress + the DP ε and the
            # round-economics figures the record already carries (no wire
            # hop for the server)
            gp = rec.get("goodput") or {}
            fps = gp.get("flops_per_s")
            self.fleet.note_server(
                round_idx, eps=(rec.get("privacy") or {}).get("eps"),
                duty=(gp.get("duty") or {}).get("compute"),
                gflops=(fps / 1e9 if fps else None))
        if self.health is not None:
            # the per-round health hook: every engine that emits a round
            # record (standalone, pipelined drain, sync server, async
            # flush) feeds the rule table through this one seam
            self.health.on_round(out)
        return out

    def emit_eval(self, round_idx: int, evals: dict) -> dict:
        out = self.events.emit(
            "eval", round=int(round_idx),
            eval={k: (float(v) if isinstance(v, (int, float)) else v)
                  for k, v in evals.items()})
        if self.health is not None:
            self.health.on_eval(out)
        return out

    # ------------------------------------------------------------ profiler
    def profile(self, logdir: str):
        """Opt-in torch.profiler bridge: context manager writing a device
        trace (TensorBoard's profiler plugin / Perfetto) to ``logdir`` —
        utils.tracing.trace under the obs roof."""
        from fedml_tpu_torch.utils.tracing import trace

        return trace(logdir)

    # ------------------------------------------------------------- teardown
    def close(self) -> None:
        """Flush and close the event log; when file-backed, also drop a
        Prometheus text dump of the registry next to it. With tracing on
        and a trace_dir, write the stitched Chrome trace (trace.json —
        load it in Perfetto / chrome://tracing)."""
        from fedml_tpu_torch.obs import flightrec as _flightrec

        # final black-box dump before anything is torn down — a clean
        # close leaves the same durable artifact a crash would, so a
        # post-mortem on a *successful* run also renders
        _flightrec.dump_active("close")
        if self.httpd is not None:
            self.httpd.close()
        if self.memwatch is not None:
            self.memwatch.stop()
        if self.health is not None:
            self.health.stop()
        if self.tracer is not None:
            self.tracer.finish()
            if self.trace_dir:
                from fedml_tpu_torch.obs.trace_export import write_chrome_trace

                try:
                    os.makedirs(self.trace_dir, exist_ok=True)
                    write_chrome_trace(
                        self.tracer.spans(),
                        os.path.join(self.trace_dir, "trace.json"))
                except OSError:
                    pass  # read-only dir: in-memory spans still stand
        if self.log_dir:
            try:
                with open(os.path.join(self.log_dir, "metrics.prom"),
                          "w") as f:
                    f.write(self.registry.to_prometheus())
            except OSError:
                pass  # read-only dir: the event log (already flushed) stands
        self.events.close()
