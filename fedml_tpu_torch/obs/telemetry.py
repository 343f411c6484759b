"""Telemetry — the bundle engines and launchers pass around, port of
fedml_tpu/obs/telemetry.py.

One object ties together the obs primitives this port carries:

- a ``MetricsRegistry`` (defaults to the process-wide one, so comm-layer
  counters recorded by the backends show up in this run's round records);
- an ``EventLog`` over a rotating JSONL file (``log_dir/events.jsonl``) or
  an in-memory sink (tests);
- optionally a ``DistributedTracer`` (``trace_dir=``/``trace=True``) — the
  cross-rank per-round trace stitcher (obs/tracing.py); ``close()`` writes
  its Chrome trace-event JSON to ``trace_dir``.

The reference's live run-health layer (``http_port``, ``memwatch``,
``health``/``health_rules``, ``fleet`` and the flight recorder it arms),
its round-economics families (goodput, the compile observatory) and its
``jax.profiler`` bridge ``profile()`` are queued in ROADMAP.md (queue A,
item 8): asking for one raises NotImplementedError.

Contract with the engines: a ``telemetry=None`` engine does exactly the
work it did before telemetry — no extra device syncs, no host work. All
cost is opt-in.
"""

from __future__ import annotations

import os

from fedml_tpu_torch.obs.comm_instrument import comm_counters
from fedml_tpu_torch.obs.events import EventLog, JsonlSink, MemorySink
from fedml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry


def _unported(what: str):
    return NotImplementedError(f"Telemetry {what} is not ported yet: "
                               "ROADMAP.md queue A, item 8")


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
        for what, is_set in (("http_port", http_port is not None),
                             ("memwatch", bool(memwatch)),
                             ("health", bool(health)),
                             ("health_rules", health_rules is not None),
                             ("fleet", bool(fleet))):
            if is_set:
                raise _unported(what)
        self.log_dir = log_dir
        # ``registry`` is where THIS bundle's own metrics live and what
        # close() dumps. Comm deltas always read the process-wide REGISTRY
        # regardless — the comm backends hard-wire their counters there.
        self.registry = registry or REGISTRY
        if sink is None:
            sink = (JsonlSink(os.path.join(log_dir, "events.jsonl"),
                              max_bytes=rotate_bytes, backups=backups)
                    if log_dir else MemorySink())
        self.events = EventLog(sink, run_id=run_id)
        # round_stats=False: keep the event stream but skip the engine's
        # update-norm/drift stats (comm counters stay on)
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
        self._header_emitted = False
        self._last_comm = comm_counters(REGISTRY)

    # ------------------------------------------------------------- records
    def run_header(self, config: dict | None = None, **fields) -> None:
        """Emit the run-header record once (idempotent — standalone train()
        and a wrapping launcher may both call it)."""
        if self._header_emitted:
            return
        self._header_emitted = True
        self.events.emit("run", config=config or {}, **fields)

    def comm_delta(self) -> dict:
        """Comm counter movement since the previous call — the per-round
        byte/message accounting, read from the process-wide registry the
        comm backends record into. Cumulative totals ride along under
        ``total_`` so a record is interpretable on its own."""
        now = comm_counters(REGISTRY)
        delta = {k: now[k] - self._last_comm.get(k, 0.0)
                 for k in ("messages_sent", "bytes_sent",
                           "messages_received", "bytes_received",
                           "bytes_uplink", "bytes_downlink")}
        delta["total_bytes_sent"] = now["bytes_sent"]
        delta["total_messages_sent"] = now["messages_sent"]
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
        rec.update(extra)
        return self.events.emit("round", **rec)

    def emit_eval(self, round_idx: int, evals: dict) -> dict:
        return self.events.emit(
            "eval", round=int(round_idx),
            eval={k: (float(v) if isinstance(v, (int, float)) else v)
                  for k, v in evals.items()})

    # ------------------------------------------------------------ profiler
    def profile(self, logdir: str):
        """The reference's jax.profiler bridge; its torch.profiler
        counterpart is not ported yet."""
        raise _unported("profile()")

    # ------------------------------------------------------------- teardown
    def close(self) -> None:
        """Flush and close the event log; when file-backed, also drop a
        Prometheus text dump of the registry next to it. With tracing on
        and a trace_dir, write the stitched Chrome trace (trace.json —
        load it in Perfetto / chrome://tracing)."""
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
