"""Observability, port of fedml_tpu/obs: the backend-spanning layer every
engine and runtime reports through.

- ``metrics``         — MetricsRegistry: counters / gauges / streaming
                        histograms, the process-wide ``REGISTRY``;
- ``events``          — the structured JSONL EventLog;
- ``comm_instrument`` — wire accounting the comm managers call;
- ``telemetry``       — the ``Telemetry`` bundle engines accept;
- ``export``          — CSV / Prometheus-text / BENCH-blob exporters and
                        the torch.profiler bridge;
- ``tracing``, ``clock``, ``trace_export`` — cross-rank distributed
                        tracing, the clock-offset estimator, Chrome traces;
- ``httpd``           — live per-rank ``/metrics``, ``/healthz`` and
                        ``/fleetz`` (``Telemetry(http_port=)``);
- ``memwatch``        — device-memory (the CUDA caching allocator) /
                        host-RSS gauges and the round record's ``mem``
                        block (``Telemetry(memwatch=True)``);
- ``health``          — the rule-driven ``HealthMonitor``: edge-triggered
                        alerts into the event log + ``fed_alerts_total``;
- ``fleet``           — the fleet plane: ``__telemetry`` digests on uplink
                        frames, rank 0's ``FleetCollector``
                        (``Telemetry(fleet=True)``);
- ``goodput``         — round economics: exclusive duty buckets, FLOPs/s,
                        MFU;
- ``perf_instrument`` — the reference's performance families (its XLA
                        compile observatory is a documented absence);
- ``flightrec``       — the crash flight recorder;
- ``provenance``      — the BENCH blobs' provenance block.

metrics, events, comm_instrument, clock, tracing, trace_export, flightrec,
health, httpd, fleet and export are copies of the reference's; memwatch,
goodput, perf_instrument and provenance diverge only where the reference
asks JAX (named functions, test-pinned).
"""

from fedml_tpu_torch.obs.comm_instrument import comm_counters
from fedml_tpu_torch.obs.events import EventLog, JsonlSink, MemorySink, read_jsonl
from fedml_tpu_torch.obs.fleet import (TELEMETRY_KEY, DigestEmitter, FleetCollector,
                                 attach_digest)
from fedml_tpu_torch.obs.flightrec import (FlightRecorder, flight_record,
                                     install_flight_recorder,
                                     render_post_mortem,
                                     uninstall_flight_recorder)
from fedml_tpu_torch.obs.health import DEFAULT_RULES, HealthMonitor
from fedml_tpu_torch.obs.httpd import MetricsHTTPServer, start_metrics_server
from fedml_tpu_torch.obs.memwatch import MemoryWatcher
from fedml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from fedml_tpu_torch.obs.telemetry import Telemetry
from fedml_tpu_torch.obs.tracing import (TRACE_KEY, ClientSpanBuffer,
                                   DistributedTracer, RoundTracer)

__all__ = [
    "DEFAULT_RULES",
    "REGISTRY",
    "TELEMETRY_KEY",
    "TRACE_KEY",
    "ClientSpanBuffer",
    "DigestEmitter",
    "DistributedTracer",
    "EventLog",
    "FleetCollector",
    "FlightRecorder",
    "HealthMonitor",
    "JsonlSink",
    "MemorySink",
    "MemoryWatcher",
    "MetricsHTTPServer",
    "MetricsRegistry",
    "RoundTracer",
    "Telemetry",
    "attach_digest",
    "comm_counters",
    "flight_record",
    "install_flight_recorder",
    "read_jsonl",
    "render_post_mortem",
    "start_metrics_server",
    "uninstall_flight_recorder",
]
