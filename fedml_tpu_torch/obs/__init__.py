"""Observability, port of fedml_tpu/obs: ``metrics`` (the process-wide
``REGISTRY`` of counters, gauges and histograms), ``comm_instrument``
(messages, bytes by codec and direction, dispatch latency, corrupt
frames, stale uploads), ``events`` (the JSONL event log), ``clock`` (the
clock-offset estimator), ``tracing`` (``RoundTracer`` host spans, the
client span buffer and the cross-rank ``DistributedTracer``) and
``trace_export`` (Chrome trace JSON) are copies of the reference's;
``telemetry`` is its ``Telemetry`` bundle without the live health layer.
Health, memory gauges, the fleet plane, goodput and the profiler bridge
are queued in ROADMAP.md (queue A, item 8)."""
