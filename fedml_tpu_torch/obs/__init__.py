"""Observability, port of fedml_tpu/obs. This slice carries the
framework-free wire accounting the comm layer reports through: ``metrics``
(the process-wide ``REGISTRY`` of counters, gauges and histograms) and
``comm_instrument`` (messages, bytes by codec and direction, dispatch
latency, corrupt frames, stale uploads), both copies of the reference's.
Telemetry, tracing, health and memory gauges are queued in ROADMAP.md
(queue A, item 8)."""
