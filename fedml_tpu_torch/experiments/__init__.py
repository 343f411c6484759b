"""Command-line entry points, port of fedml_tpu/experiments: the
cross-process launcher (``distributed_launch``). The single-process CLI is
queued in ROADMAP.md (queue A, item 13)."""
