"""Exporters, port of fedml_tpu/obs/export.py — turn a run's telemetry
into files other tools consume.

- ``write_csv``: round records -> CSV (spreadsheet/pandas-friendly; nested
  record blocks are flattened to dotted columns);
- ``write_prometheus``: registry -> text exposition file (node_exporter
  textfile-collector shape — drop it in a scrape directory);
- ``bench_blob``: round records -> the BENCH_r*.json-compatible one-line
  summary (same keys as bench.py's ``_result``), so a telemetry run can
  stand in for a bench run in dashboards;
- ``profile_trace``: re-export of the torch.profiler bridge
  (utils/tracing.py).
"""

from __future__ import annotations

import csv

from fedml_tpu_torch.obs.metrics import MetricsRegistry
from fedml_tpu_torch.utils.tracing import trace as profile_trace  # noqa: F401


def _flatten(rec: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in rec.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        elif isinstance(v, list):
            out[key] = " ".join(str(e) for e in v)
        else:
            out[key] = v
    return out


def write_csv(records: list[dict], path: str,
              kinds: tuple[str, ...] = ("round",)) -> list[str]:
    """Write selected event records as CSV; returns the column list. The
    header is the union of flattened keys over all rows (JSONL records are
    heterogeneous — eval blocks only exist on eval rounds)."""
    rows = [_flatten(r) for r in records if r.get("kind") in kinds]
    cols: list[str] = []
    for r in rows:
        for k in r:
            if k not in cols:
                cols.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    return cols


def write_prometheus(registry: MetricsRegistry, path: str) -> None:
    with open(path, "w") as f:
        f.write(registry.to_prometheus())


def bench_blob(records: list[dict], metric: str = "fedavg_rounds_per_sec",
               platform: str | None = None) -> dict:
    """BENCH-compatible summary from a run's round records.

    Throughput comes from the span timings when present (sum of per-round
    'round' spans — host dispatch + device wait, the same thing bench.py's
    per_round mode times), falling back to event-timestamp extent. Comm
    totals ride along so a wire-heavy run is legible from the blob alone."""
    rounds = [r for r in records if r.get("kind") == "round"]
    if not rounds:
        raise ValueError("no round records in event log")
    span_total = sum(r.get("spans", {}).get("round", 0.0) for r in rounds)
    blocks = [r for r in records if r.get("kind") == "block"]
    block_span = sum(b.get("spans", {}).get("round", 0.0) for b in blocks)
    block_rounds = sum(int(b.get("rounds", 0)) for b in blocks)
    n = len(rounds)
    if span_total > 0:
        # span basis: every round's host-span is measured, so n rounds
        # took span_total seconds
        rate = n / span_total
        basis = "span"
    elif block_span > 0 and block_rounds > 0:
        # block engine: round records are replayed from the scanned block
        # AFTER it executes (their timestamps are microseconds apart and
        # carry no spans) — the real execution time lives on the 'block'
        # events
        rate = block_rounds / block_span
        basis = "block_span"
    else:
        # ts basis (last resort): n record timestamps bound only the n-1
        # intervals BETWEEN rounds (the first round's duration precedes
        # its record)
        ts = [r["ts"] for r in rounds if isinstance(r.get("ts"), (int, float))]
        secs = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
        rate = (n - 1) / secs if secs > 0 else None
        basis = "ts"
    blob = {
        "metric": metric,
        "value": round(rate, 3) if rate else None,
        "unit": "rounds/sec",
        "mode": "telemetry",
        "rounds": n,
        "basis": basis,
    }
    if platform:
        blob["platform"] = platform
    bytes_sent = sum(r.get("comm", {}).get("bytes_sent", 0.0) for r in rounds)
    msgs = sum(r.get("comm", {}).get("messages_sent", 0.0) for r in rounds)
    if msgs:
        blob["comm_bytes_sent"] = int(bytes_sent)
        blob["comm_messages_sent"] = int(msgs)
    evals = [r["eval"] for r in records
             if r.get("kind") in ("round", "eval") and r.get("eval")]
    if evals and "test_acc" in evals[-1]:
        blob["final_test_acc"] = evals[-1]["test_acc"]
    return blob
