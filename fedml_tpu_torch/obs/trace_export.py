"""Trace exporters — Chrome trace-event JSON + the critical-path renderer.

- ``to_chrome_trace`` / ``write_chrome_trace``: the stitched span list as
  Chrome trace-event JSON (the ``traceEvents`` array of complete events),
  loadable in Perfetto (https://ui.perfetto.dev) or chrome://tracing; one
  ``pid`` track per rank, timestamps rebased to the earliest span so the
  file is stable under an injected clock (the golden test);
- ``validate_spans`` / ``validate_chrome_trace``: the span-schema checks
  the CI smoke step runs against an emitted trace;
- ``render_critical_path``: the text report behind
  ``scripts/report.py --critical-path``.

Span schema (documented in docs/OBSERVABILITY.md):

    {"tid": <16-hex trace id>, "sid": <16-hex span id>,
     "parent": <span id | null>, "rank": <int>, "name": <str>,
     "t0": <seconds>, "t1": <seconds>, "attrs": {...}?}
"""

from __future__ import annotations

import json

from fedml_tpu_torch.obs.tracing import PHASES

_REQUIRED = ("tid", "sid", "parent", "rank", "name", "t0", "t1")


def validate_spans(spans: list[dict]) -> list[str]:
    """Schema errors (empty list = valid): required fields, non-negative
    durations, parent references resolving within the same trace."""
    errors: list[str] = []
    by_trace: dict[str, set] = {}
    for s in spans:
        by_trace.setdefault(s.get("tid", ""), set()).add(s.get("sid"))
    for i, s in enumerate(spans):
        missing = [k for k in _REQUIRED if k not in s]
        if missing:
            errors.append(f"span[{i}] missing fields {missing}")
            continue
        if not (isinstance(s["t0"], (int, float))
                and isinstance(s["t1"], (int, float))):
            errors.append(f"span[{i}] ({s['name']}) non-numeric timestamps")
        elif s["t1"] < s["t0"]:
            errors.append(f"span[{i}] ({s['name']}) ends before it starts")
        if s["parent"] is not None and \
                s["parent"] not in by_trace.get(s["tid"], ()):
            errors.append(f"span[{i}] ({s['name']}) dangling parent "
                          f"{s['parent']!r}")
    return errors


def to_chrome_trace(spans: list[dict]) -> dict:
    """Chrome trace-event JSON: metadata events naming one process per
    rank, then every span as a complete ('X') event. Timestamps are µs
    rebased to the earliest span; events are sorted so the output is a
    pure function of the span list."""
    spans = sorted(spans, key=lambda s: (s["t0"], s["rank"], s["sid"]))
    base = spans[0]["t0"] if spans else 0.0
    events: list[dict] = []
    for rank in sorted({s["rank"] for s in spans}):
        role = "server" if rank == 0 else "client"
        events.append({"ph": "M", "name": "process_name", "pid": rank,
                       "tid": rank, "args": {"name": f"rank {rank} ({role})"}})
    for s in spans:
        args = {"trace_id": s["tid"], "span_id": s["sid"],
                "parent_id": s["parent"]}
        args.update(s.get("attrs") or {})
        events.append({
            "ph": "X", "cat": "fed", "name": s["name"],
            "pid": s["rank"], "tid": s["rank"],
            "ts": round((s["t0"] - base) * 1e6, 3),
            "dur": round((s["t1"] - s["t0"]) * 1e6, 3),
            "args": args,
        })
    return {"displayTimeUnit": "ms", "traceEvents": events}


def write_chrome_trace(spans: list[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans), f, indent=1, sort_keys=True)


def validate_chrome_trace(doc: dict) -> list[str]:
    """Errors in an exported Chrome trace document (the CI gate)."""
    errors: list[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph == "M":
            if e.get("name") != "process_name" or "pid" not in e:
                errors.append(f"event[{i}] malformed metadata")
        elif ph == "X":
            for k in ("name", "ts", "dur", "pid", "tid"):
                if k not in e:
                    errors.append(f"event[{i}] missing {k!r}")
                    break
            else:
                if e["dur"] < 0 or e["ts"] < 0:
                    errors.append(f"event[{i}] negative ts/dur")
        else:
            errors.append(f"event[{i}] unknown phase {ph!r}")
    if not any(e.get("ph") == "X" for e in events):
        errors.append("no span events")
    return errors


# --------------------------------------------------------- critical path text
def _fmt_s(v: float) -> str:
    return f"{v * 1e3:.1f}ms" if v < 1.0 else f"{v:.3f}s"


def render_critical_path(records: list[dict]) -> str:
    """Per-round critical-path text from event-log round records. Degrades
    gracefully on pre-tracing logs (records without ``critical_path``)."""
    rounds = [r for r in records if r.get("kind") == "round"]
    cps = [(r.get("round"), r.get("critical_path")) for r in rounds
           if r.get("critical_path")]
    if not cps:
        return ("(no critical-path records — log predates cross-rank "
                "tracing or the run had no --trace-dir)")
    lines = []
    for rnd, cp in cps:
        head = (f"round {rnd}: rank {cp.get('straggler')} on the critical "
                f"path ({_fmt_s(float(cp.get('round_s', 0.0)))} round)")
        chaos = cp.get("chaos_delay_s") or {}
        if chaos:
            inj = ", ".join(f"rank {r} +{_fmt_s(float(s))}"
                            for r, s in sorted(chaos.items()))
            head += f"  [chaos: {inj}]"
        if cp.get("missing"):
            head += f"  [never reported: ranks {cp['missing']}]"
        lines.append(head)
        phases = cp.get("phases") or {}
        ordered = [p for p in PHASES if p in phases] + \
            sorted(set(phases) - set(PHASES))
        if ordered:
            lines.append("  phases: " + "  ".join(
                f"{p}={_fmt_s(float(phases[p]))}" for p in ordered))
        slack = cp.get("slack_s") or {}
        others = {r: s for r, s in slack.items()
                  if str(r) != str(cp.get("straggler"))}
        if others:
            lines.append("  slack:  " + "  ".join(
                f"rank {r}={_fmt_s(float(s))}"
                for r, s in sorted(others.items(), key=lambda kv: str(kv[0]))))
    return "\n".join(lines)
