"""Metrics registry — counters, gauges, streaming histograms, label families.

The reference has no metrics layer at all (SURVEY §5: its observability is
ad-hoc wall-clock prints, FedAVGAggregator.py:59,85-86); FedJAX and
FL_PyTorch both standardize per-round metrics as a simulator feature. This
registry is the process-wide substrate every fedml_tpu layer reports
through: comm backends count messages/bytes into it (obs/comm_instrument),
engines fold round stats into it, and exporters dump it as JSON or
Prometheus text (obs/export).

Design constraints:
- host-side only — nothing here ever runs under jit, so an increment is a
  dict lookup + float add (the comm receive loop calls it per message);
- bounded memory — histograms are geometric-bucketed (no sample retention),
  so a million observations cost the same as ten;
- thread-safe — comm backends dispatch from their own threads.
"""

from __future__ import annotations

import math
import threading


class Counter:
    """Monotonic float counter."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self.value += amount


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Histogram:
    """Streaming histogram with geometric buckets — O(1) memory, quantile
    estimates within half a bucket ratio (default 10 buckets/decade ->
    <= ~12% relative error), exact count/sum/min/max.

    The default span (1 µs .. 10 ks) covers everything this codebase times:
    queue-dispatch latency (µs), round/pack spans (ms..s), compiles (s..min).
    Values outside the span clamp into the edge buckets (still counted
    exactly in count/sum/min/max).
    """

    __slots__ = ("_lo", "_ratio", "_log_ratio", "_buckets", "count", "total",
                 "vmin", "vmax", "_lock")

    def __init__(self, lock: threading.Lock, lo: float = 1e-6,
                 hi: float = 1e4, buckets_per_decade: int = 10):
        self._lo = lo
        self._ratio = 10.0 ** (1.0 / buckets_per_decade)
        self._log_ratio = math.log(self._ratio)
        n = int(math.ceil(math.log(hi / lo) / self._log_ratio)) + 1
        self._buckets = [0] * n
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = lock

    def _index(self, v: float) -> int:
        if v <= self._lo:
            return 0
        i = int(math.log(v / self._lo) / self._log_ratio)
        return min(i, len(self._buckets) - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._buckets[self._index(v)] += 1
            self.count += 1
            self.total += v
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)

    def _quantile_locked(self, q: float) -> float:
        """Caller holds self._lock."""
        if not self.count:
            return math.nan
        rank = q * (self.count - 1)
        seen = 0
        for i, c in enumerate(self._buckets):
            if not c:
                continue
            if seen + c > rank:
                # geometric bucket midpoint, clamped to the observed range
                mid = self._lo * self._ratio ** (i + 0.5)
                return min(max(mid, self.vmin), self.vmax)
            seen += c
        return self.vmax

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1); nan when empty."""
        with self._lock:
            return self._quantile_locked(q)

    def summary(self) -> dict:
        """Consistent snapshot: every field comes from ONE lock acquisition,
        so a concurrent observe() cannot tear mean (count/total from
        different instants) or make the quantiles reflect three different
        populations."""
        with self._lock:
            if not self.count:
                return {"count": 0}
            return {
                "count": self.count,
                "sum": self.total,
                "mean": self.total / self.count,
                "min": self.vmin,
                "max": self.vmax,
                "p50": self._quantile_locked(0.50),
                "p95": self._quantile_locked(0.95),
                "p99": self._quantile_locked(0.99),
            }


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Labeled metric families: ``registry.counter(name, **labels)`` returns
    the (created-once) child for that label set. ``snapshot()`` gives a
    plain-dict view; ``to_prometheus()`` the text exposition format."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, {label_key: metric})
        self._families: dict[str, tuple[str, dict]] = {}

    def _child(self, kind: str, factory, name: str, labels: dict):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, {})
                self._families[name] = fam
            if fam[0] != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{fam[0]}, not {kind}")
            child = fam[1].get(key)
            if child is None:
                # per-metric lock: observation hot paths (the comm receive
                # loop) must not serialize against unrelated metrics — the
                # registry lock guards only family-dict mutation
                child = factory(threading.Lock())
                fam[1][key] = child
            return child

    def counter(self, name: str, **labels) -> Counter:
        return self._child("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._child("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._child("histogram", Histogram, name, labels)

    def remove(self, name: str, **labels) -> bool:
        """Drop one child from a family (True when it existed). The
        cardinality-maintenance escape hatch for per-rank gauges on
        fleet-sized cohorts (obs/comm_instrument heartbeat cap) — callers
        must also invalidate any memo holding the dropped child, or later
        writes land on an orphan the export never sees."""
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return False
            return fam[1].pop(key, None) is not None

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """{name: {labels-as-sorted-tuple-str: value | histogram summary}}.
        Scalars for counters/gauges; ``Histogram.summary()`` dicts for
        histograms. Keys are stable strings so the snapshot is jsonable."""
        with self._lock:
            fams = {n: (k, dict(c)) for n, (k, c) in self._families.items()}
        out: dict = {}
        for name, (kind, children) in sorted(fams.items()):
            fam_out = {}
            for key, m in sorted(children.items()):
                label_s = ",".join(f"{k}={v}" for k, v in key)
                fam_out[label_s] = (m.summary() if kind == "histogram"
                                    else m.value)
            out[name] = fam_out
        return out

    def total(self, name: str) -> float:
        """Sum of a counter/gauge family over all label sets (0.0 when the
        family does not exist — callers diff totals between rounds)."""
        with self._lock:
            fam = self._families.get(name)
            children = list(fam[1].values()) if fam else []
        return float(sum(c.value for c in children))

    def to_prometheus(self) -> str:
        """Prometheus text exposition (counters/gauges as-is; histograms as
        _count/_sum plus quantile gauges — the summary-metric convention)."""
        with self._lock:
            fams = {n: (k, dict(c)) for n, (k, c) in self._families.items()}
        lines = []
        for name, (kind, children) in sorted(fams.items()):
            lines.append(f"# TYPE {name} "
                         f"{'summary' if kind == 'histogram' else kind}")
            for key, m in sorted(children.items()):
                lb = "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}" \
                    if key else ""
                if kind == "histogram":
                    s = m.summary()  # one consistent snapshot for all lines
                    lines.append(f"{name}_count{lb} {s.get('count', 0)}")
                    lines.append(f"{name}_sum{lb} {s.get('sum', 0.0)}")
                    for q, sk in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                        tag = dict(key)
                        tag["quantile"] = q
                        qlb = "{" + ",".join(f'{k}="{v}"'
                                             for k, v in sorted(tag.items())) + "}"
                        lines.append(f"{name}{qlb} {s.get(sk, math.nan)}")
                else:
                    lines.append(f"{name}{lb} {m.value}")
        return "\n".join(lines) + "\n"


# Process-wide default registry. Comm backends record into this one (they
# have no construction-time hook to receive another), and Telemetry snapshots
# it by default — so a loopback simulation's many in-process managers all
# fold into the same counters, exactly like one server process would.
REGISTRY = MetricsRegistry()
