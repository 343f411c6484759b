"""Device-memory + host-RSS telemetry, port of fedml_tpu/obs/memwatch.py.

A run that exhausts device memory fails late and opaquely (an allocation
error rounds in, long after the growth started); host-side leaks on a
million-client simulation kill the box the same way. This sampler makes
both visible while the run is still alive:

- per-device stats from the CUDA caching allocator
  (``torch.cuda.memory_stats(i)``: allocated bytes now and at peak, and
  the card's total memory as the limit), each device labeled ``gpu:<i>``
  as a JAX CUDA device is, so a mixed job reads one way. Only a process
  that has already initialized CUDA reports: the sampler never creates a
  CUDA context, and a CPU run degrades to a graceful no-op (host RSS
  still reports);
- host RSS from ``/proc/self/status`` (``VmRSS``), the same figure ``top``
  shows — absent on non-procfs hosts, again a graceful no-op.

Gauges (process registry, scraped live via obs/httpd and dumped at close):

    fed_device_bytes_in_use{device}     current allocated bytes per device
    fed_device_peak_bytes{device}       high-water mark per device
    fed_device_bytes_limit{device}      the card's memory (feeds the
                                        health rule table's device_memory
                                        fraction, obs/health.py)
    fed_host_rss_bytes                  resident set size of this process

Opt-in via ``Telemetry(memwatch=...)``: a background daemon thread samples
every ``interval_s`` so scrapes between rounds stay fresh, and
``sample()`` runs synchronously at each round record so the ``mem`` block
on round records is exact-at-emit, not up-to-interval stale. Off (the
default): zero threads, zero gauges, nothing.
"""

from __future__ import annotations

import logging
import threading

from fedml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("fedml_tpu_torch.obs.memwatch")


def host_rss_bytes() -> int | None:
    """Resident set size from ``/proc/self/status`` (VmRSS, kB); None where
    procfs is absent — callers must treat None as 'unknown', not 0."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def device_memory_stats() -> dict[str, dict]:
    """{device-label: {bytes_in_use, peak_bytes, bytes_limit}} over the
    CUDA devices of a process that has ALREADY initialized CUDA (a sampler
    thread must never create a context in a CPU run on a box with a
    card). ``bytes_in_use`` / ``peak_bytes`` are the caching allocator's
    allocated bytes now and at peak (``torch.cuda.max_memory_allocated``),
    ``bytes_limit`` the card's total memory. An empty dict means 'nothing
    to report', never 'zero bytes'."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return {}
        count = torch.cuda.device_count()
    except Exception:  # noqa: BLE001 — no torch / CUDA not up: no stats
        log.debug("device memory stats unavailable (no CUDA context)",
                  exc_info=True)
        return {}
    out: dict[str, dict] = {}
    for i in range(count):
        try:
            stats = torch.cuda.memory_stats(i)
            limit = torch.cuda.get_device_properties(i).total_memory
        except Exception:  # noqa: BLE001 — per-device probe is best-effort
            log.debug("memory_stats probe failed on cuda:%d", i,
                      exc_info=True)
            continue
        out[f"gpu:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(limit),
        }
    return out


class MemoryWatcher:
    """Background sampler feeding the memory gauges. ``sample()`` is also
    callable synchronously (Telemetry calls it at every round record) and
    returns the compact ``mem`` block the event schema carries."""

    def __init__(self, interval_s: float = 5.0,
                 registry: MetricsRegistry | None = None):
        self.interval_s = float(interval_s)
        self.registry = registry or REGISTRY
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.last: dict | None = None  # most recent sample (health rules)

    # -------------------------------------------------------------- sampling
    def sample(self) -> dict:
        """One synchronous sample: update the gauges, remember it for the
        health rules, and return the round-record ``mem`` block —
        {host_rss_bytes, device_bytes_in_use, device_peak_bytes} with
        absent sources omitted (the block must stay honest on CPU)."""
        block: dict = {}
        rss = host_rss_bytes()
        if rss is not None:
            self.registry.gauge("fed_host_rss_bytes").set(rss)
            block["host_rss_bytes"] = rss
        devs = device_memory_stats()
        for label, st in devs.items():
            self.registry.gauge("fed_device_bytes_in_use",
                                device=label).set(st["bytes_in_use"])
            self.registry.gauge("fed_device_peak_bytes",
                                device=label).set(st["peak_bytes"])
            if st["bytes_limit"]:
                self.registry.gauge("fed_device_bytes_limit",
                                    device=label).set(st["bytes_limit"])
        if devs:
            block["device_bytes_in_use"] = sum(
                st["bytes_in_use"] for st in devs.values())
            block["device_peak_bytes"] = max(
                st["peak_bytes"] for st in devs.values())
        snap = {"host_rss_bytes": rss, "devices": devs}
        with self._lock:
            self.last = snap
        return block

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MemoryWatcher":
        """Arm the background thread (idempotent). One immediate sample so
        gauges exist before the first interval elapses."""
        if self._thread is not None:
            return self
        self.sample()
        self._thread = threading.Thread(target=self._loop,
                                        name="obs-memwatch", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — telemetry must never kill a run
                log.exception("memory sample failed (continuing)")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
