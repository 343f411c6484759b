"""Live run-health HTTP endpoints — per-rank ``/metrics`` + ``/healthz``.

Everything the obs stack exposes today is post-hoc: ``Telemetry.close()``
dumps ``metrics.prom``, ``scripts/report.py`` reads a finished event log.
A *running* fleet — a stalled async server, a diverging loss, an
HBM-exhausted mesh — is invisible until the run ends. This module is the
live view: a stdlib ``ThreadingHTTPServer`` per rank serving

- ``/metrics``  — the process registry as Prometheus text exposition,
  **the same snapshot** ``write_prometheus`` dumps at close (both call
  ``registry.to_prometheus()``), with ``comm_instrument.refresh_liveness()``
  run per scrape so the heartbeat-age gauges are fresh, not
  frozen-at-last-frame;
- ``/healthz``  — a JSON run-health summary (run id, current round,
  ``fed_ranks_alive``, seconds since last progress, quarantine/shed
  totals, status ``ok | degraded | stalled``) read from a
  ``HealthMonitor`` (obs/health.py) when one is attached, else a minimal
  registry-only view;
- ``/fleetz``   — rank 0 only, with the fleet plane armed
  (``Telemetry(fleet=True)``): the ``FleetCollector``'s aggregated JSON
  (per-rank round/staleness/bytes/ε rows, fleet rollups, status —
  obs/fleet.py, docs/OBSERVABILITY.md §Fleet rollup); 404 elsewhere.

Opt-in like every obs feature: ``Telemetry(http_port=...)`` (port 0 binds
an ephemeral port — the bound port is reported in the run header and on
``server.port``), ``--metrics_port`` on the distributed launcher (each
rank binds ``port + rank``; 0 = ephemeral everywhere), and
``FEDML_BENCH_METRICS_PORT`` on bench.py. With the port unset, no socket,
no thread, nothing.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from fedml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("fedml_tpu_torch.obs.httpd")

# Prometheus text exposition content type (node_exporter textfile shape)
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer:
    """One rank's live endpoints. The server thread is a daemon (a hung
    scrape must never block job teardown); handler threads are daemons
    too (``ThreadingHTTPServer.daemon_threads``). ``close()`` is
    idempotent."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: MetricsRegistry | None = None, health=None,
                 fleet=None):
        self.registry = registry or REGISTRY
        # the HealthMonitor feeding /healthz (None -> minimal snapshot)
        self.health = health
        # the FleetCollector feeding /fleetz (None -> 404: only rank 0
        # with the fleet plane armed serves the fleet view)
        self.fleet = fleet
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    if self.path.split("?", 1)[0] in ("/metrics", "/"):
                        body = server.metrics_text().encode()
                        ctype = PROM_CONTENT_TYPE
                    elif self.path.split("?", 1)[0] == "/healthz":
                        body = (json.dumps(server.health_snapshot())
                                + "\n").encode()
                        ctype = "application/json"
                    elif self.path.split("?", 1)[0] == "/fleetz":
                        if server.fleet is None:
                            self.send_error(
                                404, "no fleet collector on this rank "
                                "(rank 0 with the fleet plane armed "
                                "serves /fleetz)")
                            return
                        body = (json.dumps(server.fleet.snapshot(),
                                           default=float) + "\n").encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404, "unknown path "
                                        "(serving /metrics, /healthz, "
                                        "/fleetz)")
                        return
                except Exception:  # noqa: BLE001 — a scrape bug must not
                    #                 kill the handler thread loudly forever
                    log.exception("metrics endpoint failed on %s", self.path)
                    self.send_error(500, "scrape failed (see server log)")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                # scrapes land once per interval per collector — route to
                # the debug log, never stderr (the no-bare-print contract)
                log.debug("httpd: " + fmt, *args)

        try:
            self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        except OSError as e:
            # at fleet scale PORT+rank collides with whatever else the
            # host runs — failing hard would kill the rank over a
            # monitoring port. Fall back to an ephemeral bind, LOUDLY;
            # the bound port rides the run header / server.port so every
            # log reader still learns where to scrape.
            if int(port) == 0:
                raise  # an ephemeral bind that fails is a real error
            log.error("metrics port %d unavailable (%s) — falling back "
                      "to an ephemeral port (the bound port is in the "
                      "run header and this log)", int(port), e)
            self._httpd = ThreadingHTTPServer((host, 0), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])  # bound (0 -> real)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"obs-httpd:{self.port}", daemon=True)
        self._thread.start()
        self._closed = False
        log.info("live metrics endpoint up: http://%s:%d/metrics "
                 "(+ /healthz)", host, self.port)

    # ------------------------------------------------------------ endpoints
    def metrics_text(self) -> str:
        """The /metrics body. refresh_liveness() recomputes every rank's
        heartbeat-age gauge before the snapshot, so a scrape mid-round
        shows real ages; the text itself is ``registry.to_prometheus()`` —
        byte-compatible with the ``metrics.prom`` file ``write_prometheus``
        drops at close (one snapshot path, the scrape-vs-file consistency
        guarantee in docs/OBSERVABILITY.md)."""
        from fedml_tpu_torch.obs.comm_instrument import refresh_liveness

        refresh_liveness()
        return self.registry.to_prometheus()

    def health_snapshot(self) -> dict:
        """The /healthz body. With a HealthMonitor attached this is its
        full verdict (status/alerts/windows); without one, the minimal
        registry-only view a bare metrics server can still answer."""
        if self.health is not None:
            snap = self.health.snapshot()
        else:
            snap = {
                "status": "ok",
                "ranks_alive": self.registry.total("fed_ranks_alive"),
                "quarantine_total": self.registry.total(
                    "fed_updates_rejected_total"),
                "shed_total": self.registry.total("fed_async_shed_total"),
                # server crash recovery: the WAL's restart epoch (0 =
                # never crashed; docs/ROBUSTNESS.md §Server crash
                # recovery)
                "restart_epoch": int(self.registry.total(
                    "fed_restart_epoch")),
            }
        snap["port"] = self.port
        return snap

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    # ------------------------------------------------------------- teardown
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start_metrics_server(port: int = 0, host: str = "127.0.0.1",
                         registry: MetricsRegistry | None = None,
                         health=None) -> MetricsHTTPServer:
    """Standalone entry for ranks that carry no Telemetry bundle (client
    ranks under ``--metrics_port``): bind and serve this process's
    registry. Returns the server (``.port`` is the bound port)."""
    return MetricsHTTPServer(port=port, host=host, registry=registry,
                             health=health)
