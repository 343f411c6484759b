"""Performance instrumentation, port of fedml_tpu/obs/perf_instrument.py:
the metric families of buffered-async rounds and of server crash
recovery, under the reference's names and labels, on the port's
``metrics.REGISTRY``.

**Buffered-async metrics** (fed by the async server mode,
distributed/fedavg/server_manager.py):

    fed_buffer_fill_seconds        (histogram) first arrival -> flush of
                                   each buffered aggregate
    fed_update_staleness           (histogram) server version at
                                   aggregation minus the version each
                                   folded update trained against
    fed_async_shed_total{reason}   arrivals the ingest path refused or
                                   evicted: stale (admission bound),
                                   overflow (backpressure shed-stalest),
                                   nonfinite (quarantined at the door),
                                   suspect (heartbeat admission),
                                   undecodable, server_restart, ...

**Crash-recovery metrics** (fed by the server's boot path and
core/checkpoint.py):

    fed_server_restarts_total      server boots past the first (the WAL's
                                   restart epoch, synced at boot so a
                                   restarted PROCESS's fresh registry
                                   still reports the count)
    fed_restart_epoch              (gauge) the live restart epoch
    fed_recovery_seconds           (histogram) checkpoint restore + WAL
                                   replay wall time per boot
    fed_ckpt_torn_total            torn checkpoint files skipped by
                                   restore_latest's fallback

**Privacy metrics** (fed by core/privacy.charge_and_record, the DP
defenses' one step-then-surface sequence):

    fed_privacy_epsilon            (gauge) cumulative ε at the ledger's
                                   reporting δ
    fed_privacy_client_epsilon{stat}  per-client ε rollup: stat=max (the
                                   worst client, the never-under-report
                                   figure), mean, count (clients charged)

The reference's compile observatory (``jax.monitoring`` listeners), its
pipeline, sharded-server-state, fused-flush and secure-aggregation
families are queued in ROADMAP.md (queue A, item 8; the compile
observatory has no PyTorch counterpart to listen to).

All hooks are host-side and cheap (a dict lookup + float add via memoized
children, the obs/comm_instrument.py pattern).
"""

from __future__ import annotations

from functools import lru_cache

from fedml_tpu_torch.obs.metrics import REGISTRY


@lru_cache(maxsize=8)
def _counter(name: str):
    return REGISTRY.counter(name)


@lru_cache(maxsize=8)
def _hist(name: str):
    return REGISTRY.histogram(name)


# ------------------------------------------------ buffered-async metrics
def record_buffer_fill(seconds: float) -> None:
    _hist("fed_buffer_fill_seconds").observe(seconds)


def record_update_staleness(staleness: float) -> None:
    _hist("fed_update_staleness").observe(float(staleness))


@lru_cache(maxsize=16)
def _async_shed(reason: str):
    return REGISTRY.counter("fed_async_shed_total", reason=reason)


def record_async_shed(reason: str) -> None:
    _async_shed(reason).inc()


def ensure_async_shed_families() -> None:
    """Pre-register every shed-reason child at zero so an async run's
    Prometheus export always carries the full family — a clean run must
    read as 'nothing shed', not 'metric missing'."""
    # mirrors core/async_buffer.SHED_REASONS (obs must not import core —
    # the dependency points the other way; drift is test-pinned)
    for reason in ("stale", "overflow", "nonfinite", "crash", "suspect",
                   "undecodable", "server_restart", "offline"):
        _async_shed(reason)


# ----------------------------------------------- crash-recovery metrics
def sync_server_restarts(epoch: int) -> None:
    """Bring ``fed_server_restarts_total`` up to the WAL's restart epoch:
    a restarted process boots with a fresh registry, so the counter is
    advanced by the DELTA between the journaled epoch and whatever this
    process already counted (simulated in-process restarts inc once per
    boot; a twice-restarted real process lands at 2 in one step)."""
    delta = float(epoch) - REGISTRY.total("fed_server_restarts_total")
    if delta > 0:
        _counter("fed_server_restarts_total").inc(delta)
    REGISTRY.gauge("fed_restart_epoch").set(float(epoch))


def record_recovery_seconds(seconds: float) -> None:
    _hist("fed_recovery_seconds").observe(seconds)


def record_ckpt_torn() -> None:
    _counter("fed_ckpt_torn_total").inc()


def ensure_restart_families() -> None:
    """Pre-register the crash-recovery families at zero so any WAL-armed
    run's Prometheus export carries them."""
    _counter("fed_server_restarts_total")
    REGISTRY.gauge("fed_restart_epoch")
    _counter("fed_ckpt_torn_total")


# ---------------------------------------------------------------- privacy
def set_privacy_epsilon(eps: float) -> None:
    REGISTRY.gauge("fed_privacy_epsilon").set(float(eps))


@lru_cache(maxsize=4)
def _client_eps(stat: str):
    return REGISTRY.gauge("fed_privacy_client_epsilon", stat=stat)


def set_client_epsilon(eps_max: float, eps_mean: float, count: int) -> None:
    _client_eps("max").set(float(eps_max))
    _client_eps("mean").set(float(eps_mean))
    _client_eps("count").set(float(count))


def ensure_client_privacy_family() -> None:
    """Pre-register the per-client ε gauge children at zero so a DP run's
    export always carries the family (even before the first charge)."""
    for stat in ("max", "mean", "count"):
        _client_eps(stat)
