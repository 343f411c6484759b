"""Performance instrumentation, port of fedml_tpu/obs/perf_instrument.py:
the reference's metric families under its names and labels, on the port's
``metrics.REGISTRY``.

**Compile accounting — a documented absence.** The reference counts XLA
compiles and persistent-cache hits through ``jax.monitoring`` listeners
(``fed_xla_*``) and attributes them to jit variants. Eager PyTorch
compiles no program, so there is nothing to listen to: :func:`install`
returns False (the reference's answer when ``jax.monitoring`` is
missing: "uninstrumented", not "no compiles"), :func:`attribute_compiles`
is a no-op scope, :func:`variant_compile_stats` returns ``{}``, and
:func:`ensure_compile_attr_families` registers nothing, so no ``fed_xla_*``
family appears in an export.

**Pipeline metrics** (fed by the engine's pipelined driver and
core/pipeline.py):

    fed_h2d_seconds                   (histogram) host time issuing a round
                                      batch's host->device transfers
    fed_prefetch_stall_seconds        (histogram) time the round driver
                                      waited for the prefetch thread
    fed_dispatch_depth                (gauge) rounds dispatched but not yet
                                      drained

**Aggregation and server-state metrics** (fed by the engine and the flat
and tree aggregators; one device, so ``replicated`` only until sharded
state lands, item 12; the staging gauge reads ``stacked``, ``fused`` or
``fused_staged``):

    fed_agg_bytes_total{mode}         client-update bytes aggregated
    fed_server_state_bytes{placement} (gauge) per-device bytes of the
                                      server plane (model + server opt
                                      state)
    fed_flush_seconds                 (histogram) one server aggregate
                                      flush
    fed_agg_stack_bytes{mode}         (gauge) aggregation-staging bytes of
                                      the last flush

**Buffered-async, secure-aggregation, privacy and crash-recovery
families** follow, as in the reference (the secure-aggregation ones wait
for their tier, item 8.5).

All hooks are host-side and cheap (a dict lookup + float add via memoized
children, the obs/comm_instrument.py pattern).
"""

from __future__ import annotations

import contextlib
import logging
import threading
from functools import lru_cache

from fedml_tpu_torch.obs.metrics import REGISTRY

log = logging.getLogger("fedml_tpu_torch.obs.perf")

_install_lock = threading.Lock()
_installed = False
_tls = threading.local()


@lru_cache(maxsize=8)
def _counter(name: str):
    # lru_cache indirection; every call site passes a fed_* literal
    return REGISTRY.counter(name)  # fedlint: disable=metric-discipline


@lru_cache(maxsize=8)
def _hist(name: str):
    # lru_cache indirection; every call site passes a fed_* literal
    return REGISTRY.histogram(name)  # fedlint: disable=metric-discipline


@lru_cache(maxsize=64)
def _span_hist(name: str):
    # the SAME family RoundTracer spans feed (obs/tracing.py) so the
    # prefetch thread's pack/transfer spans and the engine's host spans
    # read through one Prometheus name
    return REGISTRY.histogram("fed_span_seconds", span=name)


# ---------------------------------------------- per-variant attribution
# The compile observatory (docs/OBSERVABILITY.md §Compile observatory):
# jax.monitoring events fire ON THE COMPILING THREAD, so a thread-local
# variant tag set around a ``.compile()`` call attributes that thread's
# compile/cache events to the jit variant being built. Everything outside
# an :func:`attribute_compiles` scope (first-dispatch jit compiles, eval
# fns, ...) lands under the reserved ``variant="_other"`` child — which
# also gives the families a pre-registerable zero child.
#
#     fed_xla_variant_compile_seconds_total{variant}   backend compile wall
#     fed_xla_variant_compiles_total{variant}          compile passes
#     fed_xla_variant_cache_hits_total{variant}        persistent-cache hits
#     fed_xla_variant_cache_misses_total{variant}      fresh compiles
UNATTRIBUTED_VARIANT = "_other"


@lru_cache(maxsize=256)
def _variant_counter(name: str, variant: str):
    # lru_cache indirection; every call site passes a fed_* literal
    return REGISTRY.counter(name, variant=variant)  # fedlint: disable=metric-discipline


def _compile_variant() -> str:
    return getattr(_tls, "compile_variant", None) or UNATTRIBUTED_VARIANT


@contextlib.contextmanager
def attribute_compiles(variant: str):
    """The reference's compile attribution scope: a no-op here (eager
    PyTorch compiles nothing to attribute)."""
    yield


def variant_compile_stats() -> dict:
    """The compile observatory's read side: always ``{}`` (no compiles are
    observed; see the module docstring)."""
    return {}


def ensure_compile_attr_families() -> None:
    """Registers nothing: the per-variant ``fed_xla_*`` compile families
    have no PyTorch source, and a zero family would read as 'no compiles'
    where the truth is 'not instrumented'."""


# ------------------------------------------------------ compile accounting
def _on_event(name: str, **kw) -> None:
    if name == "/jax/compilation_cache/cache_hits":
        _counter("fed_xla_cache_hits_total").inc()
        _variant_counter("fed_xla_variant_cache_hits_total",
                         _compile_variant()).inc()
    elif name == "/jax/compilation_cache/cache_misses":
        _counter("fed_xla_cache_misses_total").inc()
        _variant_counter("fed_xla_variant_cache_misses_total",
                         _compile_variant()).inc()
    elif name == "/jax/compilation_cache/compile_requests_use_cache":
        _counter("fed_xla_cache_requests_total").inc()


def _on_duration(name: str, secs: float, **kw) -> None:
    if name.endswith("/backend_compile_duration"):
        _counter("fed_xla_compiles_total").inc()
        _hist("fed_xla_compile_seconds").observe(secs)
        variant = _compile_variant()
        _variant_counter("fed_xla_variant_compiles_total", variant).inc()
        _variant_counter("fed_xla_variant_compile_seconds_total",
                         variant).inc(secs)


def install() -> bool:
    """The reference registers ``jax.monitoring`` listeners here. Eager
    PyTorch compiles no program, so there is nothing to listen to: returns
    False, the reference's 'uninstrumented' answer (the compile counters
    stay at 0 and callers must not read that as 'no compiles')."""
    return False


def compiles_total() -> float:
    """XLA backend compile passes so far (callers diff around a phase;
    includes cache-hit deserializes — see module docstring)."""
    return REGISTRY.total("fed_xla_compiles_total")


def cache_hits_total() -> float:
    return REGISTRY.total("fed_xla_cache_hits_total")


def cache_misses_total() -> float:
    return REGISTRY.total("fed_xla_cache_misses_total")


def cache_requests_total() -> float:
    return REGISTRY.total("fed_xla_cache_requests_total")


# ------------------------------------------------------- pipeline metrics
def record_h2d(seconds: float) -> None:
    _hist("fed_h2d_seconds").observe(seconds)
    _span_hist("h2d").observe(seconds)


def record_prefetch_stall(seconds: float) -> None:
    _hist("fed_prefetch_stall_seconds").observe(seconds)


def set_dispatch_depth(n: int) -> None:
    REGISTRY.gauge("fed_dispatch_depth").set(n)


def record_span(name: str, seconds: float) -> None:
    """A host span observed off the engine's RoundTracer (the prefetch
    thread must not touch the tracer's per-round dict — see
    docs/PERFORMANCE.md §Tracing caveat)."""
    _span_hist(name).observe(seconds)


# ---------------------------------------------- fused-aggregation metrics
# docs/PERFORMANCE.md §Fused aggregation. Fed by the cross-process
# aggregator's flush paths:
#
#     fed_flush_seconds                 (histogram) one server aggregate
#                                       flush — ingest-side decode work is
#                                       per-arrival (overlapped), this is
#                                       the barrier-to-new-model latency
#     fed_agg_stack_bytes{mode}         (gauge) peak aggregation-staging
#                                       bytes of the last flush: stacked =
#                                       the full [K, ...] cohort stack,
#                                       fused = live pairwise partials
#                                       (O(log K) on the in-order path)
def record_flush_seconds(seconds: float) -> None:
    _hist("fed_flush_seconds").observe(seconds)


@lru_cache(maxsize=8)
def _agg_stack(mode: str):
    return REGISTRY.gauge("fed_agg_stack_bytes", mode=mode)


def set_agg_stack_bytes(mode: str, nbytes: float) -> None:
    """Peak aggregation-staging bytes of the last flush under ``mode``
    (fused | stacked) — the memory half of the fused-vs-stacked claim."""
    _agg_stack(mode).set(nbytes)


# --------------------------------------------- sharded-server-state metrics
# docs/PERFORMANCE.md §Partitioned server state. ``mode``/``placement`` is
# "replicated" or "sharded" so an A/B run exports both label sets side by
# side and the ~1/ndev per-device scaling is a metrics assertion, not a
# code comment.
@lru_cache(maxsize=8)
def _agg_bytes(mode: str):
    return REGISTRY.counter("fed_agg_bytes_total", mode=mode)


def record_agg_bytes(mode: str, nbytes: float) -> None:
    """Client-update bytes folded through aggregation this round (stacked
    cohort payload: K x model bytes) under the given server-state mode."""
    _agg_bytes(mode).inc(nbytes)


def set_server_state_bytes(placement: str, per_device_bytes: float) -> None:
    """PER-DEVICE resident bytes of the server plane (global model +
    server optimizer state). Sharded runs report ~1/ndev of the
    replicated figure — the acceptance metric for the partitioned
    server state."""
    REGISTRY.gauge("fed_server_state_bytes",
                   placement=placement).set(per_device_bytes)


# ------------------------------------------------ buffered-async metrics
# docs/ROBUSTNESS.md §Asynchronous buffered rounds. Fed by the async server
# mode (distributed/fedavg/server_manager.py) and the virtual-clock
# simulator (core/async_buffer.py) identically:
#
#     fed_buffer_fill_seconds        (histogram) first arrival -> flush of
#                                    each buffered aggregate (virtual
#                                    seconds in the simulator)
#     fed_update_staleness           (histogram; prometheus quantile
#                                    labels) server version at aggregation
#                                    minus the version each folded update
#                                    trained against
#     fed_async_shed_total{reason}   arrivals the ingest path refused or
#                                    evicted: stale (admission bound),
#                                    overflow (backpressure shed-stalest),
#                                    nonfinite (quarantined at the door),
#                                    crash (simulator: dead-rank dispatch)
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


# --------------------------------------- secure aggregation + privacy
# docs/ROBUSTNESS.md §Secure aggregation / §Privacy ledger. Fed by the
# masked secure-aggregation tier (distributed/turboaggregate.py) and the
# DP aggregators (distributed/fedavg_robust.py, algorithms/
# fedavg_robust.py):
#
#     fed_secagg_rounds_total{outcome}    masked rounds by how they
#                                         decoded: full (whole cohort),
#                                         recovered (dropout + mask
#                                         recovery), shed (below the t+1
#                                         threshold / reveal lost —
#                                         round re-broadcast)
#     fed_secagg_dropped_slots_total      cohort slots whose masked
#                                         upload never arrived
#     fed_secagg_recovery_seconds         (histogram) reveal fan-out ->
#                                         last reveal reply per recovery
#     fed_privacy_epsilon                 cumulative DP ε at the ledger's
#                                         reporting δ — the budget the
#                                         privacy_budget health rule
#                                         alerts on
@lru_cache(maxsize=4)
def _secagg_rounds(outcome: str):
    return REGISTRY.counter("fed_secagg_rounds_total", outcome=outcome)


def record_secagg_round(outcome: str) -> None:
    _secagg_rounds(outcome).inc()


@lru_cache(maxsize=1)
def _secagg_dropped():
    return REGISTRY.counter("fed_secagg_dropped_slots_total")


def record_secagg_dropped(n: int) -> None:
    _secagg_dropped().inc(n)


def record_secagg_recovery_seconds(seconds: float) -> None:
    _hist("fed_secagg_recovery_seconds").observe(seconds)


def set_privacy_epsilon(eps: float) -> None:
    REGISTRY.gauge("fed_privacy_epsilon").set(float(eps))


#     fed_privacy_client_epsilon{stat}    per-client ε rollup at the
#                                         ledger's reporting δ: stat=max
#                                         (worst single client — the
#                                         never-under-report figure),
#                                         stat=mean, stat=count (clients
#                                         with any charge). Fed by
#                                         core/privacy.charge_and_record
#                                         when a ClientPrivacyLedger rides
#                                         the round.
@lru_cache(maxsize=4)
def _client_eps(stat: str):
    return REGISTRY.gauge("fed_privacy_client_epsilon", stat=stat)


def set_client_epsilon(eps_max: float, eps_mean: float, count: int) -> None:
    _client_eps("max").set(float(eps_max))
    _client_eps("mean").set(float(eps_mean))
    _client_eps("count").set(float(count))


def ensure_secagg_families() -> None:
    """Pre-register the secure-aggregation outcome children at zero so a
    masked run's Prometheus export always carries the full family."""
    for outcome in ("full", "recovered", "shed"):
        _secagg_rounds(outcome)
    _secagg_dropped()


def ensure_client_privacy_family() -> None:
    """Pre-register the per-client ε gauge children at zero so a DP
    masked run's export always carries the family (even before the first
    charge lands)."""
    for stat in ("max", "mean", "count"):
        _client_eps(stat)


# ---------------------------------------------------- server crash recovery
# docs/ROBUSTNESS.md §Server crash recovery:
#     fed_server_restarts_total          completed server restarts (the
#                                        restart epoch, synced at boot so
#                                        a restarted PROCESS's fresh
#                                        registry still reports the count)
#     fed_restart_epoch                  (gauge) the live restart epoch —
#                                        also on /healthz
#     fed_recovery_seconds               (histogram) checkpoint restore +
#                                        WAL replay wall time per boot
#     fed_ckpt_torn_total                torn checkpoint files skipped by
#                                        restore_latest's fallback
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
    run's Prometheus export carries them (the restart-storm health rule
    and the ci.sh supervised-restart leg read the family, not its
    absence)."""
    _counter("fed_server_restarts_total")
    REGISTRY.gauge("fed_restart_epoch")
    _counter("fed_ckpt_torn_total")
