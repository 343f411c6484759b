"""Round economics — goodput & duty-cycle accounting, port of
fedml_tpu/obs/goodput.py.

Decomposes each round's wall-clock into EXCLUSIVE buckets and, when the
round variant's FLOP count is known, turns the wall into
useful-FLOPs/s, bytes/s and an MFU-style utilization figure. Three metric
families land in the process-wide ``metrics.REGISTRY``:

    fed_duty_cycle{bucket}            (gauge) fraction of the last round's
                                      wall-clock spent in ``bucket`` — the
                                      six buckets are exclusive and sum to
                                      1.0 by construction
    fed_goodput_flops_per_sec         (gauge) useful device FLOPs/s of the
                                      last round (0 until a variant's cost
                                      analysis is known)
    fed_goodput_bytes_per_sec         (gauge) bytes-accessed/s, same caveat
    fed_goodput_mfu                   (gauge) flops_per_sec / (per-chip
                                      peak x participating devices); 0
                                      when the device kind is unknown —
                                      goodput is then RELATIVE-only
    fed_goodput_rounds_total          rounds with a goodput block emitted

**Buckets** (docs/PERFORMANCE.md §Round economics):

    compute          device execution the driver waited on: the dispatch
                     span plus the measured block-until-ready wait. In
                     pipelined mode the dispatch span is issue-only and the
                     device wait surfaces at the drain sync — both are
                     folded here so sync and pipelined runs are comparable
    h2d              host->device issue time ON the driver's critical path
                     (0 in pipelined mode, where transfers ride the
                     prefetch thread — overlapped time is nobody's wall)
    prefetch_stall   pipelined: time blocked on the prefetch thread;
                     sync: the serial host pack (the stall pipelining
                     exists to hide — so an on/off A/B moves THIS bucket)
    wire_wait        cross-process server: broadcast-done -> last counted
                     arrival; 0 in the standalone engine (no wire)
    agg_flush        server aggregation flush (the standalone engine fuses
                     aggregation into the round program -> counted as
                     compute there)
    drain            the residual: record materialization, eval, broadcast
                     serialize, emit — everything else the driver did
                     serially. Computed as wall minus the other buckets,
                     which is what makes the decomposition exclusive and
                     exactly summing

The decomposition is deliberately *clipped*: buckets are folded in the
order above and each is capped at the wall-clock remaining, so overlapping
or over-reported spans can never make the sum exceed the wall (the
injected-clock oracle in tests/test_goodput.py pins sum == wall).

**Cost model**: ``record_variant_cost(name, flops)`` caches a round
variant's FLOP count under the reference's variant names (``round_b{B}``).
Eager PyTorch compiles no executable to ask for a cost analysis, so the
engine counts the variant's FLOPs itself (utils/flops.py:
``FlopCounterMode`` on the ``meta`` device, 3x forward) and hands the
number in once per variant. ``bytes`` stays None: torch has no
bytes-accessed model, and goodput degrades as the reference does when a
backend reports none — graceful, never raising. Everything here is
host-side and allocation-light, so telemetry-off runs stay bit-identical
(test-enforced).
"""

from __future__ import annotations

import logging
import sys
import threading
from functools import lru_cache

from fedml_tpu_torch.obs.metrics import REGISTRY

log = logging.getLogger("fedml_tpu_torch.obs.goodput")

#: Exclusive duty-cycle buckets, in clip/fold priority order; ``drain`` is
#: always the residual.
BUCKETS = ("compute", "h2d", "prefetch_stall", "wire_wait", "agg_flush",
           "drain")

# The card's dense bf16 peak FLOP/s by device-name substring — the table
# of utils/flops.py (more-specific keys first; the first substring hit of
# the lowercased device name wins). Unknown kinds return None and MFU
# reports 0 (relative-only goodput). f32 runs quote the bf16 peak, the
# reference's convention.
PEAK_FLOPS_BF16 = {
    "h100 pcie": 7.56e14,
    "h100": 9.894e14,
}


def device_peak_flops(device_kind: str | None = None) -> float | None:
    """Per-card peak FLOP/s for ``device_kind`` (defaults to CUDA device
    0's name when torch is already imported and CUDA already initialized —
    never imports torch or initializes CUDA itself). None when unknown:
    MFU then reads 0, goodput is relative-only."""
    if device_kind is None:
        torch_mod = sys.modules.get("torch")
        if torch_mod is None:
            return None
        try:
            if not torch_mod.cuda.is_initialized():
                return None
            device_kind = torch_mod.cuda.get_device_name(0)
        except Exception:  # noqa: BLE001 — detection is best-effort
            log.debug("device-kind detection failed; MFU is relative-only",
                      exc_info=True)
            return None
    kind = str(device_kind).lower()
    for key, peak in PEAK_FLOPS_BF16.items():
        if key in kind:
            return peak
    return None


# ------------------------------------------------------- cost-model cache
_cost_lock = threading.Lock()
_COSTS: dict[str, dict | None] = {}


def record_variant_cost(name: str, flops: float | None) -> dict | None:
    """Cache a round variant's FLOP count under the variant ``name``.

    Returns ``{"flops": float, "bytes": None}``, or None when no count is
    known (a module the counter cannot trace) — callers never see an
    exception. The engine calls it once per variant, the first time a
    telemetry round dispatches it."""
    ent = None
    try:
        if flops is not None and float(flops) > 0:
            ent = {"flops": float(flops), "bytes": None}
    except Exception:  # noqa: BLE001 — cost model is best-effort
        log.debug("no FLOP count for %s", name, exc_info=True)
    with _cost_lock:
        _COSTS[name] = ent
    return ent


def variant_cost(name: str | None) -> dict | None:
    """The cached cost entry for a variant name; None when the variant was
    never AOT-compiled or its backend reports no cost model."""
    if name is None:
        return None
    with _cost_lock:
        return _COSTS.get(name)


def clear_variant_costs() -> None:
    """Test hook: drop the per-process cost cache."""
    with _cost_lock:
        _COSTS.clear()


# -------------------------------------------------- bucket decomposition
def decompose(wall_s: float, *, compute: float = 0.0, h2d: float = 0.0,
              prefetch_stall: float = 0.0, wire_wait: float = 0.0,
              agg_flush: float = 0.0) -> dict:
    """Fold measured phase seconds into the exclusive bucket dict.

    Buckets are clipped in BUCKETS order so the running total never
    exceeds ``wall_s``; ``drain`` is the residual. The result's values sum
    to ``wall_s`` exactly (the oracle contract)."""
    wall = max(float(wall_s), 0.0)
    raw = {"compute": compute, "h2d": h2d, "prefetch_stall": prefetch_stall,
           "wire_wait": wire_wait, "agg_flush": agg_flush}
    out, total = {}, 0.0
    for b in BUCKETS[:-1]:
        v = min(max(float(raw[b]), 0.0), wall - total)
        out[b] = v
        total += v
    out["drain"] = wall - total
    return out


def buckets_from_spans(wall_s: float, spans: dict | None, *,
                       pipelined: bool = False,
                       compute_wait_s: float = 0.0,
                       wire_wait_s: float = 0.0,
                       flush_s: float = 0.0) -> dict:
    """The standard span->bucket mapping for an engine round record.

    ``spans`` is the per-round span dict the tracer already produces
    (pack/round sync; prefetch_stall/h2d pipelined; aggregate on the
    server). ``compute_wait_s`` is the measured block-until-ready wait the
    driver paid for this round's device program (the dispatch span alone
    is issue time). In pipelined mode the pack/h2d spans rode the prefetch
    thread — overlapped, so only the stall counts against the wall."""
    spans = spans or {}
    if pipelined:
        stall = float(spans.get("prefetch_stall", 0.0))
        h2d = 0.0
    else:
        stall = float(spans.get("pack", 0.0))
        h2d = float(spans.get("h2d", 0.0))
    return decompose(
        wall_s,
        compute=float(spans.get("round", 0.0)) + float(compute_wait_s),
        h2d=h2d,
        prefetch_stall=stall,
        wire_wait=float(wire_wait_s),
        agg_flush=float(spans.get("aggregate", 0.0)) + float(flush_s),
    )


# ------------------------------------------------------- metric families
@lru_cache(maxsize=8)
def _duty_gauge(bucket: str):
    return REGISTRY.gauge("fed_duty_cycle", bucket=bucket)


@lru_cache(maxsize=4)
def _gp_gauge(name: str):
    # lru_cache indirection; every call site passes a fed_* literal
    return REGISTRY.gauge(name)  # fedlint: disable=metric-discipline


@lru_cache(maxsize=2)
def _gp_counter(name: str):
    # lru_cache indirection; every call site passes a fed_* literal
    return REGISTRY.counter(name)  # fedlint: disable=metric-discipline


def ensure_goodput_families() -> None:
    """Pre-register every goodput family at zero so a clean run's
    Prometheus export always carries them — 'no goodput yet' must read as
    0, not as a missing family (same contract as the shed/secagg
    families)."""
    for b in BUCKETS:
        _duty_gauge(b)
    _gp_gauge("fed_goodput_flops_per_sec")
    _gp_gauge("fed_goodput_bytes_per_sec")
    _gp_gauge("fed_goodput_mfu")
    _gp_counter("fed_goodput_rounds_total")


# ------------------------------------------------------ per-round record
def round_goodput(wall_s: float, buckets: dict, *, variant: str | None = None,
                  cost_rounds: int = 1, n_devices: int = 1,
                  peak_flops: float | None = None,
                  device_kind: str | None = None) -> dict:
    """Build the ``goodput`` block one round record carries and feed the
    metric families.

    ``buckets`` is a :func:`decompose` result for this round's wall.
    ``cost_rounds`` normalizes a scanned block variant's cost analysis
    (which covers R rounds per dispatch) to per-round figures. ``wall_s``
    must already be per-round. When the variant's cost is unknown the
    block carries duty cycles only (relative goodput)."""
    wall = max(float(wall_s), 1e-12)
    duty = {b: buckets.get(b, 0.0) / wall for b in BUCKETS}
    blk: dict = {
        "wall_s": round(wall, 6),
        "buckets": {b: round(float(buckets.get(b, 0.0)), 6) for b in BUCKETS},
        "duty": {b: round(duty[b], 4) for b in BUCKETS},
    }
    if variant is not None:
        blk["variant"] = variant
    for b in BUCKETS:
        _duty_gauge(b).set(duty[b])
    _gp_counter("fed_goodput_rounds_total").inc()

    cost = variant_cost(variant)
    if cost is not None:
        rounds = max(int(cost_rounds), 1)
        if cost.get("flops"):
            fps = cost["flops"] / rounds / wall
            blk["flops_per_s"] = fps
            _gp_gauge("fed_goodput_flops_per_sec").set(fps)
            peak = (peak_flops if peak_flops is not None
                    else device_peak_flops(device_kind))
            if peak:
                mfu = fps / (peak * max(int(n_devices), 1))
                blk["mfu"] = round(mfu, 6)
                _gp_gauge("fed_goodput_mfu").set(mfu)
        if cost.get("bytes"):
            bps = cost["bytes"] / rounds / wall
            blk["bytes_per_s"] = bps
            _gp_gauge("fed_goodput_bytes_per_sec").set(bps)
    return blk
