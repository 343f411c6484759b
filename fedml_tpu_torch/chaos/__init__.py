"""Deterministic fault injection for the cross-process comm stack.

The resilience machinery this repo ships — elastic partial aggregation with
a round watchdog, dead-rank reprobe, checkpoint/resume, gRPC retry with
exactly-once dedup — only fires under real network faults, which makes it
untestable dead code on a quiet CI box. This package makes those paths
drivable from a CPU-only test: a seeded, declarative :class:`FaultPlan`
wraps any ``BaseCommManager`` (loopback / gRPC / MQTT) and injects frame
**drop, delay, duplicate, reorder, corrupt, partition**, plus **crash**
(a rank goes dark for a round window — its sends vanish, sends to it fail
like a dead TCP peer) and **straggle** (synchronous uplink slowdown) for
the loopback thread harness.

Every injection decision is a pure function of
``(plan seed, rule, direction, src, dst, per-link frame seq)`` — never of
wall clock or thread interleaving — so two runs with the same plan inject
the *identical* fault sequence (``FaultPlan.ledger.canonical()``) and, for
a deterministic protocol, converge to identical final models. That is what
turns "the server survives chaos" into a replayable, assertable invariant
(FL_PyTorch arXiv:2202.03099 and FedJAX arXiv:2108.02117 both argue FL
simulators must reproduce deployment failure modes deterministically).

Usage::

    plan = FaultPlan.from_json(spec)      # or FaultPlan(seed=..., rules=[...])
    with installed(plan):                 # process-global, like set_wire_codec
        run_simulated(...)                # every manager built inside is wrapped
    plan.ledger.canonical()               # the replayable injection record

With no plan installed, ``maybe_wrap`` returns the manager unchanged — the
no-chaos hot path costs nothing.

Scheduled availability (``chaos/churn.py``) is the third axis: a seeded
:class:`ChurnTrace` models the NORMAL state of a fleet — diurnal
availability curves, arrival/dropout point processes, device-class skew —
on a sha256 stream independent of FaultPlan's, so churn × chaos × byzantine
replays bit-for-bit (a :class:`ScenarioPlan` bundles all three for
``scripts/fleet_campaign.py`` profiles). See docs/ROBUSTNESS.md §Fleet
campaigns & client churn for the offline-vs-dead semantics.

Model-space adversaries (``chaos/adversary.py``) are the Byzantine-client
sibling: an :class:`AdversaryPlan` schedules sign_flip/scale/gaussian/
nan/shift uploads per (round-window, rank) with the same seeded
determinism, consumed by ``FedAvgAPI(adversary_plan=...)`` (in-graph) and
the cross-process client manager (on-the-wire) — see
docs/ROBUSTNESS.md §Byzantine-robust aggregation.
"""

from __future__ import annotations

import contextlib
import threading

from fedml_tpu_torch.chaos.plan import FaultLedger, FaultPlan, FaultRule
from fedml_tpu_torch.chaos.inject import ChaosCommManager
from fedml_tpu_torch.chaos.adversary import AdversaryPlan, AdversaryRule
from fedml_tpu_torch.chaos.churn import ChurnTrace, DeviceClass, ScenarioPlan

_active: FaultPlan | None = None
_lock = threading.Lock()


def install_plan(plan: FaultPlan | None) -> None:
    """Set the process-global plan picked up by ``make_comm_manager``.
    Every rank of an in-process (loopback) job shares it; cross-process
    jobs pass the same plan file to each rank (``--chaos-plan``)."""
    global _active
    with _lock:
        _active = plan


def active_plan() -> FaultPlan | None:
    return _active


@contextlib.contextmanager
def installed(plan: FaultPlan):
    """Scoped install — the test-suite idiom (always uninstalls)."""
    install_plan(plan)
    try:
        yield plan
    finally:
        install_plan(None)


def maybe_wrap(manager, rank: int):
    """Wrap ``manager`` in a ChaosCommManager when a plan is installed;
    return it untouched (zero added per-frame work) otherwise."""
    plan = _active
    if plan is None:
        return manager
    return ChaosCommManager(manager, plan, rank)


__all__ = [
    "FaultPlan", "FaultRule", "FaultLedger", "ChaosCommManager",
    "AdversaryPlan", "AdversaryRule",
    "ChurnTrace", "DeviceClass", "ScenarioPlan",
    "install_plan", "active_plan", "installed", "maybe_wrap",
]
