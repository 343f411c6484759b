"""The live run-health layer in the port (fedml_tpu_torch/obs/health.py,
httpd.py, memwatch.py and Telemetry's health / memwatch / HTTP arms)
against the JAX package's, on seeded record streams and the port's own
tiny runs (synthetic images of 8 clients, 6x6x1, 3 classes,
LogisticRegression).

The same stream of round and eval records and registry moves goes
through both packages' ``HealthMonitor`` on an injected clock (no test
waits out a real deadline): their alert events, ``fed_alerts_total`` and
``/healthz`` verdicts are equal. The port's own runs (a DP engine, a
rank-churned wire run) feed both monitors the port's records.
"""

import json
import math
import urllib.request

import numpy as np
import pytest

from fedml_tpu.obs import health as jax_health
from fedml_tpu.obs import httpd as jax_httpd
from fedml_tpu.obs import metrics as jax_metrics
from fedml_tpu.obs.telemetry import Telemetry as JaxTelemetry
from fedml_tpu_torch import chaos
from fedml_tpu_torch.algorithms import FedAvgConfig
from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustAPI
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import run_simulated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs import health, httpd, metrics
from fedml_tpu_torch.obs.metrics import REGISTRY
from fedml_tpu_torch.obs.telemetry import Telemetry

PKGS = {"port": (health, metrics, httpd),
        "jax": (jax_health, jax_metrics, jax_httpd)}
# DEFAULT_RULES' kinds, at thresholds a 24-round stream crosses
RULES = [
    {"rule": "convergence", "severity": "critical", "evals_rising": 3},
    {"rule": "slowdown", "severity": "warning",
     "window": 4, "recent": 2, "factor": 2.0},
    {"rule": "quarantine", "severity": "warning",
     "window": 2, "max_per_round": 1.0},
    {"rule": "shed", "severity": "warning", "window": 2, "max_per_round": 2.0},
    {"rule": "quorum", "severity": "critical", "min_fraction": 1.0},
    {"rule": "device_memory", "severity": "critical", "max_fraction": 0.9},
    {"rule": "stall", "severity": "critical", "after_s": 10.0},
    {"rule": "privacy_budget", "severity": "warning", "max_epsilon": 2.0},
]
SCENARIOS = ("nonfinite", "rising_evals", "slowdown", "quarantine", "shed",
             "quorum_trough", "device_memory", "stall", "privacy_budget")
DATA_KW = dict(num_clients=8, image_shape=(6, 6, 1), num_classes=3,
               samples_per_client=12, test_samples=48, seed=0)


def _stream(pkg: str, scenarios, seed: int = 0):
    """Drive one package's monitor through a seeded stream with the named
    faults in it; returns (monitor, registry, clock)."""
    h, m, _ = PKGS[pkg]
    rng = np.random.default_rng(seed)
    reg = m.MetricsRegistry()
    now = [1000.0]
    mon = h.HealthMonitor(registry=reg, rules=h.rules_from_json(RULES),
                          expected_ranks=4, clock=lambda: now[0])
    reg.gauge("fed_ranks_alive").set(4)
    reg.gauge("fed_device_bytes_limit", device="gpu:0").set(1000)
    loss, eps = 2.0, 0.0
    for r in range(24):
        now[0] += float(rng.uniform(0.5, 1.0))
        span = float(rng.uniform(0.1, 0.12))
        if "slowdown" in scenarios and 8 <= r < 12:
            span *= 4.0
        if "quarantine" in scenarios and r in (5, 6):
            reg.counter("fed_updates_rejected_total", reason="norm").inc(3)
        if "shed" in scenarios and r in (9, 10):
            reg.counter("fed_async_shed_total", reason="stale").inc(5)
        if "quorum_trough" in scenarios:
            # a diurnal trough (never pages), then one crash inside it
            off = 2 if 12 <= r < 18 else 0
            crash = 1 if r in (15, 16) else 0
            reg.gauge("fed_ranks_scheduled_offline").set(off)
            reg.gauge("fed_ranks_alive").set(4 - off - crash)
        used = 950 if "device_memory" in scenarios and r in (3, 4) else 400
        reg.gauge("fed_device_bytes_in_use", device="gpu:0").set(used)
        metrics_ = {"loss_sum": float(rng.uniform(1, 2)),
                    "update_norm": float(rng.uniform(0.1, 1))}
        if "nonfinite" in scenarios and r == 20:
            metrics_["update_norm"] = float("nan")
        rec = {"round": r, "ts": now[0], "spans": {"round": span},
               "metrics": metrics_}
        if "privacy_budget" in scenarios:
            eps += 0.15
            rec["privacy"] = {"eps": round(eps, 6)}
        mon.on_round(rec)
        if r % 2 == 1:
            rising = "rising_evals" in scenarios and 13 <= r < 21
            loss = loss * (1.1 if rising else 0.95)
            mon.on_eval({"round": r, "eval": {"test_loss": loss}})
        if "stall" in scenarios and r == 22:
            now[0] += 15.0
            mon.check()
    return mon, reg, now


def _alerts(mon):
    return [(a["rule"], a["severity"], a["state"], a["round"], a["value"],
             a["threshold"]) for a in mon.alerts]


def _totals(reg):
    return reg.snapshot().get("fed_alerts_total", {})


def test_rules_from_json_forms(tmp_path):
    """The rule table's forms parse alike: lists, inline JSON, a file, the
    severity default, and a typo that stays loud."""
    assert health.DEFAULT_RULES == jax_health.DEFAULT_RULES
    inline = '[{"rule": "quorum", "min_fraction": 0.5}]'
    p = tmp_path / "rules.json"
    p.write_text(inline)
    for spec in (health.DEFAULT_RULES, inline, str(p), RULES):
        assert health.rules_from_json(spec) == \
            jax_health.rules_from_json(spec)
    for h in (health, jax_health):
        with pytest.raises(ValueError):
            h.rules_from_json('[{"rule": "convergance"}]')
        with pytest.raises(FileNotFoundError):
            h.rules_from_json("no/such/rules.json")


@pytest.mark.parametrize("scenario", SCENARIOS + ("all",))
def test_rule_stream_matches_reference(scenario):
    """One seeded stream through both packages' monitors: the same alert
    transitions (rule, severity, state, round, value, threshold), the same
    fed_alerts_total children and the same /healthz verdict; each fault
    fires its rule (the trough alone never pages the quorum rule)."""
    names = SCENARIOS if scenario == "all" else (scenario,)
    mine, reg, _ = _stream("port", names, seed=len(scenario))
    ref, jreg, _ = _stream("jax", names, seed=len(scenario))
    assert _alerts(mine) == _alerts(ref)
    assert _totals(reg) == _totals(jreg)
    assert mine.snapshot() == ref.snapshot()
    fired = {a[0] for a in _alerts(mine) if a[2] == "fired"}
    want = {"nonfinite": "convergence", "rising_evals": "convergence",
            "quorum_trough": "quorum"}
    if scenario == "all":
        assert fired == {r["rule"] for r in RULES}
    else:
        assert fired == {want.get(scenario, scenario)}
    if scenario == "quorum_trough":
        # fired once by the crash inside the trough, resolved after it
        assert [a[2:4] for a in _alerts(mine) if a[0] == "quorum"] == [
            ("fired", 15), ("resolved", 17)]


def test_healthz_and_metrics_over_http_match_reference():
    """After the full stream, both packages' HTTP servers answer /healthz
    with the same verdict (degraded: a sticky alert) and /metrics with the
    same exposition; an unknown path is a 404."""
    out = {}
    for pkg in ("port", "jax"):
        mon, reg, _ = _stream(pkg, SCENARIOS, seed=3)
        srv = PKGS[pkg][2].MetricsHTTPServer(port=0, registry=reg,
                                            health=mon)
        try:
            hz = json.loads(urllib.request.urlopen(
                srv.url("/healthz"), timeout=5).read())
            prom = urllib.request.urlopen(srv.url("/metrics"),
                                          timeout=5).read().decode()
            with pytest.raises(urllib.request.HTTPError):
                urllib.request.urlopen(srv.url("/nope"), timeout=5)
        finally:
            srv.close()
        assert hz.pop("port") == srv.port
        out[pkg] = (hz, prom)
    assert out["port"] == out["jax"]
    assert out["port"][0]["status"] == "degraded"


def test_run_header_reports_bound_port_and_infers_quorum_cohort():
    for tel in (Telemetry(registry=metrics.MetricsRegistry(), http_port=0),
                JaxTelemetry(registry=jax_metrics.MetricsRegistry(),
                             http_port=0)):
        try:
            tel.run_header({}, engine="distributed", world_size=5)
            header = tel.events.sink.records[0]
            assert header["http_port"] == tel.http_port > 0
            assert tel.health.expected_ranks == 4
            assert tel.memwatch is not None
        finally:
            tel.close()


def _setup():
    data = synthetic_images(**DATA_KW)
    task = classification_task(create_model("lr", output_dim=3,
                                            device="cpu"))
    return data, task


def test_privacy_budget_fires_once_on_the_port_dp_engine():
    """Accounted DP on the port's engine: the privacy block of its round
    records crosses the rule's ε budget and the alert fires exactly once
    (edge-triggered, ε only grows); the reference's monitor fed the same
    records agrees transition for transition."""
    data, task = _setup()
    rule = [{"rule": "privacy_budget", "severity": "warning",
             "max_epsilon": 3.0}]
    tel = Telemetry(registry=metrics.MetricsRegistry(), health_rules=rule)
    cfg = FedAvgConfig(comm_round=6, client_num_in_total=8,
                       client_num_per_round=4, batch_size=6, lr=0.1,
                       frequency_of_the_test=100)
    api = FedAvgRobustAPI(data, task, cfg, defense_type="dp",
                          norm_bound=1.0, noise_multiplier=2.0,
                          device="cpu", telemetry=tel)
    api.train()
    tel.close()
    recs = [r for r in tel.events.sink.records if r["kind"] == "round"]
    eps = [r["privacy"]["eps"] for r in recs]
    assert eps[0] < 3.0 < eps[-1]
    ref = jax_health.HealthMonitor(registry=jax_metrics.MetricsRegistry(),
                                   rules=rule)
    for r in recs:
        ref.on_round(r)
    assert _alerts(tel.health) == _alerts(ref)
    fired = [a for a in _alerts(tel.health) if a[2] == "fired"]
    assert len(fired) == 1 and fired[0][4] > 3.0
    assert REGISTRY.gauge("fed_privacy_epsilon").value == \
        pytest.approx(eps[-1])


@pytest.fixture
def _restore_churn_gauges():
    g_off = REGISTRY.gauge("fed_ranks_scheduled_offline")
    g_alive = REGISTRY.gauge("fed_ranks_alive")
    before = (g_off.value, g_alive.value)
    yield
    g_off.set(before[0])
    g_alive.set(before[1])


def test_quorum_trough_never_fires_crash_fires_once(_restore_churn_gauges):
    """tests/test_churn.py's churn-aware quorum, on the port's wire run:
    a rank trace holds ranks {1}, {1, 2, 4}, {2, 3} out of rounds 0-2 and
    the server's alive / scheduled-offline gauges move with it, yet the
    quorum rule never pages; then the reference's gauge sequence (a deep
    trough, one crash inside it, recovery) fires and resolves exactly
    once in both packages' monitors."""
    data, task = _setup()
    rule = [{"rule": "quorum", "severity": "critical", "min_fraction": 1.0}]
    tel = Telemetry(health_rules=rule)
    cfg = FedAvgConfig(comm_round=3, client_num_in_total=8,
                       client_num_per_round=4, batch_size=6, lr=0.1,
                       frequency_of_the_test=100)
    run_simulated(data, task, cfg, job_id="th-quorum", device="cpu",
                  telemetry=tel, churn_trace=chaos.ChurnTrace(
                      seed=1, rank_base=0.6, rank_amplitude=0.4, period=4))
    tel.close()
    recs = [r for r in tel.events.sink.records if r["kind"] == "round"]
    assert [r["churn"]["scheduled_offline"] for r in recs] == [1, 3, 2]
    assert tel.health.expected_ranks == 4 and tel.health.alerts == []

    for pkg in ("port", "jax"):
        h, m, _ = PKGS[pkg]
        reg = m.MetricsRegistry()
        mon = h.HealthMonitor(registry=reg, expected_ranks=8, rules=rule)
        for alive, off in ((2, 6), (1, 6), (1, 6), (8, 0)):
            reg.gauge("fed_ranks_alive").set(alive)
            reg.gauge("fed_ranks_scheduled_offline").set(off)
            mon.check()
        assert [(a["state"], a["value"], a["threshold"])
                for a in mon.alerts] == [("fired", 1.0, 2.0),
                                         ("resolved", 8.0, 8.0)]


def test_full_health_bundle_is_nil_overhead_and_threads_stop():
    """The full live bundle (HTTP, memwatch, health) trains the engine to
    the same bits as the bare engine; a bare Telemetry starts no thread
    and binds no socket, as the reference's."""
    import threading

    from fedml_tpu_torch.algorithms import FedAvgAPI

    data, task = _setup()
    cfg = FedAvgConfig(comm_round=2, client_num_in_total=8,
                       client_num_per_round=4, batch_size=6, lr=0.1,
                       frequency_of_the_test=1)
    plain = FedAvgAPI(data, task, cfg, device="cpu")
    plain.train()
    baseline = set(threading.enumerate())
    tel = Telemetry(registry=metrics.MetricsRegistry(), http_port=0,
                    memwatch=True, health=True)
    full = FedAvgAPI(data, task, cfg, device="cpu", telemetry=tel)
    full.train()
    tel.close()
    assert all(a.numpy().tobytes() == b.numpy().tobytes()
               for a, b in zip(plain.net.values(), full.net.values()))
    assert not [t for t in set(threading.enumerate()) - baseline
                if t.name.startswith("obs-")]
    for bare in (Telemetry(registry=metrics.MetricsRegistry()),
                 JaxTelemetry(registry=jax_metrics.MetricsRegistry())):
        assert (bare.health, bare.memwatch, bare.httpd) == (None,) * 3
        bare.close()
    evals = [r for r in tel.events.sink.records if r["kind"] == "eval"]
    assert len(evals) == 2 and all(
        math.isfinite(r["eval"]["test_loss"]) for r in evals)
