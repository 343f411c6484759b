"""Client churn in the port (chaos/churn.py traces driving
core/sampling.sample_available, the engine's churned cohorts, the async
runner's offline slots and the server's rank-level scheduled availability)
against the JAX package's, on tests/test_churn.py's tiny configuration
(synthetic images of 8 clients, 6x6x1, 3 classes, 12 samples each,
LogisticRegression), from the same seeded numpy inputs and weights.

Tolerances: cohorts (sizes and ids) bitwise the JAX package's; inside the
port, replays bitwise and the tree bitwise its flat pairwise twin; runs
against the JAX package's within 1e-5, ledgers and churn records equal.
The reference's quorum test (test_quorum_trough_never_fires_crash_fires_
once) is mirrored in tests/test_torch_health.py. No test waits out a
deadline: the chosen rank trace never holds a whole round out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import chaos as jax_chaos
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.comm.message import pack_pytree as jax_pack
from fedml_tpu.core.sampling import sample_available as jax_sample_available
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.distributed.fedavg import api as jax_api
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.obs.telemetry import Telemetry as JaxTelemetry
from fedml_tpu_torch import chaos, convert
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.comm.message import pack_pytree
from fedml_tpu_torch.core.sampling import prepare_sampling, sample_available
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import run_simulated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs.metrics import REGISTRY
from fedml_tpu_torch.obs.telemetry import Telemetry

DATA_KW = dict(num_clients=8, image_shape=(6, 6, 1), num_classes=3,
               samples_per_client=12, test_samples=48, seed=0)
TOL = dict(rtol=1e-5, atol=1e-6)
DIURNAL = {"seed": 11, "base": 0.55, "amplitude": 0.45, "period": 6,
           "tz_spread": 0.5, "arrival_spread": 2, "departure_rate": 0.01}
# rank-level: ranks {1}, {1, 2, 4}, {2, 3} away in rounds 0-2, never all 4
RANK_TRACE = dict(seed=1, rank_base=0.6, rank_amplitude=0.4, period=4)


@pytest.fixture(autouse=True)
def _restore_churn_gauges():
    """The admission paths publish the process-global
    fed_ranks_scheduled_offline / fed_ranks_alive gauges: restore them so
    a leftover offline count leaks into no later test."""
    g_off = REGISTRY.gauge("fed_ranks_scheduled_offline")
    g_alive = REGISTRY.gauge("fed_ranks_alive")
    before = (g_off.value, g_alive.value)
    yield
    g_off.set(before[0])
    g_alive.set(before[1])


def _cfg(rounds=3, per_round=4, seed=0, freq=100, trace=None, jax_=False):
    kw = dict(comm_round=rounds, client_num_in_total=8,
              client_num_per_round=per_round, epochs=1, batch_size=6,
              lr=0.1, frequency_of_the_test=freq, seed=seed)
    if trace is not None:
        kw["churn_trace"] = (jax_chaos.ChurnTrace if jax_
                             else chaos.ChurnTrace).from_json(trace)
    return (JaxConfig if jax_ else FedAvgConfig)(**kw)


@pytest.fixture(scope="module")
def setup():
    jdata = jax_synthetic_images(**DATA_KW)
    jtask = jax_classification_task(JaxLR(num_classes=3))
    _, key = jax.random.split(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtask.init(
        key, jnp.asarray(jdata.train_x[:6])).params)
    state = convert.from_flax(params)
    task = classification_task(create_model("lr", output_dim=3, device="cpu"))
    task = task._replace(init=lambda g, x=None: {k: v.clone()
                                                 for k, v in state.items()})
    return dict(data=synthetic_images(**DATA_KW), task=task, jdata=jdata,
                jtask=jtask)


def _engine(s, cfg, **kw):
    return FedAvgAPI(s["data"], s["task"], cfg, device="cpu", **kw)


def _jax_start(japi) -> dict:
    """The JAX engine's initial weights as a port state dict."""
    return convert.from_flax(jax.tree.map(np.asarray, japi.net.params))


def _close(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **TOL)


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------ churn-aware sampling
@pytest.mark.parametrize("sampling", ["uniform", "size_weighted"])
def test_sample_available_is_the_jax_draw_bitwise(setup, sampling):
    import dataclasses

    cfg = dataclasses.replace(_cfg(per_round=4, trace=DIURNAL),
                              sampling=sampling)
    jcfg = dataclasses.replace(_cfg(per_round=4, trace=DIURNAL, jax_=True),
                               sampling=sampling)
    sizes = prepare_sampling(cfg, setup["data"])
    for r in range(12):
        got = sample_available(cfg, r, cfg.churn_trace, sizes)
        want = jax_sample_available(jcfg, r, jcfg.churn_trace, sizes)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        avail = cfg.churn_trace.available_clients(
            cfg.churn_trace.window(r), 8)
        assert set(got.tolist()) <= set(avail.tolist())
        assert len(got) == min(4, len(avail))


def test_engine_cohorts_follow_the_curve_and_the_jax_engine(setup):
    """Troughs shrink the engine's cohort (and the batched fit's K) below
    client_num_per_round; the ids and the trained model are the JAX
    engine's."""
    trace = dict(seed=4, base=0.4, amplitude=0.4, period=4, tz_spread=0.0)
    eng = _engine(setup, _cfg(rounds=4, per_round=6, freq=2, trace=trace))
    jeng = JaxFedAvgAPI(setup["jdata"], setup["jtask"],
                        _cfg(rounds=4, per_round=6, freq=2, trace=trace,
                             jax_=True))
    sizes = [len(eng._sampled_ids(r)) for r in range(8)]
    for r in range(8):
        assert np.array_equal(eng._sampled_ids(r), jeng._sampled_ids(r))
    assert max(sizes[:4]) > min(sizes[:4]) and max(sizes) <= 6
    eng.train()
    jeng.train()
    _close(pack_pytree(eng.net), jax.tree.leaves(jeng.net.params))
    assert [h["round"] for h in eng.history] == [0, 2, 3]
    np.testing.assert_allclose([h["train_loss"] for h in eng.history],
                               [h["train_loss"] for h in jeng.history],
                               rtol=1e-5)


def test_run_rounds_runs_a_churned_cohort(setup):
    """The port's run_rounds is a loop of run_round, so a varying cohort
    needs no refusal there: bitwise the run_round loop."""
    trace = dict(seed=4, base=0.5, amplitude=0.5, period=4)
    a = _engine(setup, _cfg(rounds=4, trace=trace), device_data=True)
    a.run_rounds(0, 4)
    b = _engine(setup, _cfg(rounds=4, trace=trace))
    for r in range(4):
        b.run_round(r)
    assert _same(a.net, b.net)


def test_churn_adversary_replay_bit_for_bit_sync(setup):
    """Churn x adversary on the synchronous engine: two runs reproduce
    the model bits and the ledger; a different churn seed perturbs the
    run; the ledger is the JAX engine's."""
    churn = {"seed": 11, "base": 0.6, "amplitude": 0.4, "period": 4,
             "tz_spread": 0.4}
    adv = {"seed": 3, "rules": [{"attack": "scale", "ranks": [2],
                                 "factor": 40.0}]}

    from fedml_tpu.chaos.adversary import AdversaryPlan as JaxAdversaryPlan

    j = JaxFedAvgAPI(setup["jdata"], setup["jtask"],
                     _cfg(rounds=6, seed=1, trace=churn, jax_=True),
                     aggregator="median", sanitize=0.9,
                     adversary_plan=JaxAdversaryPlan.from_json(adv))
    start = _jax_start(j)

    def run(churn_seed=11):
        eng = _engine(setup, _cfg(rounds=6, seed=1,
                                  trace={**churn, "seed": churn_seed}),
                      aggregator="median", sanitize=0.9,
                      adversary_plan=chaos.AdversaryPlan.from_json(adv))
        eng.load_state(start)  # the JAX engine's seed-1 init
        eng.train()
        return eng

    a, b = run(), run()
    assert _same(a.net, b.net)
    assert a.quarantine.canonical() == b.quarantine.canonical()
    assert not _same(a.net, run(churn_seed=12).net)
    j.train()
    assert a.quarantine.canonical() == j.quarantine.canonical()
    _close(pack_pytree(a.net), jax.tree.leaves(j.net.params))


def test_churn_chaos_adversary_replay_bit_for_bit_async(setup):
    """The composed contract on the virtual-clock runner: diurnal trace x
    straggler storm x byzantine adversary, twice, reproduces the model,
    the ledger and the shed / staleness ledger; the JAX runner's stats and
    ledger are equal and its model within 1e-5."""
    churn = {"seed": 11, "base": 0.5, "amplitude": 0.5, "period": 4,
             "tz_spread": 0.0}
    faults = {"seed": 7, "rules": [
        {"fault": "straggle", "ranks": [2], "delay_s": 2.5},
        {"fault": "crash", "ranks": [3], "rounds": [2, 4]}]}
    adv = {"seed": 3, "rules": [{"attack": "scale", "ranks": [1],
                                 "factor": 40.0}]}

    from fedml_tpu.chaos.adversary import AdversaryPlan as JaxAdversaryPlan

    je = JaxFedAvgAPI(setup["jdata"], setup["jtask"],
                      _cfg(rounds=6, seed=1, trace=churn, jax_=True),
                      aggregator="median", sanitize=0.9)
    start = _jax_start(je)

    def run():
        eng = _engine(setup, _cfg(rounds=6, seed=1, trace=churn),
                      aggregator="median", sanitize=0.9)
        eng.load_state(start)  # the JAX engine's seed-1 init
        runner = eng.run_async(
            6, buffer_k=3, staleness="poly:0.5",
            chaos_plan=chaos.FaultPlan.from_json(faults),
            adversary_plan=chaos.AdversaryPlan.from_json(adv))
        return eng, runner

    (ea, ra), (eb, rb) = run(), run()
    assert _same(ea.net, eb.net)
    assert ea.quarantine.canonical() == eb.quarantine.canonical()
    assert ra.stats() == rb.stats() and ra.history == rb.history
    jr = je.run_async(6, buffer_k=3, staleness="poly:0.5",
                      chaos_plan=jax_chaos.FaultPlan.from_json(faults),
                      adversary_plan=JaxAdversaryPlan.from_json(adv))
    assert ra.stats() == jr.stats()
    assert ea.quarantine.canonical() == je.quarantine.canonical()
    _close(pack_pytree(ea.net), jax.tree.leaves(je.net.params))


def test_async_virtual_clock_cohorts_follow_the_curve(setup):
    """Waves whose available cohort dips below the slot count shed
    'offline' (the slot idles through the wave), the run completes its
    update budget, and the shed pattern replays."""
    trace = dict(seed=4, base=0.4, amplitude=0.4, period=4, tz_spread=0.0)
    eng = _engine(setup, _cfg(rounds=10, per_round=6, trace=trace))
    runner = eng.run_async(10, buffer_k=3)
    assert runner.version == 10 and runner.shed_counts["offline"] > 0
    assert [w for w in range(10) if len(eng._sampled_ids(w)) < 6]
    assert [w for w in range(10) if len(eng._sampled_ids(w)) == 6]
    again = _engine(setup, _cfg(rounds=10, per_round=6, trace=trace))
    runner2 = again.run_async(10, buffer_k=3)
    assert _same(eng.net, again.net)
    assert runner2.shed_counts == runner.shed_counts


# ------------------------------------- offline vs suspected-dead admission
def _bare_manager(trace, size=5, round_idx=0):
    """A partially-built FedAvgServerManager: just enough state to drive
    _dispatch_one's admission decision, no comm stack."""
    from fedml_tpu_torch.distributed.fedavg.server_manager import (
        FedAvgServerManager,
    )

    mgr = object.__new__(FedAvgServerManager)
    mgr.churn_trace = trace
    mgr.size = size
    mgr.round_idx = round_idx
    mgr.heartbeat_max_age_s = None
    mgr._undeliverable = {}
    mgr._offline_now = set()
    mgr._offline_skipped = set()
    mgr._shed_counts = {}
    mgr._awaiting = {}
    mgr._dispatch_wave = {}
    mgr._fleet = None
    return mgr


@pytest.mark.parametrize("case", ["offline", "suspect"])
def test_offline_rank_is_skipped_silently_a_silent_one_is_suspect(
        monkeypatch, case):
    """An offline rank's dispatch is shed 'offline' BEFORE the suspect
    check (no suspect bookkeeping, no send); a rank the trace expects
    online but the heartbeat collector marks silent is shed 'suspect'."""
    from fedml_tpu_torch.distributed.fedavg import server_manager as sm

    if case == "offline":
        trace = chaos.ChurnTrace(seed=1, rank_base=0.5, rank_amplitude=0.5,
                                 period=4)
        mgr = next(m for m in (_bare_manager(trace, round_idx=r)
                               for r in range(16)) if m._scheduled_offline())
        rank = min(mgr._offline_now)

        def no_suspects(*a, **kw):
            raise AssertionError("offline skip must precede the suspect "
                                 "check")

        monkeypatch.setattr(sm._obs, "suspect_ranks", no_suspects)
        mgr._dispatch_one(rank)
        assert mgr._shed_counts == {"offline": 1}
        assert rank in mgr._offline_skipped
        assert REGISTRY.gauge("fed_ranks_scheduled_offline").value == \
            len(mgr._offline_now)
    else:
        mgr = _bare_manager(chaos.ChurnTrace(seed=1))  # nobody offline
        monkeypatch.setattr(sm._obs, "suspect_ranks", lambda *a, **kw: {2})
        mgr._dispatch_one(2)
        assert mgr._shed_counts == {"suspect": 1}
        assert 2 not in mgr._offline_skipped
    assert mgr._undeliverable == {} and mgr._awaiting == {}


# ------------------------------------------------------------- the wire
def test_rank_level_trace_over_loopback_matches_jax(setup):
    """run_simulated(churn_trace=): each round's offline ranks get no
    frame and leave the barrier (no deadline waited), the round folds the
    online ranks, and each record carries its ``churn`` block — all as the
    JAX package's run does, its model within 1e-5."""
    from fedml_tpu_torch.distributed.fedavg.server_manager import (
        FedAvgServerManager,
    )

    sent = []
    orig = FedAvgServerManager.send_message

    def spy(self, msg):
        sent.append((self.round_idx, int(msg.get_receiver_id())))
        return orig(self, msg)

    tel, jtel = Telemetry(), JaxTelemetry()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FedAvgServerManager, "send_message", spy)
        agg = run_simulated(setup["data"], setup["task"], _cfg(freq=1),
                            job_id="tc-rank", device="cpu", telemetry=tel,
                            churn_trace=chaos.ChurnTrace(**RANK_TRACE))
    jagg = jax_api.run_simulated(
        setup["jdata"], setup["jtask"], _cfg(freq=1, jax_=True),
        job_id="tc-rank-jax", telemetry=jtel,
        churn_trace=jax_chaos.ChurnTrace(**RANK_TRACE))
    recs = [r for r in tel.events.sink.records if r.get("kind") == "round"]
    jrecs = [r for r in jtel.events.sink.records if r.get("kind") == "round"]
    tel.close()
    jtel.close()
    trace = chaos.ChurnTrace(**RANK_TRACE)
    offline = [trace.scheduled_offline_ranks(r, 5) for r in range(3)]
    assert offline == [{1}, {1, 2, 4}, {2, 3}]
    for r in range(3):
        got = {rank for rr, rank in sent if rr == r}
        assert got == set(range(1, 5)) - offline[r], (r, sent)
    assert [r["churn"] for r in recs] == [r["churn"] for r in jrecs] == [
        {"scheduled_offline": len(o), "idle_rounds": 0} for o in offline]
    assert [r["clients"] for r in recs] == [r["clients"] for r in jrecs]
    assert [r["metrics"]["num_samples"] for r in recs] == \
        [r["metrics"]["num_samples"] for r in jrecs]
    assert agg.quarantine.canonical() == [] == jagg.quarantine.canonical()
    _close(pack_pytree(agg.net), jax_pack(jagg.net))


def test_thin_cohort_cycle_pads_the_ranks(setup):
    """Client-level churn on the wire: a trough's cohort is re-assigned
    round-robin so every worker rank keeps a client (the reference's
    cycle-pad); the draws are the JAX aggregator's."""
    from fedml_tpu.distributed.fedavg.aggregator import (
        FedAvgAggregator as JaxAggregator,
    )
    from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator

    trace = dict(seed=4, base=0.3, amplitude=0.3, period=4, tz_spread=0.0)
    agg = FedAvgAggregator(setup["data"], setup["task"],
                           _cfg(per_round=6, trace=trace), worker_num=6,
                           device="cpu")
    jagg = JaxAggregator(setup["jdata"], setup["jtask"],
                         _cfg(per_round=6, trace=trace, jax_=True),
                         worker_num=6)
    thin = 0
    for r in range(8):
        ids = agg.client_sampling(r)
        assert np.array_equal(ids, jagg.client_sampling(r)) and len(ids) == 6
        thin += len(set(ids.tolist())) < 6
    assert thin


def test_tree_under_client_churn_is_its_flat_pairwise_twin(setup):
    """cfg.churn_trace composes with the edge tier: 1 root + 2 edges + 4
    workers bitwise the flat sum_assoc='pairwise' run, model and ledger;
    a rank-level trace under edges= is refused in the reference's words."""
    cfg = _cfg(rounds=3, trace=DIURNAL)
    kw = dict(device="cpu", aggregator="median", sanitize=0.9)
    tree = run_simulated(setup["data"], setup["task"], cfg, edges=2,
                         job_id="tc-tree", **kw)
    flat = run_simulated(setup["data"], setup["task"], cfg,
                         sum_assoc="pairwise", job_id="tc-flat", **kw)
    assert _same(tree.net, flat.net)
    assert tree.quarantine.canonical() == flat.quarantine.canonical()
    with pytest.raises(ValueError, match="RANK-level scheduled "
                                         "availability"):
        run_simulated(setup["data"], setup["task"], cfg, edges=2,
                      device="cpu", job_id="tc-tree-rank",
                      churn_trace=chaos.ChurnTrace(**RANK_TRACE))
