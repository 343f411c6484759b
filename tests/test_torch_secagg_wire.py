"""The port's masked secure-aggregation tier over the wire
(distributed/turboaggregate.py, flat) against the JAX package's
run_simulated, on tests/test_secure_agg.py's tiny configuration.

Held: the clean run's model within 1e-5 of JAX's, ledgers equal; each
masked upload frame byte-equal to the JAX package's for the same trainer
weights; a JAX server with the port's clients over gRPC finishing with
the all-JAX run's ledger and model; under the same seeded crash plan the
JAX run's ledger and model (1e-5), and the port's own replay bitwise;
recovery, shed-and-rebroadcast, the mid-reveal server crash, the
mid-round crash, DP resume and the per-client ledgers across a restart,
each against the port's own uninterrupted or crash-free oracle, bitwise;
the server's device fold bitwise the numpy fold of the same arrivals;
two masked uploads at the main path's
width through the MQTT broker at once, intact. Every deadline is driven
(test_torch_secure_agg.drive_stalls): no test waits one out.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.chaos import FaultPlan as JaxFaultPlan
from fedml_tpu.comm.message import Message as JaxMessage
from fedml_tpu.core import secure_agg as jsa
from fedml_tpu.distributed import turboaggregate as jta
from fedml_tpu.distributed.utils import launch_simulated as jax_launch
from fedml_tpu.utils.tree import tree_vectorize as jax_tree_vectorize
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgConfig
from fedml_tpu_torch.chaos import FaultPlan
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core import secure_agg as sa
from fedml_tpu_torch.distributed import turboaggregate as ta
from fedml_tpu_torch.distributed.fedavg import run_simulated as plain_run
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.obs.metrics import REGISTRY
from test_torch_comm import free_port_block
from test_torch_secure_agg import (
    FAR_DEADLINE_S,
    MAIN_WIDTH,
    cfg_kw,
    drive_stalls,
    leaves_close,
    same_bits,
    secagg_setup,
)

# cohort 4, rank 2 dark in round 1 of a 2-round job
CRASH = {"seed": 5, "rules": [
    {"fault": "crash", "ranks": [2], "rounds": [1, 2]}]}
CRASH_COHORT = 4


@pytest.fixture(scope="module")
def setup():
    return secagg_setup()


@pytest.fixture
def driven(monkeypatch):
    drive_stalls(monkeypatch)


def _run(s, job, rounds=2, per_round=3, chaos=None, **kw):
    return ta.run_simulated(
        s["data"], s["task"], FedAvgConfig(**cfg_kw(rounds, per_round)),
        job_id=job, device="cpu",
        chaos_plan=None if chaos is None else FaultPlan.from_json(chaos),
        **kw)


def _jrun(s, job, rounds=2, per_round=3, chaos=None, **kw):
    return jta.run_simulated(
        s["jdata"], s["jtask"], JaxConfig(**cfg_kw(rounds, per_round)),
        job_id=job,
        chaos_plan=None if chaos is None else JaxFaultPlan.from_json(chaos),
        **kw)


def _shed_count() -> float:
    return float(REGISTRY.snapshot().get("fed_secagg_rounds_total", {})
                 .get("outcome=shed", 0.0))


@pytest.fixture(scope="module")
def jax_clean(setup):
    return _jrun(setup, "tw-j-clean")


@pytest.fixture(scope="module")
def jax_crash(setup):
    with pytest.MonkeyPatch.context() as mp:
        drive_stalls(mp)
        return _jrun(setup, "tw-j-crash", per_round=CRASH_COHORT,
                     chaos=CRASH, round_timeout_s=FAR_DEADLINE_S)


@pytest.fixture(scope="module")
def crash_only(setup):
    """The port's run under CRASH, and per round the server's device
    accumulator beside the numpy fold of the arrivals it accepted."""
    hosts, folds = {}, []
    add = ta.TAAggregator.add_local_trained_result
    aggregate = ta.TAAggregator.aggregate

    def add_seen(self, index, wire_leaves, *a, **k):
        new = index not in self._round_slots
        add(self, index, wire_leaves, *a, **k)
        if new and index in self._round_slots:
            r = self.current_round
            hosts[r] = sa.fold_masked(hosts.get(r), wire_leaves[0],
                                      self.secagg.p)

    def aggregate_seen(self):
        folds.append((self._acc.clone(), hosts.pop(self.current_round)))
        return aggregate(self)

    with pytest.MonkeyPatch.context() as mp:
        drive_stalls(mp)
        mp.setattr(ta.TAAggregator, "add_local_trained_result", add_seen)
        mp.setattr(ta.TAAggregator, "aggregate", aggregate_seen)
        agg = _run(setup, "tw-rr-o", per_round=CRASH_COHORT, chaos=CRASH,
                   round_timeout_s=FAR_DEADLINE_S)
    return agg, folds


# ------------------------------------------------------------ clean runs
def test_masked_run_matches_jax_run(setup, jax_clean):
    agg = _run(setup, "tw-clean")
    leaves_close(agg.net, jax_clean.net.params)
    assert [h["round"] for h in agg.history] == \
        [h["round"] for h in jax_clean.history]
    assert agg.quarantine.canonical() == jax_clean.quarantine.canonical() \
        == []


def test_masked_round_matches_plain_within_quantization(setup):
    """One masked round against the dense one from the same weights:
    within K * 0.5 / quant_scale (the K quantizations)."""
    cfg = FedAvgConfig(**cfg_kw(1, 4))
    masked = ta.run_simulated(setup["data"], setup["task"], cfg,
                              job_id="tw-q-masked", device="cpu")
    plain = plain_run(setup["data"], setup["task"], cfg, job_id="tw-q-plain",
                      device="cpu")
    bound = 4 * 0.5 / 2**16 + 1e-6
    for k in plain.net:
        assert float((masked.net[k] - plain.net[k]).abs().max()) <= bound


@pytest.mark.parametrize("defense", ["none", "dp"])
def test_upload_frames_byte_equal_jax(setup, defense):
    """The same trainer weights (and broadcast): the port's masked upload
    frame is the JAX package's, byte for byte."""
    cfg_p, cfg_j = FedAvgConfig(**cfg_kw(2, 4)), JaxConfig(**cfg_kw(2, 4))
    kw = dict(defense_type=defense, norm_bound=0.05)
    rs = np.random.RandomState(3)
    for rank, r in ((1, 0), (3, 1)):
        port = ta.SecureTrainer(rank, setup["data"], setup["task"], cfg_p,
                                device="cpu", **kw)
        jtr = jta.SecureTrainer(rank, setup["jdata"], setup["jtask"], cfg_j,
                                **kw)
        glob = {k: v.clone() for k, v in port.net.items()}
        fitted = {k: v + torch.from_numpy(
            rs.randn(*v.shape).astype(np.float32) * 0.01)
            for k, v in glob.items()}
        n = 12
        # the port's trainer after a fit: the broadcast it held, the fit
        port.net = glob
        port._global_vec = port._vector()
        port.net, port._fit_round, port._fit_n = fitted, r, n
        leaves = port.wire_leaves()
        # the JAX trainer's train() body on the same weights
        jparams = convert.to_flax(fitted)
        vec = np.asarray(jax_tree_vectorize(jparams), np.float64)
        if defense == "dp":
            vec = vec - np.asarray(jax_tree_vectorize(
                convert.to_flax(glob)), np.float64)
            nrm = float(np.linalg.norm(vec))
            vec = vec * (0.05 / nrm) if nrm > 0.05 else vec
            w = 1.0
        else:
            w = jtr._round_weight(r, n)
        jleaves = [jsa.mask_update(vec, w, jtr.slot, 0, r, jtr.secagg),
                   jsa.self_mask_shares(0, r, jtr.slot, jtr.secagg)]
        frames = []
        for M, lv in ((Message, leaves), (JaxMessage, jleaves)):
            m = M(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, rank, 0)
            m.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, lv)
            m.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, n)
            m.add_params(MyMessage.MSG_ARG_KEY_ROUND, r)
            frames.append(m.to_bytes())
        assert frames[0] == frames[1], (defense, rank)


def test_mixed_grpc_job_equals_all_jax(setup, jax_clean):
    """The JAX package's masked server with the port's SecureTrainer
    clients over gRPC: the job completes with the all-JAX run's ledger
    and model (1e-5)."""
    pytest.importorskip("grpc")
    size = 4
    base = free_port_block(size)
    jcfg, cfg = JaxConfig(**cfg_kw(2, 3)), FedAvgConfig(**cfg_kw(2, 3))
    agg = jta.TAAggregator(setup["jdata"], setup["jtask"], jcfg,
                           worker_num=size - 1)
    server = jta.TASecureServerManager(agg, rank=0, size=size,
                                       backend="GRPC", base_port=base)
    clients = [ta.TASecureClientManager(
        ta.SecureTrainer(r, setup["data"], setup["task"], cfg, device="cpu"),
        rank=r, size=size, backend="GRPC", base_port=base)
        for r in range(1, size)]
    jax_launch(server, clients)
    got = jax.tree.leaves(server.aggregator.net.params)
    for a, b in zip(got, jax.tree.leaves(jax_clean.net.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert server.aggregator.quarantine.canonical() == \
        jax_clean.quarantine.canonical()
    assert [h["round"] for h in server.aggregator.history] == [0, 1]


# ------------------------------------------------------------ dropouts
def test_crash_dropout_recovers_like_jax_and_replays(setup, jax_crash,
                                                     crash_only, driven):
    """Rank 2 dark: the lost round recovers through the reveal to the
    exact survivor aggregate; the ledger is the JAX package's under
    the same plan, the model within 1e-5 of it, and a replay is bitwise;
    the round record carries the recovery."""
    from fedml_tpu_torch.obs import Telemetry

    before = REGISTRY.snapshot().get("fed_secagg_rounds_total", {})
    dropped = REGISTRY.total("fed_secagg_dropped_slots_total")
    reveals = REGISTRY.snapshot().get("fed_secagg_recovery_seconds", {}) \
        .get("", {}).get("count", 0)
    tel = Telemetry()
    agg = _run(setup, "tw-crash", per_round=CRASH_COHORT,
               chaos=CRASH,
               round_timeout_s=FAR_DEADLINE_S, telemetry=tel)
    tel.close()
    led = agg.quarantine.canonical()
    assert led == jax_crash.quarantine.canonical()
    drops = [e for e in led if e[2] == "secagg_dropout"]
    assert [(e[0], e[1]) for e in drops] == [(1, 2)], led
    leaves_close(agg.net, jax_crash.net.params)
    after = REGISTRY.snapshot().get("fed_secagg_rounds_total", {})
    assert after.get("outcome=recovered", 0) >= \
        before.get("outcome=recovered", 0) + 1
    assert REGISTRY.total("fed_secagg_dropped_slots_total") >= dropped + 1
    assert REGISTRY.snapshot()["fed_secagg_recovery_seconds"][""][
        "count"] >= reveals + 1
    recs = [r for r in tel.events.sink.records if r.get("kind") == "round"]
    sec = [r["secagg"] for r in recs]
    assert [s["outcome"] for s in sec] == ["full", "recovered"]
    assert sec[1]["dead"] == [1] and sec[1]["recovery_s"] >= 0.0
    # the replay: the same plan's run without telemetry
    again, _ = crash_only
    assert again.quarantine.canonical() == led
    assert same_bits(again.net, agg.net)


def test_below_threshold_round_sheds_rebroadcasts_reconverges(setup,
                                                              driven):
    """2 survivors < t+1 = 3: the round sheds (every lost slot ledgered,
    the outcome counted), re-broadcasts, and the retry — the drop budget
    spent — ends bitwise the clean run."""
    clean = _run(setup, "tw-clean4", per_round=4)
    plan = {"seed": 2, "rules": [
        {"fault": "drop", "direction": "send", "src": [2, 3], "dst": [0],
         "rounds": [1, 2], "max_per_link": 1}]}
    before = _shed_count()
    shed = _run(setup, "tw-shed", per_round=4, chaos=plan,
                round_timeout_s=FAR_DEADLINE_S, threshold_t=2)
    led = shed.quarantine.canonical()
    assert {e[1] for e in led if e[2] == "secagg_shed"} == {2, 3}, led
    assert _shed_count() == before + 1
    assert shed.history[-1]["round"] == 1
    assert same_bits(clean.net, shed.net)


@pytest.mark.parametrize("lost", [1, 2])
def test_reveal_retry_heals_a_lost_reply_or_sheds(setup, crash_only, driven,
                                                  monkeypatch, lost):
    """Rank 2 dark in round 1; rank 3's reveal reply is lost ``lost``
    times. The watchdog's first fire re-sends the reveal request (the
    client's cache answers it verbatim): one loss heals into a recovered
    round. Its second fire sheds: two losses shed the round (slot 1
    ledgered secagg_shed) and the re-broadcast recovers. Either way the
    job ends as the crash-only run: the decoded round is the same."""
    oracle, _ = crash_only
    asked, dropped, servers = {}, {}, []
    request = ta.TASecureServerManager._send_reveal_requests

    def counted(self, survivors, dead):
        if self not in servers:
            servers.append(self)
        for slot in survivors:
            asked[slot + 1] = asked.get(slot + 1, 0) + 1
        return request(self, survivors, dead)

    send = ta.TASecureClientManager.send_message

    def lossy(self, msg):
        if (self.rank == 3 and dropped.get(3, 0) < lost and msg.get_type()
                == MyMessage.MSG_TYPE_C2S_REVEAL_SHARES):
            dropped[3] = dropped.get(3, 0) + 1
            return
        return send(self, msg)

    monkeypatch.setattr(ta.TASecureServerManager, "_send_reveal_requests",
                        counted)
    monkeypatch.setattr(ta.TASecureClientManager, "send_message", lossy)
    stop = threading.Event()

    def drive_reveals():
        # the recovery phase's deadline: every reply that can still land
        # has, rank 3's lost on each of its requests so far
        while not stop.wait(0.002):
            for srv in servers:
                with srv._round_lock:
                    rv = srv._reveal
                    fire = (srv._phase == "recovery" and rv is not None
                            and set(rv["seeds"]) == set(rv["survivors"])
                            - {2} and dropped.get(3, 0) >= asked.get(3, 0))
                if fire:
                    srv.on_timeout(FAR_DEADLINE_S)

    t = threading.Thread(target=drive_reveals, daemon=True)
    t.start()
    try:
        agg = _run(setup, f"tw-rr-{lost}", per_round=CRASH_COHORT,
                   chaos=CRASH, round_timeout_s=FAR_DEADLINE_S)
    finally:
        stop.set()
        t.join(timeout=10)
    # one request and its retry; a shed round's re-run asks once more
    assert dropped[3] == lost and asked[3] == lost + 1
    led = agg.quarantine.canonical()
    assert [(e[0], e[1], e[2]) for e in led] == (
        [(1, 2, "secagg_dropout")] if lost == 1 else
        [(1, 2, "secagg_dropout"), (1, 2, "secagg_shed")]), led
    assert same_bits(agg.net, oracle.net)
    assert agg.history[-1]["round"] == 1


def test_reveal_covers_only_dead_pairs(setup):
    trainer = ta.SecureTrainer(3, setup["data"], setup["task"],
                               FedAvgConfig(**cfg_kw(2, 5)), device="cpu")
    assert trainer.slot == 2
    seeds = trainer.reveal_pair_seeds(1, [0, 4])
    pks = sa.public_keys(0, 1, 5)
    assert seeds == [sa.pair_seed(sa.secret_key(0, 1, j), pks[2])
                     for j in (0, 4)]
    jtr = jta.SecureTrainer(3, setup["jdata"], setup["jtask"],
                            JaxConfig(**cfg_kw(2, 5)))
    assert seeds == jtr.reveal_pair_seeds(1, [0, 4])


def test_duplicate_masked_upload_folds_exactly_once(setup):
    agg = ta.TAAggregator(setup["data"], setup["task"],
                          FedAvgConfig(**cfg_kw(2, 3)), worker_num=3,
                          device="cpu")
    agg.begin_round(0)
    masked, shares = np.arange(7, dtype=np.int64), np.zeros(3, np.int64)
    agg.add_local_trained_result(0, [masked, shares], 5, round_idx=0)
    once = np.asarray(agg._acc).copy()
    agg.add_local_trained_result(0, [masked, shares], 5, round_idx=0)
    assert np.array_equal(agg._acc, once)
    agg._frozen = True  # recovery in flight: late uploads are parked
    agg.add_local_trained_result(1, [masked, shares], 5, round_idx=0)
    assert 1 not in agg._round_slots


def test_client_reveal_cache_retransmits_verbatim(setup):
    trainer = ta.SecureTrainer(3, setup["data"], setup["task"],
                               FedAvgConfig(**cfg_kw(2, 5)), device="cpu")
    mgr = ta.TASecureClientManager(trainer, rank=3, size=6,
                                   backend="LOOPBACK", job_id="tw-cache")
    try:
        sent, calls = [], []
        mgr.send_message = sent.append
        real = trainer.reveal_pair_seeds
        trainer.reveal_pair_seeds = lambda r, d: (
            calls.append((r, tuple(d))) or real(r, d))
        req = {MyMessage.MSG_ARG_KEY_ROUND: 1,
               MyMessage.MSG_ARG_KEY_SECAGG_DEAD: np.asarray([0, 4])}
        mgr.handle_message_reveal_request(dict(req))
        mgr.handle_message_reveal_request(dict(req))
        assert len(calls) == 1 and len(sent) == 2
        assert sent[0].to_bytes() == sent[1].to_bytes()
        mgr.handle_message_reveal_request(
            {MyMessage.MSG_ARG_KEY_ROUND: 1,
             MyMessage.MSG_ARG_KEY_SECAGG_DEAD: np.asarray([4])})
        assert calls[-1] == (1, (4,)) and list(mgr._reveal_cache) == \
            [(1, (4,))]
    finally:
        mgr.finish()


def test_server_refuses_unwired_modes_and_malformed_uploads(setup):
    agg = ta.TAAggregator(setup["data"], setup["task"],
                          FedAvgConfig(**cfg_kw(2, 3)), worker_num=3,
                          device="cpu")
    for kw in ({"async_buffer_k": 2}, {"delta_broadcast": True},
               {"heartbeat_max_age_s": 5.0}):
        with pytest.raises(ValueError):
            ta.TASecureServerManager(agg, rank=0, size=4, backend="LOOPBACK",
                                     job_id="tw-refuse", **kw)
    with pytest.raises(ValueError, match="defense_type"):
        ta.TAAggregator(setup["data"], setup["task"],
                        FedAvgConfig(**cfg_kw(2, 3)), worker_num=3,
                        defense_type="krum", device="cpu")
    server = ta.TASecureServerManager(agg, rank=0, size=4,
                                      backend="LOOPBACK", job_id="tw-bad")
    try:
        n = sum(v.numel() for v in agg.net.values())
        good = [np.zeros(n, np.int64), np.zeros(3, np.int64)]
        ok = server._decode_upload(
            {MyMessage.MSG_ARG_KEY_MODEL_PARAMS: good}, 1, 0)
        assert ok is good
        for bad in ([np.zeros(n, np.float32), good[1]],
                    [np.zeros(n - 1, np.int64), good[1]],
                    [good[0], np.zeros(2, np.int64)], [good[0]]):
            assert server._decode_upload(
                {MyMessage.MSG_ARG_KEY_MODEL_PARAMS: bad}, 1, 0) is None
        assert [e["reason"] for e in agg.quarantine.entries()] == \
            ["undecodable"] * 4
    finally:
        server.com_manager.stop_receive_message()


# ------------------------------------------------------ server crashes
def test_mid_reveal_crash_sheds_and_retries_clean(setup, tmp_path, driven):
    """The server dies at the reveal fan-out (after_uploads=-1) while
    rank 3 is dark: recovery sheds the half-revealed round (the reveal's
    dead slot ledgered secagg_shed, one shed counted) and the re-run ends
    bitwise the client-crash-only run."""
    client_crash = {"fault": "crash", "ranks": [3], "rounds": [1, 2]}
    oracle = _run(setup, "tw-mr-o", rounds=3, per_round=4,
                  chaos={"seed": 2, "rules": [dict(client_crash)]},
                  round_timeout_s=FAR_DEADLINE_S)
    before = _shed_count()
    crashed = _run(setup, "tw-mr-c", rounds=3, per_round=4,
                   chaos={"seed": 2, "rules": [
                       dict(client_crash),
                       {"fault": "crash", "ranks": [0], "rounds": [1, 2],
                        "after_uploads": -1}]},
                   round_timeout_s=FAR_DEADLINE_S,
                   ckpt_dir=str(tmp_path / "ck"))
    assert crashed.history[-1]["round"] == 2
    shed = [e for e in crashed.quarantine.entries()
            if e["reason"] == "secagg_shed"]
    assert [(e["round"], e["rank"]) for e in shed] == [(1, 3)]
    assert _shed_count() == before + 1
    assert same_bits(crashed.net, oracle.net)


def test_mid_round_crash_clean_retry(setup, tmp_path, driven):
    """Masked uploads lost to a mid-round crash: the fresh boot holds no
    fold, the re-run round decodes clean — bitwise the uninterrupted run,
    the 2 lost uploads ledgered server_restart."""
    oracle = _run(setup, "tw-mu-o", rounds=3, per_round=4)
    crashed = _run(setup, "tw-mu-c", rounds=3, per_round=4,
                   chaos={"seed": 1, "rules": [
                       {"fault": "crash", "ranks": [0], "rounds": [1, 2],
                        "after_uploads": 2}]},
                   round_timeout_s=FAR_DEADLINE_S,
                   ckpt_dir=str(tmp_path / "ck"))
    assert same_bits(crashed.net, oracle.net)
    assert len([e for e in crashed.quarantine.entries()
                if e["reason"] == "server_restart"]) == 2


# ------------------------------------------------------------------- DP
DP = dict(defense_type="dp", noise_multiplier=1.0, norm_bound=0.5)


def test_dp_epsilon_and_noise_keys_survive_resume(setup, tmp_path):
    """A DP run interrupted after round 1 and resumed from its checkpoint
    equals the uninterrupted run: model bits (the noise keys continue),
    ε and the RDP totals; each record carries privacy and secagg."""
    from fedml_tpu_torch.obs import Telemetry

    ck = str(tmp_path / "ck")
    tel = Telemetry()
    full = _run(setup, "tw-dp-full", rounds=4, telemetry=tel, **DP)
    tel.close()
    _run(setup, "tw-dp-a", rounds=2, ckpt_dir=ck, **DP)
    resumed = _run(setup, "tw-dp-b", rounds=4, ckpt_dir=ck, **DP)
    assert same_bits(full.net, resumed.net)
    assert np.array_equal(full._noise_rng, resumed._noise_rng)
    assert resumed.privacy_record()["eps"] == pytest.approx(
        full.privacy_record()["eps"], abs=1e-9)
    np.testing.assert_allclose(resumed.accountant._rdp, full.accountant._rdp,
                               rtol=1e-12)
    recs = [r for r in tel.events.sink.records if r.get("kind") == "round"]
    eps = [r["privacy"]["eps"] for r in recs]
    assert len(recs) == 4 and eps == sorted(eps) and eps[0] > 0
    assert all(r["privacy"]["m"] == 3 and r["secagg"]["outcome"] == "full"
               for r in recs)


def test_client_eps_exact_across_server_sigkill(setup, tmp_path):
    """Per-client ε across a supervised restart: killed between commits,
    every client's ε equals the uninterrupted run's; killed mid-round, it
    is never below it (the precharge replay over-counts at most one
    round)."""
    def run(job, ck, crash=None):
        return _run(setup, job, rounds=3, per_round=4,
                    chaos=None if crash is None else {"seed": 1, "rules": [
                        dict({"fault": "crash", "ranks": [0]}, **crash)]},
                    round_timeout_s=FAR_DEADLINE_S,
                    ckpt_dir=str(tmp_path / ck), **DP)

    oracle = run("tw-pcl-o", "o")
    ids = sorted(oracle.client_ledger._rdp)
    assert ids
    bc = run("tw-pcl-bc", "b", {"rounds": [2, 3]})
    assert bc.client_ledger.summary() == oracle.client_ledger.summary()
    for cid in ids:
        assert bc.client_ledger.epsilon(cid) == pytest.approx(
            oracle.client_ledger.epsilon(cid), rel=1e-12)
    mid = run("tw-pcl-mid", "m", {"rounds": [1, 2], "after_uploads": 2})
    for cid in ids:
        assert mid.client_ledger.epsilon(cid) >= \
            oracle.client_ledger.epsilon(cid) - 1e-12


# ---------------------------------------------------------- device fold
def test_device_fold_is_bitwise_the_host_fold(crash_only):
    """The server folds each accepted arrival on its device: every
    round's accumulator, the dropout round's included, is bitwise the
    numpy fold (``fold_masked``) of the same arrivals."""
    agg, folds = crash_only
    assert len(folds) == 2
    for acc, host in folds:
        assert acc.dtype == torch.int64 and np.array_equal(acc.numpy(), host)
    assert [e[2] for e in agg.quarantine.canonical()] == ["secagg_dropout"]
    assert agg.agg_record()["fused"] is True


# --------------------------------------------------------------- MQTT
def test_mqtt_carries_two_masked_uploads_at_once():
    """Two masked uploads at the main path's width (13,520,368 B of int64
    each) published at the same instant through the bundled broker:
    both frames arrive whole and decode to their payloads."""
    from fedml_tpu_torch.comm.mqtt_mini import MiniMqttBroker, MiniMqttClient

    rs = np.random.RandomState(0)
    frames = {}
    for i, t in enumerate(("u1", "u2")):
        m = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, i + 1, 0)
        m.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, [
            rs.randint(0, sa.P_DEFAULT, MAIN_WIDTH).astype(np.int64),
            rs.randint(0, sa.P_DEFAULT, 10).astype(np.int64)])
        frames[t] = m.to_bytes()
    assert all(len(f) > MAIN_WIDTH * 8 for f in frames.values())
    broker = MiniMqttBroker()
    got, done = {}, threading.Event()

    def on(topic, payload):
        got[topic] = payload
        if len(got) == 2:
            done.set()

    clients = [MiniMqttClient("127.0.0.1", broker.port, "sub", on_message=on)]
    try:
        for t in frames:
            clients[0].subscribe(t)
        pubs = [MiniMqttClient("127.0.0.1", broker.port, f"p{t}")
                for t in frames]
        clients += pubs
        time.sleep(0.02)  # the SUBSCRIBEs land before the uploads
        go = threading.Barrier(2)

        def upload(c, t):
            go.wait()
            c.publish(t, frames[t], qos=1)

        threads = [threading.Thread(target=upload, args=(c, t))
                   for c, t in zip(pubs, frames)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert done.wait(10.0), sorted(got)
        for t, f in frames.items():
            assert got[t] == f
            back = Message.from_bytes(got[t]).get_params()
            leaves = back[MyMessage.MSG_ARG_KEY_MODEL_PARAMS]
            assert leaves[0].dtype == np.int64 and \
                leaves[0].shape == (MAIN_WIDTH,)
    finally:
        for c in clients:
            c.close()
        broker.close()
