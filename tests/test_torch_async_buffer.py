"""Buffered-async rounds and heartbeat admission in the port
(fedml_tpu_torch/core/async_buffer.py, obs/perf_instrument.py and the
async mode of distributed/fedavg/server_manager.py) against the JAX
package's, on tests/test_async_buffer.py's tiny configuration (synthetic
images of 8 clients, 6x6x1, 3 classes, 12 samples each,
LogisticRegression), from the same seeded numpy inputs and weights.

Tolerances: the staleness oracle bitwise the JAX package's, its torch twin
within the reference's 1e-6; inside the port the degenerate mode (K = cohort, bound 0)
bitwise the synchronous run, model, history and ledger; against the JAX
package's async run within 1e-5. The engine's virtual-clock runner
(``FedAvgAPI.run_async``) mirrors the engine half of the reference's tests
against the port's own sync loop (bitwise at K = cohort, bound 0, the key
chain included) and the JAX runner (stats and ledgers equal, the model
within 1e-5). No test waits out a deadline of more than 0.5 s: the
server's buffer deadline is driven through ``_deadline_fire``, the
runner's is virtual.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.comm.message import pack_pytree as jax_pack
from fedml_tpu.core import async_buffer as J
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.distributed.fedavg import api as jax_api
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.chaos import AdversaryPlan, FaultPlan
from fedml_tpu_torch.comm.message import pack_pytree
from fedml_tpu_torch.core import async_buffer as P
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.core.wal import RoundWAL
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import run_simulated
from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.distributed.fedavg.server_manager import (
    FedAvgServerManager,
)
from fedml_tpu_torch.distributed.utils import backend_kwargs
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs import perf_instrument
from fedml_tpu_torch.obs.metrics import REGISTRY

DATA_KW = dict(num_clients=8, image_shape=(6, 6, 1), num_classes=3,
               samples_per_client=12, test_samples=48, seed=0)
TOL_RUN = dict(rtol=1e-5, atol=1e-6)


def _cfg(rounds=3, per_round=3, freq=1):
    return dict(comm_round=rounds, client_num_in_total=8,
                client_num_per_round=per_round, epochs=1, batch_size=6,
                lr=0.1, frequency_of_the_test=freq, seed=0)


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


def _port(s, job, rounds=3, per_round=3, chaos=None, adversary=None, **kw):
    return run_simulated(
        s["data"], s["task"], FedAvgConfig(**_cfg(rounds, per_round)),
        job_id=job, device="cpu",
        chaos_plan=None if chaos is None else FaultPlan.from_json(chaos),
        adversary_plan=(None if adversary is None
                        else AdversaryPlan.from_json(adversary)), **kw)


def _same(a, b) -> bool:
    return (all(x.tobytes() == y.tobytes() for x, y in
                zip(pack_pytree(a.net), pack_pytree(b.net)))
            and a.history == b.history
            and a.quarantine.canonical() == b.quarantine.canonical())


# ------------------------------------------------------ staleness discounts
@pytest.mark.parametrize("kind,a", [("constant", 0.5), ("polynomial", 0.5),
                                    ("polynomial", 2.0),
                                    ("exponential", 0.3),
                                    ("exponential", 1.0)])
def test_staleness_discounts_match_the_oracle(kind, a):
    """The numpy oracle — the discount the server's flush applies — is
    bitwise the JAX package's; the torch twin matches it within the
    reference's 1e-6 for its device twin (numpy's float32 pow and exp are
    not the device's), and ``constant`` is exactly 1.0 on both."""
    s = np.array([0, 1, 2, 5, 17], np.int32)
    oracle = P.staleness_oracle(kind, a)(s)
    assert oracle.dtype == np.float32
    assert oracle.tobytes() == np.asarray(
        J.staleness_oracle(kind, a)(s), np.float32).tobytes()
    got = P.make_staleness_fn(kind, a)(torch.from_numpy(s)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, oracle, rtol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jax.jit(J.make_staleness_fn(kind, a))(s)),
        rtol=1e-6)
    if kind == "constant":
        assert got.tolist() == oracle.tolist() == [1.0] * len(s)
    else:
        assert all(got[i] >= got[i + 1] for i in range(len(s) - 1))


def test_staleness_policy_spec_parsing_matches_the_reference():
    for spec, bound in (("poly:0.8", 2), ("exp:0.3", None),
                        (None, None), ("polynomial:1.5", 0),
                        ("EXPONENTIAL", 3), ("constant", 0)):
        p = P.StalenessPolicy.from_spec(spec, bound=bound)
        j = J.StalenessPolicy.from_spec(spec, bound=bound)
        assert (p.kind, p.a, p.bound, p.synchronous) == \
            (j.kind, j.a, j.bound, j.synchronous)
        assert [p.admits(s) for s in range(5)] == [j.admits(s)
                                                   for s in range(5)]
    p = P.StalenessPolicy.from_spec("poly:0.8", bound=2)
    assert P.StalenessPolicy.from_spec(p) is p
    assert P.StalenessPolicy.from_spec(p, bound=0).synchronous
    with pytest.raises(ValueError):
        P.StalenessPolicy.from_spec("fancy:1")
    with pytest.raises(ValueError):
        P.StalenessPolicy(bound=-1)
    # the shed vocabulary the metric family pre-registers
    assert P.SHED_REASONS == J.SHED_REASONS
    perf_instrument.ensure_async_shed_families()
    fam = REGISTRY.snapshot()["fed_async_shed_total"]
    assert {f"reason={r}" for r in P.SHED_REASONS} <= set(fam)


# ------------------------------------------------------------- buffer unit
def _bu(rank, version, seq):
    return P.BufferedUpdate(rank=rank, client=rank - 1, version=version,
                            wave=version, payload=None, nsamp=1.0, seq=seq,
                            t_arrival=float(seq))


def test_async_buffer_overflow_sheds_the_stalest():
    journal = []
    buf = P.AsyncBuffer(k=8, capacity=3,
                        journal=lambda ev, e: journal.append((ev, e.rank)))
    assert buf.flush_threshold == 3  # capacity clamps K
    shed = []
    for i, v in enumerate([5, 2, 7]):
        shed += buf.add(_bu(rank=i + 1, version=v, seq=i))
    assert not shed and len(buf) == 3 and buf.ready
    shed = buf.add(_bu(rank=4, version=6, seq=3))
    assert [e.version for e in shed] == [2]
    assert journal[-2:] == [("admit", 4), ("shed", 2)]
    assert [e.rank for e in buf.drain()] == [1, 3, 4]
    assert len(buf) == 0
    with pytest.raises(ValueError):
        P.AsyncBuffer(k=0)


def test_straggle_duration_model_matches_the_reference():
    from fedml_tpu.chaos import FaultPlan as JaxFaultPlan

    spec = {"seed": 7, "rules": [
        {"fault": "straggle", "src": [2], "delay_s": 2.0},
        {"fault": "straggle", "src": [3], "delay_s": 0.5, "prob": 0.5},
        {"fault": "crash", "ranks": [4], "rounds": [1, 3]}]}
    p, j = FaultPlan.from_json(spec), JaxFaultPlan.from_json(spec)
    for rank in range(1, 5):
        for wave in range(4):
            assert P.straggle_delay_s(p, rank, wave) == \
                J.straggle_delay_s(j, rank, wave)
            assert P.crashed_in_wave(p, rank, wave) == \
                J.crashed_in_wave(j, rank, wave)
    assert P.sync_virtual_wallclock(p, 4, 5) == \
        J.sync_virtual_wallclock(j, 4, 5)


# ----------------------------------------------- degenerate bitwise parity
def test_async_k_cohort_bound0_bitwise_equals_sync_and_the_jax_run(setup):
    """K = cohort with bound 0 is the barrier expressed async: bitwise the
    port's sync run (model, history, ledger), and within 1e-5 of the JAX
    package's same async run."""
    sync = _port(setup, "ta-par-sync")
    asy = _port(setup, "ta-par-async", async_buffer_k=3,
                staleness="constant", staleness_bound=0)
    assert _same(sync, asy)
    jasy = jax_api.run_simulated(
        setup["jdata"], setup["jtask"], JaxConfig(**_cfg()),
        job_id="ta-par-jax", async_buffer_k=3, staleness="constant",
        staleness_bound=0)
    for a, b in zip(pack_pytree(asy.net), jax_pack(jasy.net)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL_RUN)
    assert [h["round"] for h in asy.history] == \
        [h["round"] for h in jasy.history]


def test_async_k_cohort_gated_matches_sync_model_and_ledger(setup):
    # a tight norm gate quarantines natural outliers -> non-vacuous ledgers
    kw = dict(aggregator="median", sanitize=0.9)
    sync = _port(setup, "ta-gate-sync", per_round=4, **kw)
    asy = _port(setup, "ta-gate-async", per_round=4, async_buffer_k=4,
                staleness_bound=0, **kw)
    assert _same(sync, asy)
    assert len(sync.quarantine.canonical()) > 0


def test_seeded_async_chaos_run_replays_bit_for_bit(setup):
    """K = cohort, bound 0, a seeded plan of duplicated and delayed uplinks
    and a scaling attacker under the norm gate: two runs are bitwise equal
    (the wave gate drops every duplicate; every flush is the whole cohort,
    gated at the flush)."""
    chaos = {"seed": 11, "rules": [
        {"fault": "duplicate", "src": [1, 2, 3], "dst": [0], "prob": 0.3},
        {"fault": "straggle", "src": [2], "delay_s": 0.02}]}
    adv = {"seed": 5, "rules": [{"attack": "scale", "ranks": [3],
                                 "factor": 50.0, "rounds": [1, 3]}]}
    runs = [_port(setup, f"ta-replay-{i}", rounds=4, chaos=chaos,
                  adversary=adv, async_buffer_k=3, staleness_bound=0,
                  sanitize=True) for i in range(2)]
    assert _same(*runs)
    assert any(e[2] == "norm_outlier"
               for e in runs[0].quarantine.canonical())


def test_unbounded_async_run_completes_and_exports_its_families(setup):
    agg = _port(setup, "ta-unbounded", rounds=5, async_buffer_k=2,
                staleness="poly:0.5")
    assert agg.history[-1]["round"] == 4
    assert all(bool(torch.isfinite(v).all()) for v in agg.net.values())
    prom = REGISTRY.to_prometheus()
    for fam in ("fed_buffer_fill_seconds", "fed_update_staleness",
                "fed_async_shed_total"):
        assert fam in prom, fam


# --------------------------------------------------------------- admission
def _server(setup, job, k=3, **kw):
    agg = FedAvgAggregator(setup["data"], setup["task"],
                           FedAvgConfig(**_cfg(rounds=4)), worker_num=3,
                           device="cpu")
    srv = FedAvgServerManager(agg, rank=0, size=4, async_buffer_k=k,
                              **backend_kwargs("LOOPBACK", job, 0,
                                               "127.0.0.1", 1), **kw)
    sent = []
    srv.send_message = sent.append
    return srv, sent


def _upload(srv, rank, version, leaves=None):
    wave = srv._awaiting[rank]
    return {"sender": rank, MyMessage.MSG_ARG_KEY_ROUND: version,
            MyMessage.MSG_ARG_KEY_DISPATCH_WAVE: wave,
            MyMessage.MSG_ARG_KEY_CLIENT_INDEX: rank - 1,
            MyMessage.MSG_ARG_KEY_NUM_SAMPLES: 12,
            MyMessage.MSG_ARG_KEY_MODEL_PARAMS: (
                leaves if leaves is not None
                else srv.aggregator.get_global_model_params())}


def test_admission_bound_rejects_and_requeues(setup):
    """An arrival staler than the bound is shed ``stale`` and its rank
    requeued with the fresh global at once; one within the bound is
    staged."""
    srv, sent = _server(setup, "ta-bound", staleness_bound=1)
    try:
        srv.send_init_msg()
        srv.round_idx = 3  # three flushes since rank 1's dispatch
        n = len(sent)
        with srv._round_lock:
            srv._handle_async_upload(_upload(srv, 1, version=0))
        assert srv._shed_counts == {"stale": 1} and len(srv._buffer) == 0
        requeue = sent[n]
        assert (requeue.get_receiver_id(),
                requeue.get(MyMessage.MSG_ARG_KEY_ROUND),
                requeue.get(MyMessage.MSG_ARG_KEY_DISPATCH_WAVE)) == (1, 3, 1)
        with srv._round_lock:
            srv._handle_async_upload(_upload(srv, 2, version=2))
        assert len(srv._buffer) == 1 and srv._shed_counts == {"stale": 1}
    finally:
        srv.finish()


def test_nonfinite_arrival_never_enters_the_buffer(setup, monkeypatch):
    orig = P.AsyncBuffer.add

    def checked_add(self, entry):
        assert all(bool(torch.isfinite(v).all())
                   for v in entry.payload.values()), \
            "a non-finite arrival reached the buffer"
        return orig(self, entry)

    monkeypatch.setattr(P.AsyncBuffer, "add", checked_add)
    agg = _port(setup, "ta-nan", rounds=4, async_buffer_k=3,
                staleness="poly:0.5",
                adversary={"seed": 5, "rules": [
                    {"attack": "nan", "ranks": [2], "rounds": [1, 3]}]})
    assert any(e[1] == 2 and e[2] == "nonfinite"
               for e in agg.quarantine.canonical())
    assert all(bool(torch.isfinite(v).all()) for v in agg.net.values())


def test_deadline_flushes_a_partial_buffer(setup):
    """With one arrival staged and K = 3, the buffer deadline (driven, not
    waited) flushes a partial aggregate of that one update; a deadline
    armed for an already-flushed buffer is ignored."""
    srv, sent = _server(setup, "ta-deadline", buffer_deadline_s=600.0)
    try:
        srv.send_init_msg()
        before = srv.aggregator.get_global_model_params()
        leaves = [v + 0.5 for v in before]
        with srv._round_lock:
            srv._handle_async_upload(_upload(srv, 2, version=0,
                                             leaves=leaves))
        epoch = srv._buffer_epoch
        assert len(srv._buffer) == 1 and srv.round_idx == 0
        srv._deadline_fire(epoch)
        assert srv.round_idx == 1 and len(srv._buffer) == 0
        for a, b in zip(srv.aggregator.get_global_model_params(), leaves):
            np.testing.assert_array_equal(a, b)  # a weight-1 mean of one
        srv._deadline_fire(epoch)  # stale epoch: nothing happens
        assert srv.round_idx == 1
    finally:
        srv.finish()


# ------------------------------------------------------------ restart
def test_async_buffered_restart_stays_live_and_ledgers_lost_admits(
        setup, tmp_path):
    """A mid-flight server crash in async mode: the job completes every
    global update, dispatch waves resume past their journaled maxima
    (no (rank, wave) repeats), and the admits that died with the process,
    less the overflow sheds, are ledgered ``server_restart``."""
    agg = _port(setup, "ta-restart", rounds=6, async_buffer_k=3,
                staleness_bound=0, round_timeout_s=30.0,
                ckpt_dir=str(tmp_path),
                chaos={"seed": 1, "rules": [
                    {"fault": "crash", "ranks": [0], "rounds": [2, 3],
                     "after_uploads": 1}]})
    assert agg.history[-1]["round"] == 5
    rep = RoundWAL.replay(os.path.join(str(tmp_path), "wal"))
    seen = [(r["rank"], r["wave"]) for r in rep.of_kind("dispatch")]
    assert len(seen) == len(set(seen))
    # the admits of the crashed boot past its last commit
    boot = [i for i, r in enumerate(rep.records) if r["kind"] == "restart"]
    assert len(boot) == 2
    dead = rep.records[:boot[1]]
    last = max(i for i, r in enumerate(dead) if r["kind"] == "commit")
    tail = dead[last + 1:]
    admits = {(r["rank"], r["wave"]) for r in tail if r["kind"] == "admit"}
    shed = {(r["rank"], r["wave"]) for r in tail if r["kind"] == "shed"}
    lost = [e for e in agg.quarantine.canonical()
            if e[2] == "server_restart"]
    assert len(lost) == len(admits - shed) >= 1
    assert all(e[0] == 2 for e in lost)


# ---------------------------------------------------- heartbeat admission
def test_heartbeat_admission_crash_window_excludes_then_readmits(
        setup, monkeypatch):
    """Rank 2 is dark for rounds [1, 3): heartbeat admission excludes it
    without waiting out a 0.5 s deadline on every round, and readmits it
    after the window (its heartbeat is fresh again). Counted, not timed:
    the server waits out one deadline in each dark round until rank 2's
    heartbeat falls 0.35 s behind its peers' (rounds 1 and 2, or round 1
    alone when round 1 ran slow), and none once it is excluded — round 3,
    where its undeliverable mark would otherwise hold the barrier, and
    the readmission after."""
    from fedml_tpu_torch.obs.comm_instrument import (heartbeat_ages,
                                                     reset_heartbeats)

    waited: list[int] = []
    on_timeout = FedAvgServerManager.on_timeout

    def counted(self, idle_s):
        if not self._finished.is_set():
            waited.append(int(self.round_idx))
        return on_timeout(self, idle_s)

    monkeypatch.setattr(FedAvgServerManager, "on_timeout", counted)
    reset_heartbeats()  # earlier loopback jobs' silence must not leak in
    agg = _port(setup, "ta-hb", rounds=7,
                chaos={"seed": 9, "rules": [
                    {"fault": "crash", "ranks": [2], "rounds": [1, 3]}]},
                round_timeout_s=0.5, heartbeat_max_age_s=0.35)
    assert agg.history and agg.history[-1]["round"] == 6
    dark = [r for r in waited if r >= 1]
    assert dark[:1] == [1] and dark in ([1], [1, 2]), waited
    assert heartbeat_ages().get(2, 1e9) < 5.0


# --------------------------------------------- the engine's async runner
def _eng(s, rounds=3, per_round=4, **kw):
    return FedAvgAPI(s["data"], s["task"],
                     FedAvgConfig(**_cfg(rounds, per_round, freq=100)),
                     device="cpu", **kw)


def _jeng(s, rounds=3, per_round=4, **kw):
    return JaxFedAvgAPI(s["jdata"], s["jtask"],
                        JaxConfig(**_cfg(rounds, per_round, freq=100)), **kw)


def _net_same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def _jax_close(port_net, jnet):
    for a, b in zip(pack_pytree(port_net), jax.tree.leaves(jnet.params)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL_RUN)


def _noise_hook(net, key):
    from fedml_tpu_torch.core.robust import add_gaussian_noise

    return add_gaussian_noise(key, net, 0.01)


def _jax_noise_hook(net, key):
    from fedml_tpu.core.local import NetState
    from fedml_tpu.core.robust import add_gaussian_noise

    return NetState(add_gaussian_noise(key, net.params, 0.01), net.extra)


@pytest.mark.parametrize("hook", [None, "noise"])
def test_engine_async_k_cohort_bound0_bitwise_the_sync_loop(setup, hook):
    """K = cohort with bound 0 is bitwise three run_rounds (the model, the
    key chain), a post-aggregate noise hook included (the flush draws the
    sync round's key); within 1e-5 of the JAX runner."""
    kw = {} if hook is None else {"post_aggregate_hook": _noise_hook}
    sync = _eng(setup, **kw)
    for r in range(3):
        sync.run_round(r)
    eng = _eng(setup, **kw)
    runner = eng.run_async(3, buffer_k=4, staleness="constant",
                           staleness_bound=0)
    assert _net_same(sync.net, eng.net)
    assert np.array_equal(sync.rng, eng.rng)
    st = runner.stats()
    assert st["staleness_max"] == 0 and st["shed"]["stale"] == 0
    jeng = _jeng(setup, **({} if hook is None
                           else {"post_aggregate_hook": _jax_noise_hook}))
    jr = jeng.run_async(3, buffer_k=4, staleness="constant",
                        staleness_bound=0)
    _jax_close(eng.net, jeng.net)
    assert st == jr.stats()


def test_engine_async_gated_k_cohort_matches_sync_model_and_ledger(setup):
    # a tight norm gate quarantines natural outliers -> non-vacuous ledgers
    kw = dict(aggregator="median", sanitize=0.9)
    sync = _eng(setup, **kw)
    for r in range(3):
        sync.run_round(r)
    eng = _eng(setup, **kw)
    eng.run_async(3, buffer_k=4, staleness="constant", staleness_bound=0)
    assert _net_same(sync.net, eng.net)
    assert sync.quarantine.canonical() == eng.quarantine.canonical()
    assert len(sync.quarantine.canonical()) > 0


def _straggle(delay_s=2.0, rank=2, seed=7, jax_=False):
    from fedml_tpu.chaos import FaultPlan as JaxFaultPlan

    spec = {"seed": seed, "rules": [
        {"fault": "straggle", "src": [rank], "delay_s": delay_s}]}
    return (JaxFaultPlan if jax_ else FaultPlan).from_json(spec)


def test_engine_async_straggler_beats_the_sync_barrier_and_replays(setup):
    """A 2 s straggler: 6 updates land sooner on the virtual clock than
    the sync barrier's 6 rounds, staleness is exercised, a second run under
    the same plan replays bitwise (model, ledger, staleness ledger), and
    the JAX runner's stats and ledger are the port's."""
    kw = dict(aggregator="median", sanitize=0.9)
    runs = []
    for _ in range(2):
        eng = _eng(setup, rounds=6, **kw)
        runs.append((eng, eng.run_async(6, buffer_k=3, staleness="exp:0.3",
                                        chaos_plan=_straggle())))
    (ea, ra), (eb, rb) = runs
    assert ra.version == 6
    assert ra.clock < P.sync_virtual_wallclock(_straggle(), 4, 6)
    assert ra.stats()["staleness_max"] >= 1
    assert _net_same(ea.net, eb.net)
    assert ea.quarantine.canonical() == eb.quarantine.canonical()
    assert ra.stats() == rb.stats() and ra.history == rb.history
    je = _jeng(setup, rounds=6, **kw)
    jr = je.run_async(6, buffer_k=3, staleness="exp:0.3",
                      chaos_plan=_straggle(jax_=True))
    assert ra.stats() == jr.stats()
    assert [h["staleness"] for h in ra.history] == \
        [h["staleness"] for h in jr.history]
    assert ea.quarantine.canonical() == je.quarantine.canonical()
    _jax_close(ea.net, je.net)


def test_engine_admission_bound_rejects_and_requeues(setup):
    eng = _eng(setup, rounds=5)
    runner = eng.run_async(5, buffer_k=3, staleness="constant",
                           staleness_bound=1,
                           chaos_plan=_straggle(delay_s=3.5))
    st = runner.stats()
    assert st["updates"] == 5            # progress despite rejections
    assert st["shed"]["stale"] > 0       # the bound actually fired
    assert st["staleness_max"] <= 1      # nothing staler was ever folded


def test_engine_nonfinite_arrival_never_enters_the_buffer(setup):
    eng = _eng(setup, rounds=4)
    runner = P.VirtualClockAsyncRunner(
        eng, buffer_k=3, staleness="poly:0.5",
        adversary_plan=AdversaryPlan.from_json(
            {"seed": 5, "rules": [{"attack": "nan", "ranks": [2],
                                   "rounds": [1, 3]}]}))
    orig = runner.buffer.add

    def checked_add(entry):
        assert all(bool(torch.isfinite(v).all())
                   for v in entry.payload.values()), \
            "a non-finite arrival reached the buffer"
        return orig(entry)

    runner.buffer.add = checked_add
    runner.run(4)
    assert runner.shed_counts["nonfinite"] > 0
    assert any(e[1] == 2 and e[2] == "nonfinite"
               for e in eng.quarantine.canonical())
    assert all(bool(torch.isfinite(v).all()) for v in eng.net.values())


def test_engine_deadline_flushes_a_partial_buffer(setup):
    # only one slot is faster than the deadline: every flush is
    # deadline-driven and partial
    plan = FaultPlan.from_json({"seed": 7, "rules": [
        {"fault": "straggle", "src": [2, 3, 4], "delay_s": 9.0}]})
    eng = _eng(setup, rounds=2)
    runner = eng.run_async(2, buffer_k=4, staleness="poly:0.5",
                           chaos_plan=plan, deadline_s=2.0)
    assert runner.version == 2
    assert all(h["k"] < 4 for h in runner.history), runner.history


def test_engine_async_keeps_the_references_refusals(setup):
    with pytest.raises(ValueError, match="client_result_hook"):
        _eng(setup, client_result_hook=lambda n, g, k: n).run_async(
            1, buffer_k=4)
    with pytest.raises(ValueError, match="adversary_plan"):
        _eng(setup, adversary_plan=AdversaryPlan.from_json(
            {"seed": 1, "rules": [{"attack": "nan", "ranks": [1]}]})
             ).run_async(1, buffer_k=4)
