"""Server crash recovery in the port (fedml_tpu_torch/core/wal.py,
core/checkpoint.py, obs/flightrec.py and the crash paths of
distributed/fedavg/server_manager.py, client_manager.py, api.py and
hierarchy.py) against the JAX package's, on tests/test_server_crash.py's
tiny configuration (synthetic images of 8 clients, 8x8x1, 4 classes, 24
samples each, LogisticRegression, 3 clients a round, 4 rounds), from the
same seeded numpy inputs and weights.

Tolerances: inside the port a crashed run is held to its own uninterrupted
run bitwise (model, and ledger plus the ``server_restart`` slots), as the
reference holds its own; against the JAX package's crashed run within
1e-5 (the two packages sum in other orders) with ledgers equal. Which
uploads a mid-round crash catches depends on the order the client threads
finish their fits, so the lost slots are compared by count, round and the
client each rank trained, not by rank.

No test waits out a deadline: the elastic rounds and the resume backstop of
the dead-client run are driven (``_drive_stalls``), and the backstop never
fires in a run whose ranks all answer the probe."""

import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.chaos import FaultPlan as JaxFaultPlan
from fedml_tpu.comm.message import Message as JaxMessage
from fedml_tpu.comm.message import pack_pytree as jax_pack
from fedml_tpu.core import checkpoint as jax_ckpt
from fedml_tpu.core import wal as jax_wal
from fedml_tpu.core.local import NetState
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.distributed.fedavg import api as jax_api
from fedml_tpu.distributed.fedavg import server_manager as jax_sm
from fedml_tpu.distributed.utils import backend_kwargs as jax_backend_kwargs
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgConfig
from fedml_tpu_torch.chaos import FaultPlan, FaultRule
from fedml_tpu_torch.comm.message import Message, pack_pytree
from fedml_tpu_torch.core import checkpoint as P
from fedml_tpu_torch.core.robust_agg import QuarantineLedger
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.core.wal import _HDR, _MAGIC, _SEGMENT, RoundWAL
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import run_simulated
from fedml_tpu_torch.distributed.fedavg.aggregator import FedAvgAggregator
from fedml_tpu_torch.distributed.fedavg.client_manager import (
    FedAvgClientManager,
)
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.distributed.fedavg.server_manager import (
    FedAvgServerManager,
)
from fedml_tpu_torch.distributed.fedavg.trainer import DistributedTrainer
from fedml_tpu_torch.distributed.utils import backend_kwargs
from fedml_tpu_torch.experiments import distributed_launch
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs.metrics import REGISTRY
from test_torch_tracing import copy_of

DATA_KW = dict(num_clients=8, image_shape=(8, 8, 1), num_classes=4,
               samples_per_client=24, test_samples=96, seed=3)
TOL_RUN = dict(rtol=1e-5, atol=1e-6)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(rounds=4, per_round=3):
    return dict(comm_round=rounds, client_num_in_total=8,
                client_num_per_round=per_round, epochs=1, batch_size=8,
                lr=0.1, frequency_of_the_test=1, seed=0)


def _crash_rules(round_idx, after_uploads=None):
    rule = {"fault": "crash", "ranks": [0],
            "rounds": [round_idx, round_idx + 1]}
    if after_uploads is not None:
        rule["after_uploads"] = after_uploads
    return [rule]


@pytest.fixture(scope="module")
def setup():
    """Both packages' data (bitwise equal) and tasks; the port's task inits
    to the JAX aggregator's initial params."""
    jdata = jax_synthetic_images(**DATA_KW)
    jtask = jax_classification_task(JaxLR(num_classes=4))
    _, key = jax.random.split(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtask.init(
        key, jnp.asarray(jdata.train_x[:8])).params)
    state = convert.from_flax(params)
    task = classification_task(create_model("lr", output_dim=4, device="cpu"))
    task = task._replace(init=lambda g, x=None: {k: v.clone()
                                                 for k, v in state.items()})
    return dict(data=synthetic_images(**DATA_KW), task=task, jdata=jdata,
                jtask=jtask)


@pytest.fixture(scope="module")
def no_orbax():
    """The JAX package writes the npz layout (its orbax-less fallback), the
    one the port reads: tests/test_wal.py's force_npz, module-wide."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "orbax", None)
        mp.setitem(sys.modules, "orbax.checkpoint", None)
        yield


def _port(s, job, rules=(), rounds=4, per_round=3, **kw):
    return run_simulated(
        s["data"], s["task"], FedAvgConfig(**_cfg(rounds, per_round)),
        job_id=job, device="cpu",
        chaos_plan=(FaultPlan.from_json({"seed": 1, "rules": list(rules)})
                    if rules else None), **kw)


def _jax(s, job, rules=(), rounds=4, per_round=3, **kw):
    return jax_api.run_simulated(
        s["jdata"], s["jtask"], JaxConfig(**_cfg(rounds, per_round)),
        job_id=job,
        chaos_plan=(JaxFaultPlan.from_json({"seed": 1, "rules": list(rules)})
                    if rules else None), **kw)


def _same_bits(a, b) -> bool:
    return all(x.tobytes() == y.tobytes()
               for x, y in zip(pack_pytree(a.net), pack_pytree(b.net)))


def _close_to_jax(port_agg, jax_agg):
    for p, j in zip(pack_pytree(port_agg.net), jax_pack(jax_agg.net)):
        np.testing.assert_allclose(p, np.asarray(j), **TOL_RUN)
    assert [h["round"] for h in port_agg.history] == \
        [h["round"] for h in jax_agg.history]
    for hp, hj in zip(port_agg.history, jax_agg.history):
        np.testing.assert_allclose(hp["test_loss"], hj["test_loss"],
                                   **TOL_RUN)


def _split(ledger):
    """(entries other than server_restart, server_restart entries)."""
    return ([e for e in ledger if e[2] != "server_restart"],
            [e for e in ledger if e[2] == "server_restart"])


def _lost_slots_agree(port_agg, jax_agg):
    """Equal ledgers, the lost slots compared by count, round and the
    client each rank trained (which uploads a crash catches is thread
    timing, the same in both packages' contract)."""
    p_rest, p_lost = _split(port_agg.quarantine.canonical())
    j_rest, j_lost = _split(jax_agg.quarantine.canonical())
    assert p_rest == j_rest
    assert len(p_lost) == len(j_lost)
    assert sorted(e[0] for e in p_lost) == sorted(e[0] for e in j_lost)
    for rnd, rank, _, client in p_lost:
        assert client == int(port_agg.client_sampling(rnd)[rank - 1])
    assert len({(e[0], e[1]) for e in p_lost}) == len(p_lost)


def _wal(ckpt):
    return RoundWAL.replay(os.path.join(str(ckpt), "wal"))


# ----------------------------------------------------------------- copies
@pytest.mark.parametrize("path", ["core/wal.py", "obs/flightrec.py"])
def test_copied_modules_match_the_reference(path):
    with open(os.path.join(ROOT, "fedml_tpu_torch", path)) as f:
        assert f.read() == copy_of(path)


# -------------------------------------------------------------------- WAL
def _appends(wal):
    wal.append("restart", sync=True, epoch=0, ts=1.0)
    wal.append("broadcast", sync=True, round=0, ts=1.25)
    wal.append("upload", sync=True, round=0, rank=1, client=5, nsamp=24.0,
               ts=1.5)
    wal.append("quarantine", round=0, rank=2, reason="nonfinite", client=3,
               ts=1.75)
    wal.append("commit", sync=True, round=0, ts=2.0)
    wal.append("dispatch", sync=True, round=1, rank=2, wave=4, client=7,
               ts=2.5)
    wal.close()


def test_wal_frames_are_byte_equal_and_cross_replay(tmp_path):
    """The same appends with pinned ``ts`` give byte-equal files, and each
    package replays the other's."""
    _appends(RoundWAL(str(tmp_path / "p")))
    _appends(jax_wal.RoundWAL(str(tmp_path / "j")))
    p = (tmp_path / "p" / _SEGMENT).read_bytes()
    assert p == (tmp_path / "j" / _SEGMENT).read_bytes()
    assert p[:8] == b"FWAL0001"
    from_jax = RoundWAL.replay(str(tmp_path / "j"))
    from_port = jax_wal.RoundWAL.replay(str(tmp_path / "p"))
    assert from_jax.records == from_port.records
    assert from_jax.last_commit == 0 and from_port.restart_epochs == 1
    assert from_jax.dispatch_waves() == {2: 4}


def _two_records(d):
    w = RoundWAL(str(d))
    w.append("broadcast", sync=True, round=0)
    w.append("commit", sync=True, round=0)
    w.close()
    return os.path.join(str(d), _SEGMENT)


@pytest.mark.parametrize("damage", ["torn_tail", "corrupt_frame",
                                    "bad_magic", "reopen_after_torn"])
def test_wal_damage_contracts(tmp_path, damage):
    """A torn tail is dropped and counted; a corrupt frame truncates the
    suffix (never misparses); a bad magic replays empty and is set aside
    on reopen; a reopen truncates a torn tail so the new boot's records
    stay replayable."""
    path = _two_records(tmp_path)
    data = open(path, "rb").read()
    if damage == "torn_tail":
        open(path, "wb").write(data[:-7])
        rep = RoundWAL.replay(str(tmp_path))
        assert rep.torn == 1 and [r["kind"] for r in rep.records] == [
            "broadcast"]
    elif damage == "corrupt_frame":
        length, _ = _HDR.unpack_from(data, len(_MAGIC))
        at = len(_MAGIC) + _HDR.size + length + _HDR.size
        open(path, "wb").write(data[:at] + bytes([data[at] ^ 0xFF])
                               + data[at + 1:])
        rep = RoundWAL.replay(str(tmp_path))
        assert rep.torn == 1 and rep.last_commit == -1
        assert [r["kind"] for r in rep.records] == ["broadcast"]
    elif damage == "bad_magic":
        open(path, "wb").write(b"NOTAMAGIC-garbage")
        rep = RoundWAL.replay(str(tmp_path))
        assert rep.records == [] and rep.torn == 1
        w = RoundWAL(str(tmp_path))
        w.append("restart", sync=True, epoch=0)
        w.close()
        assert RoundWAL.replay(str(tmp_path)).restart_epochs == 1
        assert os.path.exists(path + ".corrupt")
    else:
        open(path, "ab").write(_HDR.pack(99, 12345) + b"torn")
        w = RoundWAL(str(tmp_path))
        w.append("restart", sync=True, epoch=1)
        w.close()
        rep = RoundWAL.replay(str(tmp_path))
        assert rep.torn == 0 and rep.restart_epochs == 1
        assert [r["kind"] for r in rep.records] == [
            "broadcast", "commit", "restart"]


def test_wal_open_round_and_since_last_commit(tmp_path):
    wal = RoundWAL(str(tmp_path))
    wal.append("broadcast", sync=True, round=0)
    wal.append("upload", sync=True, round=0, rank=1)
    wal.commit(0)
    wal.append("broadcast", sync=True, round=1)
    wal.append("upload", sync=True, round=1, rank=2, client=7)
    wal.close()
    rep = RoundWAL.replay(str(tmp_path))
    assert rep.open_round(0) == 1 and rep.open_round(1) is None
    assert [(r["round"], r["rank"]) for r in
            rep.since_last_commit("upload")] == [(1, 2)]
    assert [r["kind"] for r in rep.since_last_commit()] == [
        "broadcast", "upload"]


def test_wal_since_last_commit_accumulates_across_double_crash(tmp_path):
    wal = RoundWAL(str(tmp_path))
    wal.commit(0)
    wal.append("broadcast", sync=True, round=1)
    wal.append("upload", sync=True, round=1, rank=1)   # boot 1, lost
    wal.append("restart", sync=True, epoch=1)          # boot 2
    wal.append("broadcast", sync=True, round=1)
    wal.append("upload", sync=True, round=1, rank=3)   # boot 2, lost
    wal.close()
    rep = RoundWAL.replay(str(tmp_path))
    assert [r["rank"] for r in rep.since_last_commit("upload")] == [1, 3]
    wal = RoundWAL(str(tmp_path))
    wal.commit(1)
    wal.close()
    assert RoundWAL.replay(str(tmp_path)).since_last_commit("upload") == []


def test_wal_dispatch_waves_maxima(tmp_path):
    wal = RoundWAL(str(tmp_path))
    for rank, wave in ((1, 0), (2, 0), (1, 1), (1, 2), (2, 1)):
        wal.append("dispatch", sync=True, round=0, rank=rank, wave=wave)
    wal.close()
    assert RoundWAL.replay(str(tmp_path)).dispatch_waves() == {1: 2, 2: 1}


def test_quarantine_verdict_journals_one_wal_record(tmp_path):
    """The ledger's journal hook (the reference's): one verdict, one
    ``quarantine`` record with the reference's fields; a restore does not
    re-journal."""
    wal = RoundWAL(str(tmp_path))
    led = QuarantineLedger()
    led.journal = lambda e: wal.append("quarantine", **e)
    led.record(2, 3, "nonfinite", client=6)
    led.restore([{"round": 1, "rank": 2, "reason": "norm_outlier",
                  "client": None}])
    wal.close()
    recs = RoundWAL.replay(str(tmp_path)).of_kind("quarantine")
    assert len(recs) == 1
    rec = dict(recs[0])
    assert isinstance(rec.pop("ts"), float)
    assert rec == {"kind": "quarantine", "round": 2, "rank": 3,
                   "reason": "nonfinite", "client": 6}


# ------------------------------------------------------------- checkpoint
def _tiny_cnn_state(seed=0):
    """CNNOriginalFedAvg's state layout at tiny widths (conv 4 and 8
    channels, a 16-wide dense layer, 5 classes on 28x28 inputs)."""
    rs = np.random.RandomState(seed)
    shapes = {"conv1.weight": (4, 1, 5, 5), "conv1.bias": (4,),
              "conv2.weight": (8, 4, 5, 5), "conv2.bias": (8,),
              "fc1.weight": (16, 8 * 7 * 7), "fc1.bias": (16,),
              "fc2.weight": (5, 16), "fc2.bias": (5,)}
    return {k: torch.from_numpy(rs.randn(*v).astype(np.float32))
            for k, v in shapes.items()}


def _lr_state(seed=0):
    rs = np.random.RandomState(seed)
    return {"linear.weight": torch.from_numpy(
                rs.randn(4, 64).astype(np.float32)),
            "linear.bias": torch.from_numpy(rs.randn(4).astype(np.float32))}


def _jax_template(state):
    params = convert.to_flax({k: torch.zeros(v.shape)
                              for k, v in state.items()})
    return {"net": NetState(params=params, extra={}),
            "server_opt_state": (), "rng": jax.random.PRNGKey(0),
            "round": np.asarray(0, np.int64)}


def _port_template(state):
    return {"net": {k: torch.zeros_like(v) for k, v in state.items()},
            "server_opt_state": (), "rng": np.zeros(2, np.uint32),
            "round": np.asarray(0, np.int64)}


@pytest.mark.parametrize("model", ["lr", "tiny_cnn"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoints_cross_restore_bitwise(tmp_path, no_orbax, model,
                                           direction):
    """A port npz restores in the JAX package and a JAX npz in the port,
    bits equal — the treedef string and leaf order are the reference's."""
    state = (_lr_state if model == "lr" else _tiny_cnn_state)(seed=7)
    d = str(tmp_path)
    if direction == "port_to_jax":
        P.save_round(d, 3, state, (), np.zeros(2, np.uint32),
                     history=[{"round": 3}])
        r, got = jax_ckpt.restore_latest(d, _jax_template(state))
        leaves = jax.tree.leaves(got["net"])
    else:
        params = jax.tree.map(np.asarray, convert.to_flax(state))
        jax_ckpt.save_round(d, 3, NetState(params=params, extra={}), (),
                            jax.random.PRNGKey(0), history=[{"round": 3}])
        r, got = P.restore_latest(d, _port_template(state))
        leaves = pack_pytree(got["net"])
    assert r == 3 and int(got["round"]) == 3
    assert np.asarray(got["rng"]).tolist() == [0, 0]
    want = pack_pytree(state)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert np.asarray(a).tobytes() == b.tobytes()
    if direction == "jax_to_port":
        assert all(torch.equal(got["net"][k], v) for k, v in state.items())
    npz = np.load(os.path.join(d, "round_000003.npz"))
    assert str(npz["treedef"]) == str(jax.tree.structure(
        _jax_template(state)))


def test_torn_newest_checkpoint_falls_back_and_is_counted(tmp_path):
    d = str(tmp_path)
    state = _lr_state()
    P.save_round(d, 0, state, (), np.zeros(2, np.uint32))
    P.save_round(d, 1, {k: v + 1 for k, v in state.items()}, (),
                 np.zeros(2, np.uint32))
    p1 = os.path.join(d, "round_000001.npz")
    with open(p1, "r+b") as f:
        f.truncate(os.path.getsize(p1) // 2)
    with pytest.raises(P.TornCheckpoint):
        P.restore_round(d, 1, _port_template(state))
    before = REGISTRY.total("fed_ckpt_torn_total")
    r, got = P.restore_latest(d, _port_template(state))
    assert r == 0
    assert all(torch.equal(got["net"][k], v) for k, v in state.items())
    assert REGISTRY.total("fed_ckpt_torn_total") == before + 1


def test_checkpoint_structure_mismatch_stays_loud(tmp_path):
    d = str(tmp_path)
    state = _lr_state()
    P.save_round(d, 0, state, (), np.zeros(2, np.uint32),
                 extra_state={"dp_rdp": np.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        P.restore_round(d, 0, _port_template(state))
    with pytest.raises(ValueError, match="structure mismatch"):
        P.restore_round(d, 0, _port_template(_tiny_cnn_state()))


def test_checkpoint_leaves_no_bare_tmp(tmp_path):
    d = str(tmp_path)
    P.save_round(d, 0, _lr_state(), (), np.zeros(2, np.uint32),
                 history=[{"round": 0}])
    assert [f for f in os.listdir(d) if f.endswith(".tmp")] == []
    assert json.load(open(os.path.join(d, "history.json"))) == [
        {"round": 0}]
    with P.AsyncCheckpointer(d, keep=2) as ck:
        for r in (1, 2, 3):
            ck.save(r, _lr_state(r), (), np.zeros(2, np.uint32))
    assert P.latest_round(d) == 3
    assert sorted(os.listdir(d)) == ["history.json", "round_000002.npz",
                                     "round_000003.npz"]


# ---------------------------------------------------------- crash battery
def test_rank0_crash_rule_schema_and_ckpt_dir_requirement(setup):
    with pytest.raises(ValueError, match="rounds"):
        FaultRule(fault="crash", ranks=[0])
    with pytest.raises(ValueError, match="after_uploads"):
        FaultRule(fault="drop", after_uploads=2)
    plan = FaultPlan.from_json({"seed": 3, "rules": [
        {"fault": "crash", "ranks": [0], "rounds": [2, 3],
         "after_uploads": 1},
        {"fault": "crash", "ranks": [0], "rounds": [1, 2]},
        {"fault": "crash", "ranks": [3], "rounds": [1, 2]}]})
    assert plan.server_crash_points() == [(1, None), (2, 1)]
    with pytest.raises(ValueError, match="ckpt_dir"):
        run_simulated(setup["data"], setup["task"], FedAvgConfig(**_cfg()),
                      chaos_plan=plan, device="cpu")
    # the mid-reveal point is a schedule the supervision loop accepts; it
    # fires at the masked tier's reveal fan-out
    # (tests/test_torch_secagg_wire.py)
    from fedml_tpu_torch import chaos
    from fedml_tpu_torch.distributed.fedavg.api import server_crash_points

    chaos.install_plan(FaultPlan.from_json(
        {"seed": 1, "rules": _crash_rules(1, -1)}))
    try:
        assert server_crash_points("/nowhere") == [(1, -1)]
    finally:
        chaos.install_plan(None)


@pytest.fixture(scope="module")
def oracles(setup):
    return {"4": _port(setup, "tr-o4"), "5": _port(setup, "tr-o5",
                                                   rounds=5)}


CRASHES = {
    "between_commits": dict(rules=_crash_rules(2), lost=0, epochs=2),
    "mid_round_2": dict(rules=_crash_rules(1, 2), lost=2, epochs=2),
    "mid_round_0": dict(rules=_crash_rules(1, 0), lost=0, epochs=2),
    "double": dict(rules=[*_crash_rules(1), *_crash_rules(3, 1)], lost=1,
                   epochs=3, rounds=5),
}


@pytest.fixture(scope="module")
def jax_crashes(setup, no_orbax, tmp_path_factory):
    """The JAX package's crashed runs (their ckpt_dirs kept for the
    cross-package recovery test)."""
    out = {}
    for name, c in CRASHES.items():
        d = tmp_path_factory.mktemp(f"jax-{name}")
        out[name] = (_jax(setup, f"tr-j-{name}", c["rules"],
                          rounds=c.get("rounds", 4), ckpt_dir=str(d),
                          round_timeout_s=30.0), d)
    return out


@pytest.mark.parametrize("name", list(CRASHES))
def test_crashed_run_matches_uninterrupted_and_jax(setup, oracles,
                                                   jax_crashes, tmp_path,
                                                   name):
    """A rank-0 crash (between commits, mid-round after 2 and after 0
    uploads, two in one campaign): the supervised restart finishes the
    job bitwise the port's uninterrupted run, with exactly the accepted
    uploads the dead server lost ledgered ``server_restart``, and within
    1e-5 of the JAX package's crashed run, ledgers equal. The WAL shows
    every boot and the last commit."""
    c = CRASHES[name]
    rounds = c.get("rounds", 4)
    agg = _port(setup, f"tr-{name}", c["rules"], rounds=rounds,
                ckpt_dir=str(tmp_path), round_timeout_s=30.0)
    oracle = oracles[str(rounds)]
    assert agg.history[-1]["round"] == rounds - 1
    assert _same_bits(agg, oracle)
    assert agg.history == oracle.history
    rest, lost = _split(agg.quarantine.canonical())
    assert rest == oracle.quarantine.canonical()
    assert len(lost) == c["lost"]
    _close_to_jax(agg, jax_crashes[name][0])
    _lost_slots_agree(agg, jax_crashes[name][0])
    rep = _wal(tmp_path)
    assert rep.restart_epochs == c["epochs"]
    assert rep.last_commit == rounds - 1 and rep.torn == 0
    # the counter syncs to the WAL's epoch (a process-wide high-water
    # mark across this process's jobs), the gauge is this boot's epoch
    assert REGISTRY.total("fed_server_restarts_total") >= c["epochs"] - 1
    assert REGISTRY.gauge("fed_restart_epoch").value == c["epochs"] - 1


FAR_DEADLINE_S = 600.0


def _drive_stalls(server, lost_rounds, reporting, dark, stop):
    """One server generation's watchdog, driven (either package): the
    resume backstop once only ``dark`` has not answered the probe, and
    ``on_timeout`` in each of ``lost_rounds`` once every worker index in
    ``reporting`` has uploaded — the states in which the deadlines would
    fire, as nothing else can arrive."""
    while not stop.wait(0.002) and not server._finished.is_set():
        with server._round_lock:
            backstop = (server._resume_round is not None
                        and server._resume_pending == {dark})
            flags = server.aggregator.flag_client_model_uploaded
            stalled = (server._resume_round is None
                       and server.round_idx in lost_rounds
                       and all(flags[i] for i in reporting))
        if backstop:
            server._resume_backstop()
        elif stalled:
            server.on_timeout(FAR_DEADLINE_S)


def _driven(mp, lost_rounds, reporting, dark):
    """Every server generation run while this is in force, of either
    package, has its stalls driven."""
    for cls in (FedAvgServerManager, jax_sm.FedAvgServerManager):
        run = cls.run

        def driven(self, run=run):
            stop = threading.Event()
            t = threading.Thread(target=_drive_stalls, args=(
                self, lost_rounds, reporting, dark, stop))
            t.start()
            try:
                return run(self)
            finally:
                stop.set()
                t.join()

        mp.setattr(cls, "run", driven)


def test_mid_round_crash_with_dead_client_is_exact_elastic_partial(
        setup, tmp_path, no_orbax):
    """The server dies mid-round while client rank 3 is dark (and stays
    undeliverable until its reprobe round): the recovered round folds the
    exact elastic partial over the ranks that answer — bitwise the
    client-crash-only run — with the lost upload ledgered on top, and
    within 1e-5 of the JAX package's same run. The deadlines (the elastic
    rounds and the resume backstop) are driven, not waited out."""
    dark = {"fault": "crash", "ranks": [3], "rounds": [1, 2]}
    rules = [*_crash_rules(1, 1), dark]
    with pytest.MonkeyPatch.context() as mp:
        _driven(mp, lost_rounds={1, 2, 3}, reporting=[0, 1], dark=3)
        oracle = _port(setup, "tr-el-o", [dark],
                       round_timeout_s=FAR_DEADLINE_S)
        agg = _port(setup, "tr-el", rules, round_timeout_s=FAR_DEADLINE_S,
                    ckpt_dir=str(tmp_path))
        jagg = _jax(setup, "tr-el-j", rules, round_timeout_s=FAR_DEADLINE_S,
                    ckpt_dir=str(tmp_path / "j"))
    assert _same_bits(agg, oracle)
    rest, lost = _split(agg.quarantine.canonical())
    assert rest == oracle.quarantine.canonical() and len(lost) == 1
    _close_to_jax(agg, jagg)
    _lost_slots_agree(agg, jagg)


def test_supervised_restart_rebinds_over_grpc(setup, oracles, tmp_path):
    """The dead server's gRPC transport frees rank 0's port as loopback
    frees its registration: the next generation binds it and a mid-round
    crash ends bitwise the uninterrupted run."""
    from test_torch_comm import free_port_block

    agg = _port(setup, "tr-grpc", _crash_rules(1, 2), backend="GRPC",
                base_port=free_port_block(8), ckpt_dir=str(tmp_path),
                round_timeout_s=30.0)
    assert _same_bits(agg, oracles["4"])
    assert len(_split(agg.quarantine.canonical())[1]) == 2
    assert _wal(tmp_path).restart_epochs == 2


def test_supervised_restart_over_mqtt_finishes_every_client(
        setup, oracles, tmp_path, monkeypatch):
    """One supervised restart over MQTT (the bundled broker): the mid-round
    crash ends bitwise the uninterrupted run, and every client receives the
    recovered server's FINISH. The clients get 20 s to finish after the
    server does (the supervisor's own join waits 60 s, what a lost FINISH
    would cost)."""
    import time

    from fedml_tpu_torch.comm.mqtt_mini import MiniMqttBroker
    from fedml_tpu_torch.distributed.fedavg import api

    clients = []
    supervise = api.run_supervised_simulated

    def run(server, cls, points, build):
        clients.extend(cls)
        return supervise(server, cls, points, build, join_timeout=20.0)

    monkeypatch.setattr(api, "run_supervised_simulated", run)
    broker = MiniMqttBroker()
    try:
        t0 = time.monotonic()
        agg = _port(setup, "tr-mqtt", _crash_rules(1, 2), backend="MQTT",
                    broker_port=broker.port, ckpt_dir=str(tmp_path),
                    round_timeout_s=30.0)
        wall = time.monotonic() - t0
    finally:
        broker.close()
    assert all(c._finished.is_set() for c in clients) and len(clients) == 3
    assert wall < 25.0
    assert _same_bits(agg, oracles["4"])
    assert _wal(tmp_path).restart_epochs == 2


def test_recovery_seconds_histogram_observed(setup, tmp_path):
    count = lambda: sum(  # noqa: E731
        v.get("count", 0) for v in REGISTRY.snapshot().get(
            "fed_recovery_seconds", {}).values())
    before = count()
    _port(setup, "tr-rec", _crash_rules(1), rounds=3,
          ckpt_dir=str(tmp_path))
    assert count() == before + 1
    assert REGISTRY.gauge("fed_restart_epoch").value == 1.0


# -------------------------------------------------- cross-package recovery
def _open_round(ckpt, rank=1, client=4):
    """Forge the crash artifact: round 2 opened and one upload accepted,
    never committed."""
    w = RoundWAL(os.path.join(str(ckpt), "wal"))
    w.append("broadcast", sync=True, round=2)
    w.append("upload", sync=True, round=2, rank=rank, client=client,
             nsamp=24.0)
    w.close()


def test_port_server_resumes_a_jax_servers_ckpt_dir(setup, no_orbax,
                                                    tmp_path):
    """The JAX package's 2-round job leaves its npz checkpoints, history,
    ledger and WAL; a crash artifact opens round 2. A port server booted
    there resumes at round 2 with the JAX model's bits, history and
    ledger (plus the lost slot), and finishes the 4-round job within 1e-5
    of the port's uninterrupted run."""
    jagg = _jax(setup, "tr-x-j", rounds=2, ckpt_dir=str(tmp_path))
    _open_round(tmp_path)
    agg = FedAvgAggregator(setup["data"], setup["task"],
                           FedAvgConfig(**_cfg()), worker_num=3,
                           device="cpu")
    kw = backend_kwargs("LOOPBACK", "tr-x-boot", 0, "127.0.0.1", 1)
    srv = FedAvgServerManager(agg, rank=0, size=4, ckpt_dir=str(tmp_path),
                              **kw)
    try:
        assert srv.round_idx == 2 and srv._resume_round == 2
        assert srv._restart_epoch == 1  # the JAX boot was epoch 0
        for a, b in zip(pack_pytree(agg.net), jax_pack(jagg.net)):
            assert a.tobytes() == np.asarray(b).tobytes()
        assert agg.history == jagg.history
        assert agg.quarantine.canonical() == [(2, 1, "server_restart", 4)]
    finally:
        srv.finish()
    done = _port(setup, "tr-x-run", ckpt_dir=str(tmp_path))
    oracle = _port(setup, "tr-x-o")
    for a, b in zip(pack_pytree(done.net), pack_pytree(oracle.net)):
        np.testing.assert_allclose(a, b, **TOL_RUN)
    assert [h["round"] for h in done.history] == [0, 1, 2, 3]


def test_jax_server_resumes_a_port_servers_ckpt_dir(setup, no_orbax,
                                                    tmp_path):
    agg = _port(setup, "tr-y-p", rounds=2, ckpt_dir=str(tmp_path))
    _open_round(tmp_path, rank=2, client=6)
    jagg = jax_api.FedAvgAggregator(setup["jdata"], setup["jtask"],
                                    JaxConfig(**_cfg()), worker_num=3)
    kw = jax_backend_kwargs("LOOPBACK", "tr-y-boot", 0, "127.0.0.1", 1)
    srv = jax_sm.FedAvgServerManager(jagg, rank=0, size=4,
                                     ckpt_dir=str(tmp_path), **kw)
    try:
        assert srv.round_idx == 2 and srv._resume_round == 2
        for a, b in zip(pack_pytree(agg.net), jax_pack(jagg.net)):
            assert a.tobytes() == np.asarray(b).tobytes()
        assert jagg.history == agg.history
        assert jagg.quarantine.canonical() == [(2, 2, "server_restart", 6)]
    finally:
        srv.com_manager.stop_receive_message()
        srv.wal.close()


def test_dp_wal_resume_raises_naming_its_item(setup, tmp_path):
    """A DP run's WAL (an open round with its pre-charge, no checkpoint
    yet) no longer raises: the DP aggregator's accountant is re-charged
    for the pre-charge past the (absent) commit and the open round re-runs
    behind the resume probe; a plain aggregator, which has no accountant,
    ignores the record, as the reference's does."""
    from fedml_tpu_torch.core.privacy import DPAccountant
    from fedml_tpu_torch.distributed.fedavg_robust import (
        FedAvgRobustAggregator,
    )

    w = RoundWAL(os.path.join(str(tmp_path), "wal"))
    w.append("broadcast", sync=True, round=0)
    w.append("precharge", sync=True, round=0, q=0.375, z=1.0)
    w.close()
    for i, agg in enumerate((
            FedAvgRobustAggregator(setup["data"], setup["task"],
                                   FedAvgConfig(**_cfg()), worker_num=3,
                                   defense_type="dp", device="cpu"),
            FedAvgAggregator(setup["data"], setup["task"],
                             FedAvgConfig(**_cfg()), worker_num=3,
                             device="cpu"))):
        srv = FedAvgServerManager(agg, rank=0, size=4,
                                  ckpt_dir=str(tmp_path),
                                  **backend_kwargs("LOOPBACK", f"tr-dp{i}",
                                                   0, "127.0.0.1", 1))
        try:
            assert srv._resume_round == 0
            if i == 0:
                assert agg.epsilon() == DPAccountant().step(
                    0.375, 1.0).epsilon(1e-5)
        finally:
            srv.com_manager.stop_receive_message()
            srv.wal.close()


# --------------------------------------------------------- resume protocol
def test_resume_frames_are_byte_equal_to_the_jax_packages():
    frames = []
    for cls in (Message, JaxMessage):
        probe = cls(MyMessage.MSG_TYPE_S2C_RESUME_PROBE, 0, 2)
        probe.add_params(MyMessage.MSG_ARG_KEY_ROUND, 3)
        probe.add_params(MyMessage.MSG_ARG_KEY_RESTART_EPOCH, 1)
        ack = cls(MyMessage.MSG_TYPE_C2S_RESUME_ACK, 2, 0)
        ack.add_params(MyMessage.MSG_ARG_KEY_LAST_SEEN_ROUND, 3)
        ack.add_params(MyMessage.MSG_ARG_KEY_LAST_SEEN_WAVE, 5)
        ack.add_params(MyMessage.MSG_ARG_KEY_RESTART_EPOCH, 1)
        frames.append((probe.to_bytes(), ack.to_bytes()))
    assert frames[0] == frames[1]


def _client(setup, job, rank=2, size=4):
    trainer = DistributedTrainer(rank, setup["data"], setup["task"],
                                 FedAvgConfig(**_cfg()), device="cpu")
    return FedAvgClientManager(trainer, rank=rank, size=size,
                               **backend_kwargs("LOOPBACK", job, 0,
                                                "127.0.0.1", 1))


def test_client_answers_the_probe_with_its_last_round_and_wave(setup):
    """A client adopts the probe's epoch, answers the probe's sender with
    its last round and wave (the frame the JAX client sends), and echoes
    the epoch, the wave and the client index on its next upload."""
    cm = _client(setup, "tr-probe")
    sent = []
    cm.send_message = sent.append
    cm._send_upload = sent.append
    try:
        cm.round_idx, cm._last_wave = 3, 5
        cm.handle_message_resume_probe({
            "sender": 0, MyMessage.MSG_ARG_KEY_ROUND: 3,
            MyMessage.MSG_ARG_KEY_RESTART_EPOCH: 2})
        ack = sent[-1]
        assert ack.get_type() == MyMessage.MSG_TYPE_C2S_RESUME_ACK
        assert ack.get_receiver_id() == 0
        assert (ack.get(MyMessage.MSG_ARG_KEY_LAST_SEEN_ROUND),
                ack.get(MyMessage.MSG_ARG_KEY_LAST_SEEN_WAVE),
                ack.get(MyMessage.MSG_ARG_KEY_RESTART_EPOCH)) == (3, 5, 2)
        cm.handle_message_receive_model({
            MyMessage.MSG_ARG_KEY_MODEL_PARAMS: cm.trainer.wire_leaves(),
            MyMessage.MSG_ARG_KEY_CLIENT_INDEX: 6,
            MyMessage.MSG_ARG_KEY_ROUND: 4,
            MyMessage.MSG_ARG_KEY_DISPATCH_WAVE: 9})
        up = sent[-1]
        assert (up.get(MyMessage.MSG_ARG_KEY_RESTART_EPOCH),
                up.get(MyMessage.MSG_ARG_KEY_DISPATCH_WAVE),
                up.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX)) == (2, 9, 6)
        assert cm._last_wave == 9
    finally:
        cm.finish()


def test_pre_crash_upload_dies_at_the_epoch_gate(setup, tmp_path):
    """An upload echoing an older restart epoch is dropped, counted on
    ``comm_stale_uploads_total{reason=server_restart}`` and never
    ledgered or slotted."""
    _port(setup, "tr-gate-1", rounds=1, ckpt_dir=str(tmp_path))
    agg = FedAvgAggregator(setup["data"], setup["task"],
                           FedAvgConfig(**_cfg()), worker_num=3,
                           device="cpu")
    srv = FedAvgServerManager(agg, rank=0, size=4, ckpt_dir=str(tmp_path),
                              **backend_kwargs("LOOPBACK", "tr-gate", 0,
                                               "127.0.0.1", 1))
    try:
        assert srv._restart_epoch == 1 and srv.round_idx == 1
        key = "comm_stale_uploads_total"
        before = REGISTRY.snapshot().get(key, {}).get(
            "reason=server_restart", 0.0)
        srv.handle_message_receive_model_from_client({
            "sender": 1, MyMessage.MSG_ARG_KEY_ROUND: 1,
            MyMessage.MSG_ARG_KEY_NUM_SAMPLES: 24,
            MyMessage.MSG_ARG_KEY_MODEL_PARAMS: agg.get_global_model_params()})
        after = REGISTRY.snapshot()[key]["reason=server_restart"]
        assert after == before + 1
        assert len(agg.quarantine) == 0 and not agg.model_dict
        assert not any(agg.flag_client_model_uploaded.values())
    finally:
        srv.finish()


# ------------------------------------------------------------------- tree
TREE_CRASHES = {"between_commits": _crash_rules(2),
                "mid_round": _crash_rules(1, 1)}


@pytest.mark.parametrize("name", list(TREE_CRASHES))
def test_tree_root_crash_matches_uninterrupted_tree(setup, tmp_path,
                                                    no_orbax, name):
    """Under ``edges=2`` with 4 workers a root crash (between commits, or
    after one edge partial) recovers bitwise the uninterrupted tree, every
    edge answers the probe, and the ledger is the JAX tree's."""
    from fedml_tpu_torch.distributed.fedavg import hierarchy

    acks = []
    handle = FedAvgServerManager.handle_message_resume_ack

    def recording(self, msg_params):
        acks.append(int(msg_params["sender"]))
        return handle(self, msg_params)

    oracle = _port(setup, f"tr-t-o-{name}", per_round=4, edges=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hierarchy.HierFedAvgServerManager,
                   "handle_message_resume_ack", recording)
        agg = _port(setup, f"tr-t-{name}", TREE_CRASHES[name], per_round=4,
                    edges=2, ckpt_dir=str(tmp_path), round_timeout_s=30.0)
    assert _same_bits(agg, oracle)
    rest, lost = _split(agg.quarantine.canonical())
    assert rest == oracle.quarantine.canonical()
    assert len(lost) == (1 if name == "mid_round" else 0)
    assert all(e[1] in (1, 2) and e[3] is None for e in lost)  # edge ranks
    if name == "mid_round":
        assert {1, 2} <= set(acks)  # both edges answered the probe
    assert _wal(tmp_path).restart_epochs == 2
    jagg = _jax(setup, f"tr-t-j-{name}", TREE_CRASHES[name], per_round=4,
                edges=2, ckpt_dir=str(tmp_path / "j"), round_timeout_s=30.0)
    _close_to_jax(agg, jagg)
    assert _split(agg.quarantine.canonical())[0] == \
        _split(jagg.quarantine.canonical())[0]
    assert len(_split(jagg.quarantine.canonical())[1]) == len(lost)


# --------------------------------------------------------------- launcher
def test_launcher_routes_the_recovery_and_async_flags(setup, monkeypatch):
    """The seven flags parse and reach the server manager's constructor
    through ``init_role``; ``--supervise`` without ``--ckpt_dir`` raises."""
    seen = {}

    def fake_server(*a, **kw):
        seen.update(kw)
        return "server"

    from fedml_tpu_torch.distributed.fedavg import api

    monkeypatch.setattr(api, "init_server", fake_server)
    argv = ["--rank", "0", "--world_size", "4", "--device", "cpu",
            "--ckpt_dir", "/ck", "--async_buffer_k", "2",
            "--staleness", "poly:0.5", "--staleness_bound", "1",
            "--buffer_deadline_s", "0.5", "--heartbeat_max_age_s", "0.25",
            "--supervise", "2"]
    args = distributed_launch.add_args(
        __import__("argparse").ArgumentParser()).parse_args(argv)
    assert args.supervise == 2
    assert distributed_launch.init_role(
        args, setup["data"], setup["task"], FedAvgConfig(**_cfg()),
        {"timeout_s": None}, device="cpu") == "server"
    assert (seen["ckpt_dir"], seen["async_buffer_k"], seen["staleness"],
            seen["staleness_bound"], seen["buffer_deadline_s"],
            seen["heartbeat_max_age_s"]) == ("/ck", 2, "poly:0.5", 1, 0.5,
                                             0.25)
    with pytest.raises(ValueError, match="--supervise needs --ckpt_dir"):
        distributed_launch.main(["--rank", "0", "--world_size", "4",
                                 "--device", "cpu", "--supervise", "1"])
