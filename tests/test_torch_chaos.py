"""The port's chaos layer (fedml_tpu_torch/chaos) against the JAX
package's: the modules are copies (adversary.py up to its in-graph half),
the sha256 draw streams (fault decisions, churn availability, adversary
noise) replay bitwise, ``make_comm_manager`` wraps a manager only while a
plan is installed, and a seeded plan over a loopback job gives the fault
ledger the JAX package's run of it gives — per uplink tier, and with frames
lost (elastic rounds). Mirrors tests/test_chaos.py, tests/test_churn.py and
test_wire_codecs.py's chaos replay. Every lossy run's round deadline is
5 s, well above a round here."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import chaos as jax_chaos
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.comm.message import pack_pytree as jax_pack
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.distributed.fedavg import api as jax_api
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import chaos, convert
from fedml_tpu_torch.algorithms import FedAvgConfig
from fedml_tpu_torch.comm.loopback import LoopbackCommManager
from fedml_tpu_torch.comm.managers import make_comm_manager
from fedml_tpu_torch.comm.message import pack_pytree
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import run_simulated
from fedml_tpu_torch.models import create_model

ROOT = Path(__file__).resolve().parents[1]
DATA_KW = dict(num_clients=8, image_shape=(8, 8, 1), num_classes=4,
               samples_per_client=24, test_samples=96, seed=3)
CFG = dict(comm_round=3, client_num_in_total=8, client_num_per_round=4,
           epochs=1, batch_size=8, lr=0.1, frequency_of_the_test=1, seed=0)
LOSSY_TIMEOUT_S = 5.0


def copy_of(path: str) -> str:
    return re.sub(r"\bfedml_tpu\b", "fedml_tpu_torch",
                  (ROOT / "fedml_tpu" / path).read_text())


@pytest.mark.parametrize("path", ["chaos/plan.py", "chaos/inject.py",
                                  "chaos/churn.py", "chaos/__init__.py"])
def test_copied_modules_match_the_reference(path):
    assert (ROOT / "fedml_tpu_torch" / path).read_text() == copy_of(path)


def test_adversary_host_half_is_the_reference_and_in_graph_refuses():
    """adversary.py is the reference's up to its in-graph injector, which
    the port rewrites in torch (held to the JAX injector by
    tests/test_torch_robust_agg.py): it no longer refuses, and an empty
    plan leaves the stack as it was."""
    cut = "# --------------------------------------------------------------- in-graph"
    ref = copy_of("chaos/adversary.py")
    port = (ROOT / "fedml_tpu_torch/chaos/adversary.py").read_text()
    assert port[:port.index(cut)] == ref[:ref.index(cut)]
    inject = chaos.adversary.make_in_graph_injector(chaos.AdversaryPlan(), 4)
    st = {"w": torch.randn(4, 3)}
    assert torch.equal(inject(st, {"w": torch.zeros(3)}, 0)["w"], st["w"])


def test_fault_decisions_bitwise_equal_to_jax():
    spec = {"seed": 7, "rules": [
        {"fault": "corrupt", "direction": "recv", "prob": 0.5},
        {"fault": "drop", "direction": "send", "prob": 0.3},
        {"fault": "duplicate", "direction": "send", "prob": 0.9}]}
    port, ref = chaos.FaultPlan.from_json(spec), \
        jax_chaos.FaultPlan.from_json(spec)
    assert port.to_json() == ref.to_json()
    got, want = [], []
    for rule in range(3):
        for direction in ("send", "recv"):
            for src, dst in ((0, 1), (2, 0), (None, 3)):
                for seq in range(40):
                    got.append(port.fires(rule, direction, src, dst, seq))
                    want.append(ref.fires(rule, direction, src, dst, seq))
    assert got == want and 0 < sum(got) < len(got)
    frame = bytes(range(256)) * 4
    for seq in range(20):
        assert chaos.inject.corrupt_bytes(frame, 7, seq) == \
            jax_chaos.inject.corrupt_bytes(frame, 7, seq)


def test_churn_trace_bitwise_equal_to_jax():
    spec = {"seed": 11, "base": 0.55, "amplitude": 0.45, "period": 6,
            "tz_spread": 0.5, "arrival_spread": 2, "departure_rate": 0.01,
            "rank_base": 0.7, "rank_amplitude": 0.2,
            "device_classes": [{"name": "phone", "weight": 3.0,
                                "size_scale": 0.5},
                               {"name": "tablet", "weight": 1.0}]}
    port, ref = chaos.ChurnTrace.from_json(spec), \
        jax_chaos.ChurnTrace.from_json(spec)
    assert port.to_json() == ref.to_json()
    assert port.availability_timeline(24, 64) == \
        ref.availability_timeline(24, 64)
    for w in range(12):
        np.testing.assert_array_equal(port.available_clients(w, 64),
                                      ref.available_clients(w, 64))
        assert port.scheduled_offline_ranks(w, 9) == \
            ref.scheduled_offline_ranks(w, 9)
    np.testing.assert_array_equal(port.skewed_sizes(np.arange(1, 65)),
                                  ref.skewed_sizes(np.arange(1, 65)))


@pytest.mark.parametrize("attack", ["sign_flip", "scale", "gaussian", "nan",
                                    "shift"])
def test_perturb_leaves_bitwise_equal_to_jax(attack):
    spec = {"seed": 3, "rules": [{"attack": attack, "ranks": [2],
                                  "rounds": [1, 3]}]}
    rs = np.random.RandomState(0)
    leaves = [rs.randn(6, 5).astype(np.float32), np.arange(4, dtype=np.int32)]
    glob = [rs.randn(6, 5).astype(np.float32), np.zeros(4, np.int32)]
    for rank, rnd in ((2, 1), (2, 2), (1, 1), (2, 3)):
        got = chaos.adversary.perturb_leaves(
            chaos.AdversaryPlan.from_json(spec), leaves, glob, rank, rnd)
        want = jax_chaos.adversary.perturb_leaves(
            jax_chaos.AdversaryPlan.from_json(spec), leaves, glob, rank, rnd)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_make_comm_manager_wraps_only_with_a_plan():
    bare = make_comm_manager("LOOPBACK", 1, 2, job_id="t-torch-wrap-a")
    assert isinstance(bare, LoopbackCommManager)
    bare.stop_receive_message()
    with chaos.installed(chaos.FaultPlan(seed=1)) as plan:
        assert chaos.active_plan() is plan
        wrapped = make_comm_manager("LOOPBACK", 1, 2, job_id="t-torch-wrap-b")
        assert isinstance(wrapped, chaos.ChaosCommManager)
        wrapped.stop_receive_message()
    assert chaos.active_plan() is None


# ------------------------------------------------------- runs under a plan
@pytest.fixture(scope="module")
def setup():
    jdata = jax_synthetic_images(**DATA_KW)
    jtask = jax_classification_task(JaxLR(num_classes=4))
    _, key = jax.random.split(jax.random.PRNGKey(CFG["seed"]))
    params = jax.tree.map(np.asarray, jtask.init(
        key, jnp.asarray(jdata.train_x[:CFG["batch_size"]])).params)
    state = convert.from_flax(params)
    task = classification_task(create_model("lr", output_dim=4, device="cpu"))
    task = task._replace(init=lambda g, x=None: {k: v.clone()
                                                 for k, v in state.items()})
    return dict(data=synthetic_images(**DATA_KW), jdata=jdata, jtask=jtask,
                task=task)


def _runs(setup, spec, job, cfg=CFG, **kw):
    """The plan over the port's loopback job twice and the JAX package's
    once: [(fault ledger, quarantine ledger, final wire leaves,
    aggregator)] for port, port, JAX."""
    out = []
    for i in range(2):
        plan = chaos.FaultPlan.from_json(spec)
        agg = run_simulated(setup["data"], setup["task"], FedAvgConfig(**cfg),
                            job_id=f"t-torch-{job}-{i}", chaos_plan=plan,
                            device="cpu", **kw)
        out.append((plan.ledger.canonical(), agg.quarantine.canonical(),
                    pack_pytree(agg.net), agg))
    plan = jax_chaos.FaultPlan.from_json(spec)
    agg = jax_api.run_simulated(setup["jdata"], setup["jtask"],
                                JaxConfig(**cfg), job_id=f"t-jax-{job}",
                                chaos_plan=plan, **kw)
    out.append((plan.ledger.canonical(), agg.quarantine.canonical(),
                [np.asarray(v) for v in jax_pack(agg.net)], agg))
    return out


# no frame lost: sha256-drawn duplicates, delays and reorders on both links
NO_LOSS = {"seed": 7, "rules": [
    {"fault": "duplicate", "direction": "send", "src": [3], "dst": [0],
     "prob": 0.6},
    {"fault": "delay", "direction": "send", "src": [0], "dst": [2],
     "prob": 0.5, "delay_s": 0.05},
    {"fault": "reorder", "direction": "recv", "src": [0], "dst": [4],
     "prob": 0.5},
    {"fault": "duplicate", "direction": "recv", "src": [1], "dst": [0]}]}


@pytest.mark.parametrize("tier_kw", [
    {}, {"update_codec": "delta"}, {"update_codec": "delta-int8"},
    {"update_codec": "delta-sign1"}, {"sparsify_ratio": 0.3},
], ids=["dense", "delta", "delta-int8", "delta-sign1", "topk"])
def test_plan_replays_per_tier_like_jax(setup, tier_kw):
    """Every uplink tier under duplicates, delays and reorders: the port
    replays its fault ledger and final model bitwise, and the ledger is
    the JAX package's for the same plan; a duplicated upload is folded
    once (four distinct slots a round), and the model stays within
    test_torch_wire_codecs' tier tolerance of the JAX run's."""
    (l0, q0, p0, a0), (l1, q1, p1, _), (lj, qj, pj, _) = _runs(
        setup, NO_LOSS, "noloss-" + "-".join(map(str, tier_kw.values())),
        **tier_kw)
    assert l0 == l1 == lj and len(l0) > 0
    assert q0 == q1 == qj == []
    for a, b in zip(p0, p1):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(p0, pj):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-3)
    assert a0._last_flush["stack_bytes"] == 4 * a0._model_nbytes
    assert [r["round"] for r in a0.history] == [0, 1, 2]


def _upload_lost(plan, rank: int, round_idx: int) -> bool:
    """Rank's upload of the round can no longer arrive: dropped on its
    send, or corrupted on the server's receive (the CRC drops it)."""
    return any(e["src"] == rank and e["dst"] == 0
               and (e["fault"], e["direction"]) in (("drop", "send"),
                                                    ("corrupt", "recv"))
               for e in plan.ledger.for_round(round_idx, ("drop", "corrupt")))


def _drive_deadline(server, plan_of, stop):
    """Fire the server's deadline as soon as every upload that can still
    arrive this round has, as the watchdog would after its idle wait."""
    while not stop.wait(0.002) and not server._finished.is_set():
        plan = plan_of()
        if plan is None:
            continue
        with server._round_lock:
            r = server.round_idx
            flags = server.aggregator.flag_client_model_uploaded
            missing = [i + 1 for i, up in flags.items() if not up]
            fire = (r < server.round_num and missing
                    and all(_upload_lost(plan, k, r) for k in missing))
        if fire:
            server.on_timeout(LOSSY_TIMEOUT_S)


@pytest.fixture
def driven_deadlines(monkeypatch):
    """Every FedAvg server of either package run while this is in force has
    its lossy rounds' deadline driven (``_drive_deadline``): the test does
    not wait it out."""
    import threading

    from fedml_tpu.distributed.fedavg import server_manager as jax_sm
    from fedml_tpu_torch.distributed.fedavg import server_manager as port_sm

    for mod, pkg in ((port_sm, chaos), (jax_sm, jax_chaos)):
        cls = mod.FedAvgServerManager
        run = cls.run

        def driven(self, run=run, pkg=pkg):
            stop = threading.Event()
            t = threading.Thread(target=_drive_deadline, daemon=True,
                                 args=(self, pkg.active_plan, stop))
            t.start()
            try:
                return run(self)
            finally:
                stop.set()
                t.join()

        monkeypatch.setattr(cls, "run", driven)


def test_lossy_plan_gives_the_jax_ledgers(setup, driven_deadlines):
    """Round 1 loses rank 2's upload (dropped) and rank 1's (corrupted on
    arrival: the CRC drops it, counted, never decoded) on delta-int8:
    the round aggregates the two others at the deadline (driven as soon
    as no upload can still arrive). Fault and quarantine ledgers equal
    across the port's two runs and the JAX package's; the final models
    equal within the tier tolerance."""
    spec = {"seed": 5, "rules": [
        {"fault": "drop", "direction": "send", "src": [2], "dst": [0],
         "rounds": [1, 2]},
        {"fault": "corrupt", "direction": "recv", "src": [1], "dst": [0],
         "rounds": [1, 2]},
        {"fault": "duplicate", "direction": "send", "src": [3], "dst": [0],
         "rounds": [0, 1]}]}
    cfg = dict(CFG, comm_round=2)
    (l0, q0, p0, a0), (l1, q1, p1, _), (lj, qj, pj, aj) = _runs(
        setup, spec, "lossy", cfg=cfg, update_codec="delta-int8",
        round_timeout_s=LOSSY_TIMEOUT_S)
    assert l0 == l1 == lj
    assert {e[0] for e in l0} == {"drop", "corrupt", "duplicate"}
    assert q0 == q1 == qj
    for a, b in zip(p0, pj):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-3)
    assert [r["round"] for r in a0.history] == [0, 1] == \
        [r["round"] for r in aj.history]
    assert a0._last_flush["stack_bytes"] == 2 * a0._model_nbytes
