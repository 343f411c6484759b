"""The hierarchical masked tier in the port (distributed/turboaggregate.py
``run_simulated(edges=E)``: edge-local reveal recovery, one unmasked field
partial an edge, one decode at the root) and the launcher's
``--algo turboaggregate``, on tests/test_hierarchy_secagg.py's tiny
configuration (8 workers, 2 edges).

Held: tree ≡ flat bitwise inside the port (model and ledger), clean and
with an in-block dropout, root fan-in E frames
a round; the tree's ledger the JAX package's tree's under the same crash
plan and its model within 1e-5; a lost edge shedding exactly its block,
replayed bitwise; the round records' hier and secagg blocks; the
launcher's refusal matrix (the reference's flags, in its order), its
lifted compositions (--fused_agg, --edges) and a loopback launcher job
equal to run_simulated. Every deadline is driven
(test_torch_secure_agg.drive_stalls).
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from contextlib import redirect_stdout

import pytest
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.chaos import FaultPlan as JaxFaultPlan
from fedml_tpu.distributed import turboaggregate as jta
from fedml_tpu_torch.algorithms import FedAvgConfig
from fedml_tpu_torch.chaos import FaultPlan
from fedml_tpu_torch.comm import loopback
from fedml_tpu_torch.distributed import turboaggregate as ta
from fedml_tpu_torch.experiments import distributed_launch
from fedml_tpu_torch.obs.metrics import REGISTRY
from test_torch_secure_agg import (
    FAR_DEADLINE_S,
    cfg_kw,
    drive_stalls,
    leaves_close,
    same_bits,
    secagg_setup,
)

# cohort slot 1 dark in round 1: flat wire rank 2, tree wire rank 4
# (worker ranks follow the two edge ranks)
FLAT_DROP = {"seed": 7, "rules": [
    {"fault": "crash", "ranks": [2], "rounds": [1, 2]}]}
TREE_DROP = {"seed": 7, "rules": [
    {"fault": "crash", "ranks": [4], "rounds": [1, 2]}]}
# edge rank 1 (block 0: slots 0-3) dark in round 1
EDGE_CRASH = {"seed": 9, "rules": [
    {"fault": "crash", "ranks": [1], "rounds": [1, 2]}]}


@pytest.fixture(scope="module")
def setup():
    return secagg_setup()


@pytest.fixture
def driven(monkeypatch):
    drive_stalls(monkeypatch)


def _run(s, job, rounds=2, chaos=None, **kw):
    return ta.run_simulated(
        s["data"], s["task"], FedAvgConfig(**cfg_kw(rounds, 8)),
        job_id=job, device="cpu",
        chaos_plan=None if chaos is None else FaultPlan.from_json(chaos),
        **kw)


@pytest.fixture(scope="module")
def jax_tree_drop(setup):
    with pytest.MonkeyPatch.context() as mp:
        drive_stalls(mp)
        return jta.run_simulated(
            setup["jdata"], setup["jtask"], JaxConfig(**cfg_kw(2, 8)),
            job_id="tt-j-drop", edges=2,
            chaos_plan=JaxFaultPlan.from_json(TREE_DROP),
            round_timeout_s=FAR_DEADLINE_S)


@pytest.fixture(scope="module")
def flat_drop(setup):
    """The flat run with slot 1 dark in round 1 (driven)."""
    with pytest.MonkeyPatch.context() as mp:
        drive_stalls(mp)
        return _run(setup, "tt-drop-flat", chaos=FLAT_DROP,
                    round_timeout_s=FAR_DEADLINE_S)


def test_tree_matches_flat_bitwise_clean(setup):
    """Tree ≡ flat on a clean run — model bits, ledger, history; root
    ingress E frames a round; the round records carry the hier and secagg
    blocks."""
    from fedml_tpu_torch.obs import Telemetry

    flat = _run(setup, "tt-flat")
    tel = Telemetry()
    tree = _run(setup, "tt-tree", edges=2, telemetry=tel)
    tel.close()
    assert same_bits(flat.net, tree.net)
    assert tree.quarantine.canonical() == flat.quarantine.canonical() == []
    assert tree.fanin_history == [2, 2]
    assert tree.history == flat.history
    recs = [r for r in tel.events.sink.records if r.get("kind") == "round"]
    assert len(recs) == 2
    for r in recs:
        assert r["hier"] == {"edges": 2, "block": 4, "fan_in": 2}
        assert r["secagg"]["outcome"] == "full"


def test_tree_matches_flat_bitwise_with_inblock_dropout(setup,
                                                         jax_tree_drop,
                                                         flat_drop, driven):
    """Slot 1 dark in round 1: the flat run recovers through the root's
    reveal, the tree through the edge's — model bits and ledger equal;
    the ledger is the JAX package's tree's under the same plan, the model
    within 1e-5 of it; fan-in stays E through recovery."""
    before = REGISTRY.snapshot().get("fed_secagg_rounds_total", {})
    flat = flat_drop
    tree = _run(setup, "tt-drop-tree", chaos=TREE_DROP,
                round_timeout_s=FAR_DEADLINE_S, edges=2)
    assert same_bits(flat.net, tree.net)
    led = tree.quarantine.canonical()
    assert led == flat.quarantine.canonical()
    assert led == jax_tree_drop.quarantine.canonical()
    drops = [e for e in led if e[2] == "secagg_dropout"]
    assert [(e[0], e[1]) for e in drops] == [(1, 2)]
    leaves_close(tree.net, jax_tree_drop.net.params)
    after = REGISTRY.snapshot().get("fed_secagg_rounds_total", {})
    assert after.get("outcome=recovered", 0) >= \
        before.get("outcome=recovered", 0) + 1
    assert tree.fanin_history == [2, 2]


def test_edge_crash_sheds_exactly_its_block_and_replays(setup, driven):
    """A whole edge lost: the root sheds exactly its block's slots
    (secagg_shed, client-attributed), the other block's partial folds,
    and the schedule replays bitwise."""
    before = float(REGISTRY.snapshot().get("fed_secagg_rounds_total", {})
                   .get("outcome=shed", 0.0))
    tree = _run(setup, "tt-edgecrash", rounds=3, chaos=EDGE_CRASH,
                round_timeout_s=FAR_DEADLINE_S, edges=2)
    led = tree.quarantine.canonical()
    sheds = [e for e in led if e[2] == "secagg_shed"]
    assert {e[1] for e in sheds} == {1, 2, 3, 4}, led
    assert 1 in {e[0] for e in sheds} and not [e for e in led if e[1] > 4]
    after = float(REGISTRY.snapshot().get("fed_secagg_rounds_total", {})
                  .get("outcome=shed", 0.0))
    assert after > before
    assert tree.history[-1]["round"] == 2 and 1 in tree.fanin_history
    again = _run(setup, "tt-edgecrash-replay", rounds=3, chaos=EDGE_CRASH,
                 round_timeout_s=FAR_DEADLINE_S, edges=2)
    assert again.quarantine.canonical() == led
    assert same_bits(tree.net, again.net)


@pytest.mark.parametrize("lost", [1, 2])
def test_edge_reveal_retry_heals_a_lost_reply_or_sheds_the_block(
        setup, flat_drop, driven, monkeypatch, lost):
    """Slot 1 dark in round 1; slot 2's reveal reply to its edge is lost
    ``lost`` times. The edge's first deadline re-sends the request (the
    client's cache answers verbatim): one loss heals and the tree ends
    bitwise the flat crash-only run. The second deadline sheds the block:
    its four slots are ledgered secagg_shed at the root while the other
    block's partial folds."""
    from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage

    asked, dropped, edges = {}, {}, []
    request = ta.TASecureEdgeManager._send_block_reveals

    def counted(self, survivors, dead):
        if self not in edges:
            edges.append(self)
        for slot in survivors:
            asked[slot] = asked.get(slot, 0) + 1
        return request(self, survivors, dead)

    send = ta.TASecureClientManager.send_message

    def lossy(self, msg):
        if (self.trainer.slot == 2 and dropped.get(2, 0) < lost
                and msg.get_type() == MyMessage.MSG_TYPE_C2S_REVEAL_SHARES):
            dropped[2] = dropped.get(2, 0) + 1
            return
        return send(self, msg)

    monkeypatch.setattr(ta.TASecureEdgeManager, "_send_block_reveals",
                        counted)
    monkeypatch.setattr(ta.TASecureClientManager, "send_message", lossy)
    stop = threading.Event()

    def drive_reveals():
        # the edge's reveal deadline: every reply that can still land has
        while not stop.wait(0.002):
            for e in edges:
                with e._lock:
                    rv = e._mreveal
                    fire = (rv is not None and not e._forwarded
                            and set(rv["seeds"]) == set(rv["survivors"])
                            - {2} and dropped.get(2, 0) >= asked.get(2, 0))
                if fire:
                    e.on_timeout(FAR_DEADLINE_S)

    t = threading.Thread(target=drive_reveals, daemon=True)
    t.start()
    try:
        tree = _run(setup, f"tt-rr-{lost}", chaos=TREE_DROP,
                    round_timeout_s=FAR_DEADLINE_S, edges=2)
    finally:
        stop.set()
        t.join(timeout=10)
    assert dropped[2] == lost and asked[2] == 2
    led = [(e[0], e[1], e[2]) for e in tree.quarantine.canonical()]
    if lost == 1:
        assert led == [(1, 2, "secagg_dropout")]
        assert same_bits(tree.net, flat_drop.net)
    else:
        assert led == [(1, r, "secagg_shed") for r in (1, 2, 3, 4)], led
    assert tree.fanin_history == [2, 2]


def test_tree_refuses_a_block_below_the_recovery_threshold(setup):
    topo = ta.EdgeTopology(edges=4, workers=8)  # 2-slot blocks, t+1 = 3
    with pytest.raises(ValueError, match="edge block holds only 2"):
        ta.HierTAAggregator(setup["data"], setup["task"],
                            FedAvgConfig(**cfg_kw(2, 8)), topo, device="cpu")
    with pytest.raises(ValueError, match="edge block holds only 2"):
        ta.TASecureEdgeManager(1, topo, FedAvgConfig(**cfg_kw(2, 8)),
                               device="cpu", job_id="tt-small-block")


# ------------------------------------------------------------- launcher
def _args(rank, *flags):
    return distributed_launch.add_args(argparse.ArgumentParser()).parse_args(
        ["--rank", str(rank), "--algo", "turboaggregate", *flags])


@pytest.mark.parametrize("flags", [
    ["--shard_server_state", "1"],
    ["--async_buffer_k", "2"],
    ["--update_codec", "delta-int8"],
    ["--sparsify_ratio", "0.1"],
    ["--aggregator", "median"],
    ["--byzantine_f", "1"],
    ["--delta_broadcast", "1"],
    ["--heartbeat_max_age_s", "5"],
    ["--sum_assoc", "pairwise"],
    ["--adversary_plan", '{"seed": 1, "rules": []}'],
], ids=lambda f: f[0])
def test_launcher_turboaggregate_refusal_matrix(flags):
    """Every unsupported composition refuses loudly, on server and client
    ranks alike, in init_role and in main (before any flag the port
    itself has not ported)."""
    for rank in ("0", "1"):
        with pytest.raises(ValueError, match="does not compose"):
            distributed_launch.init_role(
                _args(rank, "--world_size", "4", *flags), None, None, None,
                {})
        with pytest.raises(ValueError, match="does not compose"):
            distributed_launch.main(["--rank", rank, "--world_size", "4",
                                     "--algo", "turboaggregate",
                                     "--device", "cpu", *flags])


def test_launcher_turboaggregate_lifted_compositions(setup):
    """--fused_agg is accepted on the masked tier (its fold is always on
    the device), and off it runs the dense tier's fused ingest (item 7,
    tests/test_torch_fused_agg.py), so its refusal case pairs it with a
    flag still refused (sharded state, item 12); --edges builds the
    masked tree on every rank class; --defense_type dp the masked DP
    path."""
    cfg = FedAvgConfig(**cfg_kw(2, 3))

    def role(rank, *flags, c=cfg):
        return distributed_launch.init_role(
            _args(rank, "--backend", "loopback", *flags), setup["data"],
            setup["task"], c, {"job_id": f"tt-lift-{rank}-{len(flags)}"},
            device="cpu")

    srv = role(0, "--world_size", "4", "--fused_agg", "1",
               "--defense_type", "dp", "--norm_bound", "0.5")
    try:
        assert isinstance(srv, ta.TASecureServerManager)
        assert srv.aggregator.defense_type == "dp"
        assert srv.aggregator.secagg.max_abs == 0.5
    finally:
        srv.finish()
    with pytest.raises(NotImplementedError, match="item 12"):
        distributed_launch.main(["--rank", "0", "--world_size", "4",
                                 "--device", "cpu", "--fused_agg", "1",
                                 "--shard_server_state", "1"])
    tree_cfg = FedAvgConfig(**cfg_kw(2, 4))
    argv = ("--world_size", "7", "--edges", "2", "--secagg_threshold_t", "1")
    for rank, klass in ((0, ta.HierTASecureServerManager),
                        (1, ta.TASecureEdgeManager),
                        (3, ta.TASecureClientManager)):
        mgr = role(rank, *argv, c=tree_cfg)
        try:
            assert isinstance(mgr, klass)
            assert (mgr.trainer.secagg if rank == 3 else
                    getattr(mgr, "secagg", None)
                    or mgr.aggregator.secagg).threshold_t == 1
        finally:
            mgr.finish()


def test_launcher_runs_a_masked_job_over_loopback():
    """``--algo turboaggregate --world_size 4`` at full participation (3
    clients, 3 workers: the ranks keep every client's sample count, which
    the pre-normalized weights need): a 2-round loopback job of the
    launcher's ranks as threads; rank 0 prints a finite history and every
    round decoded full."""
    argv = ["--world_size", "4", "--backend", "loopback", "--algo",
            "turboaggregate", "--dataset", "mnist", "--model", "lr",
            "--comm_round", "2", "--client_num_in_total", "3",
            "--batch_size", "8", "--frequency_of_the_test", "1",
            "--device", "cpu", "--job_id", "tt-launch"]
    seen, errors = [], []

    class Server(ta.TASecureServerManager):
        def _advance_round(self):
            super()._advance_round()
            seen.append(dict(self._last_secagg))

    def rank(r):
        try:
            distributed_launch.main(["--rank", str(r), *argv])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    out = io.StringIO()
    orig, ta.TASecureServerManager = ta.TASecureServerManager, Server
    threads = [threading.Thread(target=rank, args=(r,)) for r in (1, 2, 3)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while set(loopback._registry.get("launch", {})) != {1, 2, 3}:
            assert time.monotonic() < deadline and not errors, errors
            time.sleep(0.02)
        with redirect_stdout(out):
            # rank 0 on a thread too: a worker that dies (errors) must
            # fail the test, not leave the server waiting for good
            root = threading.Thread(target=rank, args=(0,), daemon=True)
            root.start()
            while root.is_alive() and not errors \
                    and time.monotonic() < deadline + 60:
                root.join(timeout=0.1)
        for t in threads:
            t.join(timeout=0 if errors else 60)
    finally:
        ta.TASecureServerManager = orig
    assert not errors, errors
    assert not root.is_alive(), "rank 0 did not finish"
    hist = json.loads(out.getvalue().strip().splitlines()[-1])
    assert [h["round"] for h in hist] == [0, 1]
    assert all(h["test_loss"] == h["test_loss"] for h in hist)  # finite
    assert [s["outcome"] for s in seen] == ["full", "full"]
