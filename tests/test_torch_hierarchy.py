"""The hierarchical edge tier in the port (fedml_tpu_torch/distributed/
fedavg/hierarchy.py and robust_agg's edge functions) against the JAX
package's, on tests/test_hierarchy_tiers.py's and test_hierarchy_robust.py's
tiny configuration (synthetic images of 8 clients, LogisticRegression, 8
clients a round, batch 6), from the same seeded numpy inputs and weights.

Tolerances: inside the port the tree is held to the flat pairwise run
bitwise (model and ledger), as the reference holds its own; the edge
functions against the JAX package's within 1e-6 with equal reason codes;
whole runs against the JAX package's within 1e-5 with equal ledgers (the
two packages sum in other orders)."""

import io
import json
import threading
import time
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.chaos import AdversaryPlan as JaxAdversaryPlan
from fedml_tpu.comm.message import pack_pytree as jax_pack
from fedml_tpu.core import robust_agg as J
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.distributed.fedavg import api as jax_api
from fedml_tpu.distributed.fedavg import hierarchy as jax_hier
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgConfig
from fedml_tpu_torch.chaos import AdversaryPlan, FaultPlan
from fedml_tpu_torch.comm import loopback
from fedml_tpu_torch.comm.message import pack_pytree
from fedml_tpu_torch.core import robust_agg as P
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import hierarchy, run_simulated
from fedml_tpu_torch.distributed.fedavg.client_manager import (
    FedAvgClientManager,
)
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.distributed.fedavg.trainer import DistributedTrainer
from fedml_tpu_torch.distributed.utils import launch_simulated
from fedml_tpu_torch.experiments import distributed_launch
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs.metrics import REGISTRY
from fedml_tpu_torch.obs.telemetry import Telemetry
from test_torch_comm import free_port_block

TOL = dict(rtol=1e-6, atol=1e-7)
TOL_RUN = dict(rtol=1e-5, atol=1e-6)
DATA_KW = dict(num_clients=8, image_shape=(6, 6, 1), num_classes=3,
               samples_per_client=12, test_samples=24, seed=0)
SIGN_FLIP_2_OF_8 = {"seed": 1, "rules": [
    {"attack": "sign_flip", "ranks": [2, 5], "factor": 10.0}]}
NAN_ON_3 = {"seed": 1, "rules": [{"attack": "nan", "ranks": [3]}]}
CHAOS = {"seed": 7, "rules": [
    {"fault": "delay", "delay_s": 0.05, "prob": 0.5},
    {"fault": "duplicate", "prob": 0.3}]}
# edge rank 1 (cohort slots 0-1 at edges=2, 4 a round) goes dark in round
# 1 (rule windows are half-open); the root marks it undeliverable and, at
# its reprobe cadence of 4 rounds, leaves the block out through round 4
EDGE_CRASH = {"seed": 5, "rules": [
    {"fault": "crash", "ranks": [1], "rounds": [1, 2]}]}
LOST_ROUNDS = (1, 2, 3, 4)
# the elastic runs arm their watchdogs with this deadline and never wait it
# out: _drive_stalls calls the root's on_timeout instead, at the protocol
# state the deadline would find
FAR_DEADLINE_S = 600.0


# ------------------------------------------------------------------ inputs
def _stack(k=8, seed=0, poison=True):
    """Leaves of two shapes in sorted-key order (both packages flatten them
    alike), a global model and [K] sample weights; a non-finite slot and a
    norm outlier when ``poison``."""
    rs = np.random.RandomState(seed)
    st = {"a": rs.randn(k, 6, 2).astype(np.float32),
          "b": rs.randn(k, 3).astype(np.float32)}
    g = {"a": rs.randn(6, 2).astype(np.float32),
         "b": rs.randn(3).astype(np.float32)}
    w = (np.abs(rs.randn(k)) * 7 + 1).astype(np.float32)
    if poison:
        st["b"][5] = np.inf
        st["a"][2] *= 40.0
    return st, g, w


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _rows(tree, s, c):
    return {k: v[s:s + c] for k, v in tree.items()}


def _bits(state: dict) -> list:
    return [v.numpy().tobytes() for v in state.values()]


def _split_flat(st, g, w, c, vf=None):
    """Blocks of ``c`` slots: edge partials (single-phase), or per-block
    evidence -> the cohort's verdicts -> per-block apply_verdicts (``vf``),
    then the root's combine. Returns (avg, reasons)."""
    blocks = range(0, len(w), c)
    if vf is None:
        parts = [P.edge_partial(_rows(st, s, c), g, w[s:s + c])
                 for s in blocks]
        reasons = torch.cat([r for _, _, r in parts])
    else:
        ev = [P.update_evidence(_rows(st, s, c), g, w[s:s + c])
              for s in blocks]
        cohort = {k: torch.cat([e[k] for e in ev]) for k in ev[0]}
        vw, reasons = P.evidence_verdicts(cohort, vf, norm_mult=4.0)
        parts = [P.apply_verdicts(_rows(st, s, c), g, vw[s:s + c]) + (None,)
                 for s in blocks]
    stacked = {k: torch.stack([p[0][k] for p in parts]) for k in g}
    avg, _ = P.combine_edge_partials(
        stacked, torch.stack([p[1] for p in parts]), g)
    return avg, reasons


# --------------------------------------------------------------- functions
@pytest.mark.parametrize("fn", ["nonfinite_gate", "edge_partial",
                                "combine_edge_partials"])
def test_edge_functions_match_jax(fn):
    """Each edge function on the same inputs as the JAX package's: reason
    codes equal, values within 1e-6 (a zero-weight slot reads OK)."""
    st, g, w = _stack(seed=3)
    w[6] = 0.0
    if fn == "combine_edge_partials":
        got = P.combine_edge_partials(_port(st), torch.from_numpy(w), _port(g))
        want = J.combine_edge_partials(_jax(st), jnp.asarray(w), _jax(g))
    else:
        got = getattr(P, fn)(_port(st), _port(g), torch.from_numpy(w))
        want = getattr(J, fn)(_jax(st), _jax(g), jnp.asarray(w))
    for a, b in zip(got, want):
        if isinstance(a, dict):
            for k in b:
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           err_msg=f"{fn} {k}", **TOL)
        elif a.dtype == torch.int32:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if fn == "nonfinite_gate":
        assert got[2].tolist() == [0, 0, 0, 0, 0, 1, 0, 0]


@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_edge_partials_equal_flat_gated_pairwise(c):
    """Edge partials over blocks of ``c`` slots, then the root's combine,
    are bitwise ``gated_aggregate(pairwise=True)`` over the K = 8 cohort,
    values and reason codes, a non-finite slot and a zero-weight one
    among them."""
    st, g, w = _stack(seed=2)
    w[3] = 0.0
    st, g, w = _port(st), _port(g), torch.from_numpy(w)
    flat, _, flat_r = P.gated_aggregate(st, g, w, norm_mult=float("inf"),
                                        pairwise=True)
    tree, reasons = _split_flat(st, g, w, c)
    assert _bits(tree) == _bits(flat)
    assert reasons.tolist() == flat_r.tolist()
    assert reasons.dtype == torch.int32


@pytest.mark.parametrize("name", ["mean", "krum", "multi_krum", "median",
                                  "trimmed_mean", "geometric_median"])
def test_two_phase_split_equals_flat_bitwise(name):
    """Per-block update_evidence -> evidence_verdicts over the concatenated
    evidence -> per-block apply_verdicts -> the combine is bitwise
    ``gated_aggregate(verdict_fn=)``, values and reason codes."""
    st, g, w = (_port(t) if isinstance(t, dict) else torch.from_numpy(t)
                for t in _stack())
    vf = P.make_verdict_estimator(name, n=8, f=2)
    flat, _, flat_r = P.gated_aggregate(st, g, w, verdict_fn=vf,
                                        norm_mult=4.0)
    tree, reasons = _split_flat(st, g, w, 2, vf=vf)
    assert _bits(tree) == _bits(flat), name
    assert reasons.tolist() == flat_r.tolist(), name
    assert all(bool(torch.isfinite(v).all()) for v in tree.values())


def test_edge_topology_validation():
    t = hierarchy.EdgeTopology(edges=2, workers=8)
    assert t.block == 4 and t.world_size == 11
    assert t.edge_rank(1) == 2
    assert t.worker_rank(0) == 3 and t.slot_of(10) == 7
    assert t.edge_of_slot(3) == 0 and t.edge_of_slot(4) == 1
    assert list(t.slots_of_edge(1)) == [4, 5, 6, 7]
    for edges, workers in ((3, 8), (2, 6), (0, 4)):
        with pytest.raises(ValueError) as got:
            hierarchy.EdgeTopology(edges=edges, workers=workers)
        with pytest.raises(ValueError) as want:
            jax_hier.EdgeTopology(edges=edges, workers=workers)
        assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- runtime
def _cfg(rounds=3, per_round=8):
    return dict(comm_round=rounds, client_num_in_total=8,
                client_num_per_round=per_round, batch_size=6, lr=0.1,
                frequency_of_the_test=1, seed=0)


@pytest.fixture(scope="module")
def setup():
    """Both packages' data (bitwise equal) and tasks; the port's task inits
    to the JAX aggregator's initial params."""
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


def _run(s, job, rounds=3, per_round=8, plan=None, chaos=None, **kw):
    return run_simulated(
        s["data"], s["task"], FedAvgConfig(**_cfg(rounds, per_round)),
        job_id=job, device="cpu",
        adversary_plan=None if plan is None else AdversaryPlan.from_json(plan),
        chaos_plan=None if chaos is None else FaultPlan.from_json(chaos),
        **kw)


def _same_bits(a, b) -> bool:
    return all(x.tobytes() == y.tobytes()
               for x, y in zip(pack_pytree(a.net), pack_pytree(b.net)))


TREE_CASES = {
    "plain": {},
    "chaos_nan": dict(plan=NAN_ON_3, chaos=CHAOS, round_timeout_s=15.0),
    **{leg: dict(plan=SIGN_FLIP_2_OF_8, chaos=CHAOS, round_timeout_s=15.0,
                 aggregator=agg, aggregator_params=params, sanitize=san)
       for leg, agg, params, san in (
           ("krum", "krum", {"f": 2}, None),
           ("multi_krum", "multi_krum", {"f": 2}, None),
           ("median", "median", None, None),
           ("trimmed_mean", "trimmed_mean", None, None),
           ("sanitize", None, None, True))},
}


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_tree_equals_flat_pairwise_bitwise(setup, case):
    """``edges=2`` against the flat ``sum_assoc='pairwise'`` run, one plan
    driving both (tree workers match the plan by cohort slot + 1): model
    bits and ledger equal, root fan-in 2 a round. Plain; under the
    reference's delay/duplicate chaos with a NaN adversary on cohort rank 3
    (the edge gate stops it); and under the 2-of-8 sign-flip for each
    robust leg through the two-phase protocol (the flippers named)."""
    kw = TREE_CASES[case]
    flat = _run(setup, f"th-flat-{case}", sum_assoc="pairwise", **kw)
    tree = _run(setup, f"th-tree-{case}", edges=2, **kw)
    assert _same_bits(tree, flat), case
    led = tree.quarantine.canonical()
    assert led == flat.quarantine.canonical()
    assert tree.fanin_history == [2, 2, 2]
    assert [h["round"] for h in tree.history] == [0, 1, 2]
    assert all(bool(torch.isfinite(v).all()) for v in tree.net.values())
    if case == "plain":
        assert not led
    elif case == "chaos_nan":
        assert led and all(e[1] == 3 and e[2] == "nonfinite" for e in led)
    else:
        assert {e[1] for e in led if e[2] == "norm_outlier"} == {2, 5}


def test_sign_flip_delivery_through_edges_unchanged(setup):
    """An undefended tree delivers a worker's sign-flipped upload through
    its edge unchanged: bitwise the undefended flat pairwise run on the
    same plan, and not the clean tree run."""
    plan = {"seed": 2, "rules": [{"attack": "sign_flip", "ranks": [3],
                                  "factor": 3.0}]}
    flat = _run(setup, "th-del-flat", rounds=2, plan=plan,
                sum_assoc="pairwise")
    tree = _run(setup, "th-del-tree", rounds=2, plan=plan, edges=2)
    clean = _run(setup, "th-del-clean", rounds=2, edges=2)
    assert _same_bits(tree, flat)
    assert not _same_bits(tree, clean)
    assert len(tree.quarantine) == 0


# ------------------------------------------------------------ vs the JAX tree
@pytest.fixture(scope="module")
def jax_tree(setup):
    """The JAX package's tree (edges=2) under SIGN_FLIP_2_OF_8 with krum,
    over loopback."""
    agg = jax_api.run_simulated(
        setup["jdata"], setup["jtask"], JaxConfig(**_cfg()), edges=2,
        job_id="th-jax-tree", aggregator="krum", aggregator_params={"f": 2},
        adversary_plan=JaxAdversaryPlan.from_json(SIGN_FLIP_2_OF_8))
    return dict(leaves=jax_pack(agg.net), ledger=agg.quarantine.canonical(),
                fanin=list(agg.fanin_history))


def _close_to(leaves, want):
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL_RUN)


def test_port_tree_matches_jax_tree(setup, jax_tree):
    """The port's krum tree under the same plan: the ledger is the JAX
    tree's entry for entry, the params within 1e-5."""
    tree = _run(setup, "th-port-krum", plan=SIGN_FLIP_2_OF_8, edges=2,
                aggregator="krum", aggregator_params={"f": 2})
    assert tree.quarantine.canonical() == jax_tree["ledger"]
    assert len(jax_tree["ledger"]) > 0
    assert tree.fanin_history == jax_tree["fanin"] == [2, 2, 2]
    _close_to(pack_pytree(tree.net), jax_tree["leaves"])


def test_mixed_grpc_tree_jax_root_port_edges_and_workers(setup, jax_tree):
    """One gRPC job of both packages: the JAX package's root, the port's
    two edges and eight workers. The e2s evidence and partial frames and
    the s2e verdict frames cross the packages; the job's ledger is the
    all-JAX tree's, its params within 1e-5."""
    pytest.importorskip("grpc")
    topo = hierarchy.EdgeTopology(edges=2, workers=8)
    base = free_port_block(topo.world_size)
    cfg = FedAvgConfig(**_cfg())
    root_agg = jax_hier.HierFedAvgAggregator(
        setup["jdata"], setup["jtask"], JaxConfig(**_cfg()),
        jax_hier.EdgeTopology(edges=2, workers=8), aggregator="krum",
        aggregator_params={"f": 2})
    root = jax_hier.HierFedAvgServerManager(
        root_agg, rank=0, size=topo.world_size, backend="GRPC",
        base_port=base)
    edges = [hierarchy.FedAvgEdgeManager(
        topo.edge_rank(e), topo, backend="GRPC", robust=True,
        sketch_dim=root_agg.sketch_dim, device="cpu", base_port=base)
        for e in range(topo.edges)]
    workers = [FedAvgClientManager(
        DistributedTrainer(topo.worker_rank(s), setup["data"], setup["task"],
                           cfg, device="cpu"),
        rank=topo.worker_rank(s), size=topo.world_size, backend="GRPC",
        server_rank=topo.edge_rank(topo.edge_of_slot(s)),
        adversary_plan=AdversaryPlan.from_json(SIGN_FLIP_2_OF_8),
        adversary_rank=s + 1, base_port=base) for s in range(topo.workers)]
    launch_simulated(root, edges + workers)
    assert root_agg.quarantine.canonical() == jax_tree["ledger"]
    assert list(root_agg.fanin_history) == [2, 2, 2]
    _close_to(jax_pack(root_agg.net), jax_tree["leaves"])


# --------------------------------------------------------------- elasticity
def _drive_stalls(server, lost_rounds, reporting, stop):
    """The root's watchdog, driven: in each of ``lost_rounds`` call its
    ``on_timeout`` once every slot in ``reporting`` (edge or worker indices
    that still report) has, and the two-phase root's evidence cut once
    their evidence has: the states in which the deadline would fire, as
    nothing else can arrive."""
    while not stop.wait(0.002):
        with server._round_lock:
            flags = server.aggregator.flag_client_model_uploaded
            stalled = server.round_idx in lost_rounds and (
                all(flags[i] for i in reporting)
                or (getattr(server, "_robust", False)
                    and not server._verdict_sent
                    and sorted(server._edge_evidence) == list(reporting)))
        if stalled:
            server.on_timeout(FAR_DEADLINE_S)


def _driven(monkeypatch, lost_rounds, reporting):
    """Runs launched while this is in force have their stalls driven."""
    from fedml_tpu_torch.distributed import utils
    from fedml_tpu_torch.distributed.fedavg import api

    launch = utils.launch_simulated

    def driven(server, clients, **kw):
        stop = threading.Event()
        t = threading.Thread(target=_drive_stalls,
                             args=(server, lost_rounds, reporting, stop))
        t.start()
        try:
            return launch(server, clients, **kw)
        finally:
            stop.set()
            t.join()

    monkeypatch.setattr(utils, "launch_simulated", driven)
    monkeypatch.setattr(api, "launch_simulated", driven)


def _crash_run(s, job, monkeypatch, rounds=6, telemetry=None):
    _driven(monkeypatch, LOST_ROUNDS, reporting=[1])
    return _run(s, job, rounds=rounds, per_round=4, chaos=EDGE_CRASH,
                edges=2, sanitize=True, round_timeout_s=FAR_DEADLINE_S,
                telemetry=telemetry)


def test_edge_crash_is_ledgered_edge_lost_and_replays(setup, monkeypatch):
    """Edge rank 1 dark in round 1, back at the reprobe of round 5: its
    block's cohort ranks 1 and 2 are ledgered edge_lost in each lost round
    with the clients they would have trained, root fan-in drops to 1 and
    comes back to 2, each lost round's num_samples is the reporting block's
    sample mass (numpy oracle), and the whole run replays bit for bit."""
    tel = Telemetry()
    agg = _crash_run(setup, "th-crash-a", monkeypatch, telemetry=tel)
    tel.close()
    led = agg.quarantine.canonical()
    lost = [e for e in led if e[2] == "edge_lost"]
    want = sorted((r, s + 1, "edge_lost", int(sample_clients(r, 8, 4, 0)[s]))
                  for r in LOST_ROUNDS for s in (0, 1))
    assert lost == want
    assert agg.fanin_history == [2, 1, 1, 1, 1, 2]
    assert agg.history[-1]["round"] == 5
    sizes = setup["data"].train_data_local_num_dict
    recs = [r for r in tel.events.sink.records if r.get("kind") == "round"]
    assert [r["round"] for r in recs] == list(range(6))
    for rec in recs:
        r = rec["round"]
        ids = sample_clients(r, 8, 4, 0)
        slots = (2, 3) if r in LOST_ROUNDS else (0, 1, 2, 3)
        assert rec["metrics"]["num_samples"] == float(
            sum(sizes[int(ids[s])] for s in slots)), r
        assert rec["hier"]["rejected"] == ([2, 0] if r in LOST_ROUNDS
                                           else [0, 0])
    again = _crash_run(setup, "th-crash-b", monkeypatch)
    assert again.quarantine.canonical() == led
    assert _same_bits(again, agg)


def test_edge_crash_rounds_equal_flat_missing_block(setup, monkeypatch):
    """The crashed edge's rounds are sample-weight exact: bitwise a flat
    pairwise run whose same worker block's uplinks are dropped in the same
    rounds (zero-term partials == stacking the survivors)."""
    tree = _crash_run(setup, "th-oracle-tree", monkeypatch, rounds=3)
    _driven(monkeypatch, LOST_ROUNDS, reporting=[2, 3])
    flat = _run(setup, "th-oracle-flat", rounds=3, per_round=4,
                sum_assoc="pairwise", sanitize=True,
                round_timeout_s=FAR_DEADLINE_S,
                chaos={"seed": 5, "rules": [
                    {"fault": "drop", "direction": "send", "src": [1, 2],
                     "dst": [0], "prob": 1.0, "rounds": [1, 3]}]})
    assert tree.fanin_history == [2, 1, 1]
    assert [e for e in flat.quarantine.canonical()
            if e[2] != "edge_lost"] == [
        e for e in tree.quarantine.canonical() if e[2] != "edge_lost"]
    assert _same_bits(tree, flat)


class _DropOnce:
    """Round 1's first verdict frame to edge 1 (at the root) or edge 1's
    first partial frame (at the edge) never leaves; ``dropped`` is set."""

    def __init__(self):
        self.dropped = threading.Event()
        self.retransmits = 0


@pytest.mark.parametrize("lost", ["verdict", "partial"])
def test_lost_control_frame_healed_by_the_root_retry(setup, monkeypatch,
                                                     lost):
    """A verdict frame lost on the root's way out is healed by the root's
    single verdict re-send; a partial lost on the edge's way out by the
    same re-send, which finds the edge already folded and makes it
    retransmit its cached partial. The watchdog is driven here by calling
    the root's ``on_timeout`` once the frame is lost (the deadline itself
    is far off); the run lands bitwise on the undisturbed one."""
    drop = _DropOnce()
    roots = []

    class Root(hierarchy.HierFedAvgServerManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            roots.append(self)

        def _send_verdict_frame(self, edge_idx):
            if (lost == "verdict" and self.round_idx == 1 and edge_idx == 0
                    and not drop.dropped.is_set()):
                drop.dropped.set()
                return
            super()._send_verdict_frame(edge_idx)

    class Edge(hierarchy.FedAvgEdgeManager):
        def _send_partial_frame(self, wsum, total, reasons):
            if (lost == "partial" and self._round == 1 and self.rank == 1
                    and not drop.dropped.is_set()):
                self._last_partial = (wsum, total, reasons)
                self._forwarded = True
                drop.dropped.set()
                return
            if self._forwarded and self.rank == 1:
                drop.retransmits += 1
            super()._send_partial_frame(wsum, total, reasons)

    monkeypatch.setattr(hierarchy, "HierFedAvgServerManager", Root)
    monkeypatch.setattr(hierarchy, "FedAvgEdgeManager", Edge)
    kw = dict(edges=2, aggregator="median", plan=SIGN_FLIP_2_OF_8)
    out = {}
    job = threading.Thread(target=lambda: out.setdefault("agg", _run(
        setup, f"th-heal-{lost}", round_timeout_s=FAR_DEADLINE_S, **kw)))
    job.start()
    assert drop.dropped.wait(60)
    roots[0].on_timeout(FAR_DEADLINE_S)
    job.join(60)
    assert not job.is_alive()
    monkeypatch.undo()
    want = _run(setup, f"th-heal-ref-{lost}", **kw)
    agg = out["agg"]
    assert agg.fanin_history == [2, 2, 2]
    assert agg.quarantine.canonical() == want.quarantine.canonical()
    assert _same_bits(agg, want)
    assert drop.retransmits == (1 if lost == "partial" else 0)


# ------------------------------------------------------------ observability
def _wire_counts():
    """comm_bytes_total by direction (uplink: frames to rank 0) and
    comm_messages_sent_total by frame type."""
    snap = REGISTRY.snapshot()
    fam = snap.get("comm_bytes_total", {})
    out = {d: sum(v for k, v in fam.items() if f"direction={d}" in k)
           for d in ("evidence", "verdict", "uplink")}
    sent = snap.get("comm_messages_sent_total", {})
    for t in (MyMessage.MSG_TYPE_E2S_SEND_AGG_TO_SERVER,
              MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER):
        out[t] = sum(v for k, v in sent.items() if f"type={t}" in k)
    return out


def _per_round(after, before, rounds):
    return {k: (after[k] - before[k]) / rounds for k in after}


def test_evidence_budget_and_o_edges_ingress(setup):
    """The two-phase control plane's measured bytes a round: evidence
    within ``sketch_dim + 3`` float32 scalars a client plus 2 KiB a frame,
    verdicts within two scalars a client plus 2 KiB a frame. The root takes
    E update frames a round (the tree's frames to rank 0), the flat server
    W."""
    rounds, E, W = 3, 2, 8
    c0 = _wire_counts()
    agg = _run(setup, "th-budget", rounds=rounds, edges=E,
               aggregator="median")
    c1 = _wire_counts()
    _run(setup, "th-budget-flat", rounds=rounds, sum_assoc="pairwise",
         aggregator="median")
    c2 = _wire_counts()
    tree, flat = _per_round(c1, c0, rounds), _per_round(c2, c1, rounds)
    assert agg.fanin_history == [E] * rounds
    assert 0 < tree["evidence"] <= W * 4 * (P.EVIDENCE_SKETCH_DIM + 3) \
        + E * 2048
    assert 0 < tree["verdict"] <= W * 4 * 2 + E * 2048
    assert flat["evidence"] == flat["verdict"] == 0
    assert tree[MyMessage.MSG_TYPE_E2S_SEND_AGG_TO_SERVER] == E
    assert tree[MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER] == W
    assert flat[MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER] == W
    assert 0 < tree["uplink"] < flat["uplink"]


@pytest.mark.parametrize("leg", ["plain_edges4", "krum_edges2"])
def test_round_record_hier_block(setup, leg):
    """The tree's round records carry the ``hier`` block: edges, block,
    fan-in, per-edge rejections, and under the two-phase protocol the
    verdict round trip; num_samples is the raw client mass whatever the
    verdicts folded (krum's winner folds at weight 1.0). A flat run's
    record has no such block."""
    tel = Telemetry()
    if leg == "plain_edges4":
        _run(setup, "th-rec-plain", rounds=2, edges=4, telemetry=tel)
    else:
        _run(setup, "th-rec-krum", rounds=2, edges=2, aggregator="krum",
             aggregator_params={"f": 2}, plan=SIGN_FLIP_2_OF_8,
             telemetry=tel)
    recs = tel.events.sink.records
    tel.close()
    assert [r for r in recs if r.get("kind") == "run"][0]["world_size"] == \
        1 + (4 if leg == "plain_edges4" else 2) + 8
    rounds = [r for r in recs if r.get("kind") == "round"]
    mass = float(sum(setup["data"].train_data_local_num_dict.values()))
    assert len(rounds) == 2
    for r in rounds:
        hier = r["hier"]
        assert r["metrics"]["num_samples"] == mass
        if leg == "plain_edges4":
            assert (hier["edges"], hier["block"], hier["fan_in"]) == (4, 2, 4)
            assert hier["rejected"] == [0, 0, 0, 0]
            assert "verdict_rtt_s" not in hier
        else:
            assert (hier["edges"], hier["block"], hier["fan_in"]) == (2, 4, 2)
            assert len(hier["rejected"]) == 2 and sum(hier["rejected"]) >= 2
            assert hier["verdict_rtt_s"] > 0
    flat_tel = Telemetry()
    _run(setup, f"th-rec-flat-{leg}", rounds=1, telemetry=flat_tel)
    flat = [r for r in flat_tel.events.sink.records
            if r.get("kind") == "round"]
    flat_tel.close()
    assert flat and "hier" not in flat[0]


# ----------------------------------------------------------------- refusals
@pytest.mark.parametrize("option", [
    dict(sparsify_ratio=0.5), dict(update_codec="delta-int8"),
    dict(delta_broadcast=True), dict(async_buffer_k=2),
    dict(shard_server_state=True), dict(heartbeat_max_age_s=1.0),
    dict(sum_assoc="pairwise"), dict(churn_trace=object()),
], ids=lambda kw: next(iter(kw)))
def test_run_simulated_refuses_what_the_tree_does_not_compose_with(
        setup, option):
    name = next(iter(option))
    match = "churn_trace" if name == "churn_trace" else "does not compose"
    with pytest.raises(ValueError, match=match):
        _run(setup, "th-refuse", edges=2, **option)


@pytest.mark.parametrize("name", ["async_buffer_k", "delta_broadcast",
                                  "heartbeat_max_age_s", "churn_trace"])
def test_tree_root_refuses_unwired_modes(setup, name):
    topo = hierarchy.EdgeTopology(edges=2, workers=8)
    agg = hierarchy.HierFedAvgAggregator(
        setup["data"], setup["task"], FedAvgConfig(**_cfg()), topo,
        device="cpu")
    with pytest.raises(ValueError, match="not wired through edge"):
        hierarchy.HierFedAvgServerManager(agg, rank=0, size=11,
                                          job_id="th-root-refuse",
                                          **{name: 2})


def _edge(job):
    topo = hierarchy.EdgeTopology(edges=2, workers=8)
    return hierarchy.FedAvgEdgeManager(1, topo, device="cpu", job_id=job)


def test_encoded_uplink_reaching_an_edge_raises():
    edge = _edge("th-encoded")
    try:
        edge._round = 0
        with pytest.raises(RuntimeError, match="encoded uplinks"):
            edge._handle_child_upload({
                "sender": 3, MyMessage.MSG_ARG_KEY_ROUND: 0,
                MyMessage.MSG_ARG_KEY_UPDATE_CODEC: "delta-int8",
                MyMessage.MSG_ARG_KEY_NUM_SAMPLES: 12})
    finally:
        edge.finish()


@pytest.mark.parametrize("case", ["fused_agg", "edge_fused", "root_crash",
                                  "resume_probe", "fleet_marker",
                                  "turboaggregate"])
def test_unported_tree_options_raise_naming_their_item(setup, case,
                                                       tmp_path):
    """The tree's options still out of scope raise NotImplementedError
    naming their ROADMAP.md item. Root restarts, the edge's resume probe,
    resuming a root from a DP run's WAL, the relayed fleet marker, the
    mid-reveal root crash point, the hierarchical masked tier and the
    fused edge ingest run now (tests/test_torch_recovery.py,
    test_tree_root_resumes_a_dp_runs_wal, tests/test_torch_fleet.py,
    tests/test_torch_secagg_tree.py, tests/test_torch_fused_agg.py): their
    cases keep a refusal that remains next to them (a sharded server
    plane's partition rules, item 12; the masked tree's launcher with the
    server optimizer, item 9)."""
    item = "9" if case == "turboaggregate" else "12"
    rules = dict(partition_rules=[])
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md queue A, item {item}"):
        if case == "fused_agg":
            _run(setup, "th-fused", edges=2, fused_agg=True, **rules)
        elif case == "edge_fused":
            # an edge rank of a fused tree whose root shards its state
            distributed_launch.main([
                "--rank", "1", "--world_size", "11", "--device", "cpu",
                "--edges", "2", "--fused_agg", "1",
                "--shard_server_state", "1"])
        elif case == "root_crash":
            _run(setup, "th-root-crash", edges=2,
                 ckpt_dir=str(tmp_path / "ckpt"), fused_agg=True,
                 chaos={"seed": 0, "rules": [
                     {"fault": "crash", "ranks": [0], "rounds": [1, 2],
                      "after_uploads": -1}]}, **rules)
        elif case == "resume_probe":
            _run(setup, "th-resume-fused", edges=2, fused_agg=True,
                 ckpt_dir=_dp_wal_dir(str(tmp_path)), **rules)
        elif case == "turboaggregate":
            distributed_launch.main([
                "--rank", "0", "--world_size", "11", "--device", "cpu",
                "--edges", "2", "--algo", "turboaggregate",
                "--server_optimizer", "adam"])
        else:
            from fedml_tpu_torch.obs import Telemetry

            tel = Telemetry(fleet=True)
            try:
                _run(setup, "th-fleet-fused", edges=2, fused_agg=True,
                     telemetry=tel, **rules)
            finally:
                tel.close()


def _dp_wal_dir(d) -> str:
    """A ckpt_dir whose WAL holds a DP pre-charge (a DP run's crash
    artifact): an open round 0, no checkpoint."""
    from fedml_tpu_torch.core.wal import RoundWAL

    w = RoundWAL(d + "/wal")
    w.append("broadcast", sync=True, round=0)
    w.append("precharge", sync=True, round=0, q=0.5, z=1.0)
    w.close()
    return d


def test_tree_root_resumes_a_dp_runs_wal(setup, tmp_path):
    """A tree root booted on a DP run's WAL: its aggregator keeps no
    accountant, so the pre-charge is ignored (the reference's rule) and
    the open round re-runs behind the resume probe."""
    topo = hierarchy.EdgeTopology(edges=2, workers=8)
    agg = hierarchy.HierFedAvgAggregator(
        setup["data"], setup["task"], FedAvgConfig(**_cfg()), topo,
        device="cpu")
    srv = hierarchy.HierFedAvgServerManager(
        agg, rank=0, size=11, ckpt_dir=_dp_wal_dir(str(tmp_path)),
        job_id="th-root-dp")
    try:
        assert srv._resume_round == 0 and srv.round_idx == 0
    finally:
        srv.com_manager.stop_receive_message()
        srv.wal.close()


# ----------------------------------------------------------------- launcher
def test_launcher_runs_a_robust_tree_under_attack():
    """``--edges 2 --world_size 11 --aggregator krum --byzantine_f 1
    --adversary_plan '<json>'``: a 2-round loopback job of the launcher's
    ranks (1 root, 2 edges, 8 workers) as threads in this process; rank 0
    prints a finite history, the root folds 2 partials a round, and the
    attacker (cohort rank 3) is named every round."""
    plan = json.dumps({"seed": 2, "rules": [
        {"attack": "sign_flip", "ranks": [3], "factor": 10.0}]})
    argv = ["--world_size", "11", "--edges", "2", "--backend", "loopback",
            "--dataset", "mnist", "--model", "lr", "--comm_round", "2",
            "--client_num_in_total", "10", "--batch_size", "8",
            "--frequency_of_the_test", "1", "--device", "cpu",
            "--aggregator", "krum", "--byzantine_f", "1",
            "--adversary_plan", plan]
    seen, errors = [], []

    class Root(hierarchy.HierFedAvgServerManager):
        def __init__(self, agg, *a, **k):
            super().__init__(agg, *a, **k)
            seen.append(agg)

    def rank(r):
        try:
            distributed_launch.main(["--rank", str(r), *argv])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    out = io.StringIO()
    orig, hierarchy.HierFedAvgServerManager = (
        hierarchy.HierFedAvgServerManager, Root)
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(1, 11)]
    try:
        for t in threads:
            t.start()
        # loopback delivers only to registered ranks: the root starts once
        # every other rank listens, as a launch script starts them first
        deadline = time.monotonic() + 60
        while set(loopback._registry.get("launch", {})) != set(range(1, 11)):
            assert time.monotonic() < deadline and not errors, errors
            time.sleep(0.02)
        with redirect_stdout(out):
            rank(0)
        for t in threads:
            t.join(timeout=0 if errors else 60)
    finally:
        hierarchy.HierFedAvgServerManager = orig
        for mgr in list(loopback._registry.get("launch", {}).values()):
            mgr.stop_receive_message()  # a failed run must not leave ranks
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    history = json.loads(out.getvalue().strip().splitlines()[-1])
    assert [h["round"] for h in history] == [0, 1]
    assert all(np.isfinite(h["test_loss"]) for h in history)
    agg = seen[0]
    assert agg.fanin_history == [2, 2]
    assert {(e[0], e[1]) for e in agg.quarantine.canonical()} >= {(0, 3),
                                                                 (1, 3)}
