"""Fused on-device ingest in the port (core/fused_agg.py, the aggregator's
``fused_agg``, the server's arrival densify, the edges' fused ingest, the
launcher's ``--fused_agg``) on the CPU.

Inside the port everything is bitwise: the streaming accumulator is the
stacked ``sum_assoc='pairwise'`` fold (model bits and reason codes, any K
and any arrival order); fused ≡ stacked over loopback for the dense tier
and each codec tier, with the quarantine ledger equal; the staged mode ≡
stacked for the five estimators and the armed norm gate; an elastic
partial ≡ the stacked subset; a duplicate slot folds once; the fused tree
≡ the fused flat run; async with bound 0 ≡ sync. (The reference's own
version of the first claim is a known red: XLA contracts its jitted
combine into an fma. Torch's eager ops contract nothing.)

Across packages the fused result is held to the JAX package's STACKED
``gated_aggregate(pairwise=True)`` within 1e-5, and the device densify to
both packages' host decoders bitwise.
"""

import functools
import io
import json
import random
import threading
import time
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.comm import delta as jax_delta
from fedml_tpu.comm import sparse as jax_sparse
from fedml_tpu.core.robust_agg import gated_aggregate as jax_gated_aggregate
from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
from fedml_tpu_torch.chaos import AdversaryPlan
from fedml_tpu_torch.comm import delta, sparse
from fedml_tpu_torch.core import fused_agg as F
from fedml_tpu_torch.core.robust_agg import gated_aggregate
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import run_simulated
from fedml_tpu_torch.models import create_model

SHAPES = [(36, 3), (3,), (17, 5)]


def _data():
    return synthetic_images(num_clients=8, image_shape=(6, 6, 1),
                            num_classes=3, samples_per_client=12,
                            test_samples=24, seed=0)


@pytest.fixture(scope="module")
def data():
    return _data()


def _task():
    return classification_task(create_model("lr", output_dim=3,
                                            device="cpu"))


def _cfg(**kw):
    base = dict(comm_round=2, client_num_in_total=8, client_num_per_round=4,
                batch_size=6, lr=0.1, frequency_of_the_test=100)
    base.update(kw)
    return FedAvgConfig(**base)


def _plan(*rules):
    return AdversaryPlan.from_json({"seed": 1, "rules": list(rules)})


NAN_2 = {"attack": "nan", "ranks": [2]}
FLIP_3 = {"attack": "sign_flip", "ranks": [3], "factor": 10.0}


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def _t(tree):
    return {i: torch.from_numpy(np.asarray(v)) for i, v in enumerate(tree)}


def _positions(leaves) -> dict:
    return dict(enumerate(leaves))


def _dense_ingest():
    meta = [(s, np.dtype(np.float32)) for s in SHAPES]
    return F.make_fused_ingest("dense", meta, _positions, torch.device("cpu"))


def _stacked(ups, glob, w):
    stacked = {i: torch.stack([torch.from_numpy(u[i]) for u in ups])
               for i in range(len(glob))}
    return gated_aggregate(stacked, _t(glob), torch.tensor(w),
                           norm_mult=float("inf"), pairwise=True)


# ------------------------------------------------------------ accumulator
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 7, 8, 9])
def test_accumulator_matches_stacked_pairwise_fold(K):
    """Shuffled arrivals with a non-finite upload: the streaming fold's
    bits and reason codes are the stacked gate + pairwise fold's, and the
    JAX package's stacked fold within 1e-5."""
    rs = np.random.RandomState(K)
    glob = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    ups = [[rs.randn(*s).astype(np.float32) for s in SHAPES]
           for _ in range(K)]
    if K >= 3:
        ups[2][0][0, 0] = np.nan
    w = [10.0 + i for i in range(K)]
    avg, _, reasons = _stacked(ups, glob, w)
    fr = F.FusedRoundIngest(_t(glob))
    fn = _dense_ingest()
    order = list(range(K))
    random.Random(K).shuffle(order)
    for i in order:
        fr.add(i, fn, ups[i], None, None, w[i])
    got, got_reasons = fr.flush()
    assert _same(avg, got), f"K={K}: model bits diverged"
    assert torch.equal(reasons, got_reasons)
    if K in (3, 8):  # the JAX package's stacked fold, within 1e-5
        jstack = [jnp.stack([u[i] for u in ups])
                  for i in range(len(SHAPES))]
        javg, _, jreasons = jax.jit(functools.partial(
            jax_gated_aggregate, robust_fn=None, norm_mult=float("inf"),
            pairwise=True))(jstack, [jnp.asarray(g) for g in glob],
                            jnp.asarray(w, jnp.float32))
        for i, j in enumerate(javg):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(j),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got_reasons.numpy(),
                                      np.asarray(jreasons))


def test_accumulator_in_order_memory_is_logarithmic():
    glob = {0: torch.zeros(4, 4)}
    fr = F.FusedRoundIngest(glob)
    fn = F.make_fused_ingest("dense", [((4, 4), np.dtype(np.float32))],
                             _positions,
                             torch.device("cpu"))
    K = 64
    for i in range(K):
        fr.add(i, fn, [np.ones((4, 4), np.float32)], None, None, 1.0)
    assert fr.peak_terms <= int(np.log2(K)) + 1, fr.peak_terms
    assert fr._acc.peak_nodes <= int(np.log2(K)) + 1


def test_duplicate_slot_folds_exactly_once():
    glob = {0: torch.zeros(2)}
    fn = F.make_fused_ingest("dense", [((2,), np.dtype(np.float32))],
                             _positions,
                             torch.device("cpu"))
    fr = F.FusedRoundIngest(glob)
    up = [np.ones(2, np.float32)]
    fr.add(0, fn, up, None, None, 5.0)
    fr.add(0, fn, up, None, None, 5.0)  # a chaos duplicate
    fr.add_state(0, {0: torch.full((2,), 9.0)}, 5.0)
    got, reasons = fr.flush()
    assert torch.equal(got[0], torch.ones(2)) and reasons.shape == (1,)


def test_elastic_partial_is_the_stacked_subset():
    """A straggler hole: the cursor pends the later slots, the flush skips
    the hole, and the fold is the stacked compacted subset."""
    rs = np.random.RandomState(3)
    glob = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    ups = [[rs.randn(*s).astype(np.float32) for s in SHAPES]
           for _ in range(5)]
    arrived, w = [0, 1, 3, 4], [10.0, 11.0, 13.0, 14.0]
    avg, _, _ = _stacked([ups[i] for i in arrived], glob, w)
    fr = F.FusedRoundIngest(_t(glob))
    fn = _dense_ingest()
    for i, wi in zip(arrived, w):
        fr.add(i, fn, ups[i], None, None, wi)
    got, _ = fr.flush()
    assert _same(avg, got)


@pytest.mark.parametrize("verdict", ["median", "krum", "sanitize"])
def test_staged_flush_is_the_stacked_verdict_route(verdict):
    from fedml_tpu_torch.core.robust_agg import make_verdict_estimator

    rs = np.random.RandomState(5)
    glob = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    ups = [[rs.randn(*s).astype(np.float32) for s in SHAPES]
           for _ in range(6)]
    ups[4] = [u * 50.0 for u in ups[4]]
    w = [10.0 + i for i in range(6)]
    vfn = (None if verdict == "sanitize"
           else make_verdict_estimator(verdict, n=6, f=1))
    mult = 4.0 if verdict == "sanitize" else float("inf")
    stacked = {i: torch.stack([torch.from_numpy(u[i]) for u in ups])
               for i in range(len(glob))}
    want = gated_aggregate(stacked, _t(glob), torch.tensor(w),
                           verdict_fn=vfn, norm_mult=mult,
                           pairwise=vfn is None)
    meta = [(s, np.dtype(np.float32)) for s in SHAPES]
    fr = F.FusedRoundIngest(_t(glob), staged=True)
    fn = F.make_fused_robust_ingest("dense", meta,
                                    _positions,
                                    torch.device("cpu"))
    for i in (5, 0, 3, 1, 4, 2):
        fr.add(i, fn, ups[i], None, None, w[i])
    got = fr.flush_robust(F.make_fused_robust_flush(vfn, norm_mult=mult))
    assert _same(want[0], got[0]) and torch.equal(want[2], got[2])
    if verdict == "median":
        assert int((got[1] > 0).sum()) == 1  # the medoid's one verdict
    else:
        assert (got[2] != 0).any(), "the outlier was never flagged"


# ------------------------------------------------------------- densify
def _encoded(codec, rs):
    base = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    local = [b + 0.1 * rs.randn(*b.shape).astype(np.float32) for b in base]
    d = delta.round_delta(local, base)
    if codec == "topk":
        idx, val = sparse.topk_encode(d, 0.3)
        return base, (idx, val), None
    payload, scales = delta.encode_update(d, codec)
    return base, payload, scales


@pytest.mark.parametrize("codec", ["delta", "delta-int8", "delta-sign1",
                                   "topk"])
def test_device_densify_is_both_packages_host_decode(codec):
    rs = np.random.RandomState(7)
    base, payload, scales = _encoded(codec, rs)
    meta = [(s, np.dtype(np.float32)) for s in SHAPES]
    if codec == "topk":
        want = sparse.topk_decode(base, *payload)
        jwant = jax_sparse.topk_decode(base, *payload)
        raw, sc = payload, None
    else:
        want = delta.apply_delta(base, delta.decode_update(
            payload, scales, codec, base))
        jwant = jax_delta.apply_delta(base, jax_delta.decode_update(
            payload, scales, codec, base))
        raw, sc = delta.inflate_update(payload, scales, codec, base)
    got = F.densify(codec, raw, sc, [torch.from_numpy(b) for b in base],
                    meta, torch.device("cpu"))
    for g, w, j in zip(got, want, jwant):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_nan_scale_decodes_nonfinite_and_dies_at_the_gate():
    rs = np.random.RandomState(8)
    base, payload, scales = _encoded("delta-int8", rs)
    scales = np.asarray(scales, np.float32).copy()
    scales[0] = np.nan
    raw, sc = delta.inflate_update(payload, scales, "delta-int8", base)
    meta = [(s, np.dtype(np.float32)) for s in SHAPES]
    fn = F.make_fused_ingest("delta-int8", meta,
                             _positions,
                             torch.device("cpu"))
    clean, w, reason = fn(raw, sc, [torch.from_numpy(b) for b in base],
                          _t(base), 3.0)
    assert float(w) == 0.0 and int(reason) == 1  # nonfinite
    assert _same(clean, _t(base))


# ------------------------------------------------------------ end to end
def _pair(data, job, **kw):
    a = run_simulated(data, _task(), _cfg(), device="cpu",
                      job_id=f"tf-s-{job}", sum_assoc="pairwise", **kw)
    b = run_simulated(data, _task(), _cfg(), device="cpu",
                      job_id=f"tf-f-{job}", fused_agg=True, **kw)
    return a, b


@pytest.mark.parametrize("tier", [
    {}, {"update_codec": "delta"}, {"update_codec": "delta-int8"},
    {"update_codec": "delta-sign1"}, {"sparsify_ratio": 0.3},
    {"update_codec": "delta-int8", "delta_broadcast": True}],
    ids=["dense", "delta", "delta-int8", "delta-sign1", "topk",
         "int8-delta-downlink"])
def test_fused_equals_stacked_over_loopback(data, tier):
    a, b = _pair(data, "-".join(map(str, tier.values())) or "dense",
                 adversary_plan=_plan(NAN_2), **tier)
    assert _same(a.net, b.net)
    assert b.quarantine.canonical(), "the NaN adversary was never ledgered"
    assert a.quarantine.canonical() == b.quarantine.canonical()
    rec = b.agg_record()
    assert rec["fused"] is True and rec["stack_bytes"] > 0
    assert a.agg_record()["fused"] is False


@pytest.mark.parametrize("leg", [
    dict(aggregator="median"), dict(aggregator="trimmed_mean"),
    dict(aggregator="krum", aggregator_params={"f": 0}),
    dict(aggregator="multi_krum", aggregator_params={"f": 0}),
    dict(aggregator="geometric_median"), dict(sanitize=True)],
    ids=["median", "trimmed_mean", "krum", "multi_krum",
         "geometric_median", "sanitize"])
def test_staged_fused_equals_stacked_estimators(data, leg):
    a, b = _pair(data, "-".join(map(str, leg.values())),
                 adversary_plan=_plan(NAN_2, FLIP_3), **leg)
    assert _same(a.net, b.net)
    assert a.quarantine.canonical() == b.quarantine.canonical()
    assert b._fused_staged and b.agg_record()["fused"] is True


def test_fused_tree_is_the_fused_flat_run(data):
    for kw in ({}, dict(aggregator="median")):
        tree = run_simulated(data, _task(), _cfg(), device="cpu", edges=2,
                             fused_agg=True, job_id=f"tf-tree-{kw}",
                             adversary_plan=_plan(NAN_2), **kw)
        flat = run_simulated(data, _task(), _cfg(), device="cpu",
                             fused_agg=True, job_id=f"tf-flat-{kw}",
                             adversary_plan=_plan(NAN_2), **kw)
        assert _same(tree.net, flat.net), kw
        assert tree.quarantine.canonical() == flat.quarantine.canonical()
        assert tree.fanin_history == [2, 2]


def test_fused_async_bound_zero_is_sync(data):
    sync = run_simulated(data, _task(), _cfg(), device="cpu",
                         fused_agg=True, job_id="tf-sync",
                         update_codec="delta-int8")
    asyn = run_simulated(data, _task(), _cfg(), device="cpu",
                         fused_agg=True, job_id="tf-async",
                         update_codec="delta-int8", async_buffer_k=4,
                         staleness_bound=0)
    assert _same(sync.net, asyn.net)


@pytest.mark.parametrize("case", ["ckpt_dir", "heartbeat", "churn_trace",
                                  "edges_robust", "async_poly"])
def test_fused_compositions_run(data, case, tmp_path):
    """The compositions the refusal cases of test_torch_distributed_fedavg
    used to pair with fused ingest run now, to a finite model."""
    from fedml_tpu_torch.chaos.churn import ChurnTrace

    kw = {"ckpt_dir": dict(ckpt_dir=str(tmp_path)),
          "heartbeat": dict(heartbeat_max_age_s=30.0),
          "churn_trace": dict(churn_trace=ChurnTrace(
              seed=1, rank_base=0.9, rank_amplitude=0.1, period=4),
              round_timeout_s=5.0),
          "edges_robust": dict(edges=2, aggregator="krum",
                               aggregator_params={"f": 0}),
          "async_poly": dict(async_buffer_k=2, staleness="poly:0.5")}[case]
    agg = run_simulated(data, _task(), _cfg(), device="cpu",
                        fused_agg=True, job_id=f"tf-comp-{case}", **kw)
    assert agg.fused_agg or case == "edges_robust"
    assert all(bool(torch.isfinite(v).all()) for v in agg.net.values())


@pytest.mark.parametrize("after_uploads", [None, 2],
                         ids=["between-commits", "mid-round"])
def test_fused_crash_recovery_is_the_stacked_crash(data, tmp_path,
                                                   after_uploads):
    """A rank-0 crash in round 1 under fused ingest: the supervised
    restart recovers through checkpoint + WAL and the run is bitwise the
    stacked pairwise run under the same crash, ledgers equal but for which
    accepted uploads the crash caught (thread timing: compared by count
    and round, as tests/test_torch_recovery.py compares them)."""
    from fedml_tpu_torch.chaos import FaultPlan

    rule = {"fault": "crash", "ranks": [0], "rounds": [1, 2]}
    if after_uploads is not None:
        rule["after_uploads"] = after_uploads
    runs = {}
    for mode, kw in (("stacked", dict(sum_assoc="pairwise")),
                     ("fused", dict(fused_agg=True))):
        runs[mode] = run_simulated(
            data, _task(), _cfg(comm_round=3), device="cpu",
            job_id=f"tf-crash-{mode}-{after_uploads}",
            ckpt_dir=str(tmp_path / mode), round_timeout_s=30.0,
            chaos_plan=FaultPlan.from_json({"seed": 1, "rules": [rule]}),
            **kw)
    a, b = runs["stacked"], runs["fused"]
    assert _same(a.net, b.net)
    split = lambda led: ([e for e in led if e[2] != "server_restart"],
                         sorted(e[0] for e in led
                                if e[2] == "server_restart"))
    assert split(a.quarantine.canonical()) == split(b.quarantine.canonical())
    assert len(split(b.quarantine.canonical())[1]) == (after_uploads or 0)
    assert [h["round"] for h in b.history] == [h["round"]
                                               for h in a.history]


def test_fused_stack_bytes_gauges(data):
    from fedml_tpu_torch.obs.metrics import REGISTRY

    run_simulated(data, _task(), _cfg(comm_round=1), device="cpu",
                  fused_agg=True, job_id="tf-g1")
    run_simulated(data, _task(), _cfg(comm_round=1), device="cpu",
                  fused_agg=True, aggregator="median", job_id="tf-g2")
    snap = REGISTRY.snapshot()["fed_agg_stack_bytes"]
    text = json.dumps(snap)
    assert "fused" in text and "fused_staged" in text


def test_host_representation_aggregators_refuse_fused(data):
    from fedml_tpu_torch.distributed.fedavg_robust import (
        FedAvgRobustAggregator,
    )

    with pytest.raises(ValueError, match="HOST representation"):
        FedAvgRobustAggregator(data, _task(), _cfg(), worker_num=4,
                               fused_agg=True, device="cpu")


def test_launcher_fused_agg_job_is_the_stacked_job():
    """``--fused_agg 1`` over loopback (three launcher ranks as threads):
    the same history as the ``--sum_assoc pairwise`` job."""
    from fedml_tpu_torch.comm import loopback
    from fedml_tpu_torch.experiments import distributed_launch

    def job(*flags):
        argv = ["--world_size", "3", "--backend", "loopback",
                "--dataset", "mnist", "--model", "lr", "--comm_round", "2",
                "--client_num_in_total", "4", "--batch_size", "8",
                "--frequency_of_the_test", "1", "--device", "cpu",
                "--update_codec", "delta-int8", *flags]
        errors = []

        def rank(r):
            try:
                distributed_launch.main(["--rank", str(r), *argv])
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        out = io.StringIO()
        threads = [threading.Thread(target=rank, args=(r,)) for r in (1, 2)]
        try:
            for t in threads:
                t.start()
            deadline = time.monotonic() + 60
            while set(loopback._registry.get("launch", {})) != {1, 2}:
                assert time.monotonic() < deadline and not errors, errors
                time.sleep(0.02)
            with redirect_stdout(out):
                rank(0)
            for t in threads:
                t.join(timeout=0 if errors else 60)
        finally:
            for mgr in list(loopback._registry.get("launch", {}).values()):
                mgr.stop_receive_message()
            for t in threads:
                t.join(timeout=10)
        assert not errors, errors
        return json.loads(out.getvalue().strip().splitlines()[-1])

    fused = job("--fused_agg", "1")
    stacked = job("--sum_assoc", "pairwise")
    assert [h["round"] for h in fused] == [0, 1]
    assert fused == stacked
