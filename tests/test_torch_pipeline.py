"""The port's pipelined per-round driver (core/pipeline.py Prefetcher and
InflightRing, FedAvgAPI.run_pipelined / train with prefetch, warmup)
against the JAX package's, on the CPU.

- The two primitives are the reference's classes (source-equal, see
  test_torch_comm.py's copy test) and order their events as the
  reference's do: ``produced`` / ``got`` / ``drained`` key sequences and
  the ring's drains bitwise.
- Inside the port: prefetch on ≡ off bitwise, per round (both data
  planes, with a NaN adversary so the ledger is not empty) and through
  ``train()`` (history records equal), and round r+1's copy is issued
  before round r drains (the overlap the identity alone could fake).
- Against the JAX engine: pipelined and bucketed LR and CNN rounds within
  1e-5 (the port's CPU tolerance) from the same weights.
- ``warmup`` reports the reference's variant names and leaves the model,
  key chain and ledgers bitwise as they were.
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.core import pipeline as jax_pipeline
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_lr as jax_synthetic_lr
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.chaos import AdversaryPlan
from fedml_tpu_torch.core import pipeline
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_lr
from fedml_tpu_torch.models import create_model

TOL = 1e-5  # float32 on the CPU on both sides


@pytest.fixture(scope="module")
def lr_data():
    return synthetic_lr(num_clients=8, dim=20, num_classes=5, seed=0)


def _task():
    return classification_task(create_model("lr", output_dim=5,
                                            device="cpu"))


def _cfg(**kw):
    base = dict(comm_round=6, client_num_in_total=8, client_num_per_round=4,
                epochs=1, batch_size=16, lr=0.05, seed=0, max_batches=4,
                frequency_of_the_test=100)
    base.update(kw)
    return base


def _api(data, cfg=None, **kw):
    return FedAvgAPI(data, _task(), FedAvgConfig(**(cfg or _cfg())),
                     device="cpu", **kw)


def _assert_bitwise(a, b, what="final model"):
    for k in a.net:
        assert torch.equal(a.net[k], b.net[k]), f"{what} diverged at {k}"


_NAN_PLAN = {"seed": 3, "rules": [{"attack": "nan", "ranks": [2]}]}


# -------------------------------------------------------------- primitives
def _events(mod, keys, produce, depth, lag):
    """One Prefetcher -> InflightRing run of ``mod``'s classes: the event
    key sequences by kind, the items got and the ring's drains."""
    events = []
    on = lambda kind, key: events.append((kind, key))
    pf = mod.Prefetcher(produce, keys, depth=depth, on_event=on)
    ring = mod.InflightRing(lag, lambda k, e: (k, e * 2), on_event=on)
    got, drained = [], []
    try:
        for k in keys:
            item, stall = pf.get(k)
            assert stall >= 0.0
            got.append(item)
            drained.extend(ring.push(k, item))
        drained.extend(ring.drain_all())
    finally:
        pf.close()
    by_kind = {kind: [k for kd, k in events if kd == kind]
               for kind in ("produced", "got", "drained")}
    return by_kind, got, drained


@pytest.mark.parametrize("depth,lag", [(1, 0), (2, 2), (3, 1)])
def test_prefetcher_and_ring_event_order_is_the_reference(depth, lag):
    keys = list(range(7))
    produce = lambda k: k * 10 + 1
    port = _events(pipeline, keys, produce, depth, lag)
    ref = _events(jax_pipeline, keys, produce, depth, lag)
    assert port == ref
    assert port[0]["drained"] == keys


def test_prefetcher_surfaces_a_producer_error():
    def boom(k):
        if k == 1:
            raise ValueError("pack failed")
        return k

    pf = pipeline.Prefetcher(boom, range(3), depth=2)
    try:
        assert pf.get(0)[0] == 0
        with pytest.raises(RuntimeError, match="prefetch"):
            pf.get(1)
    finally:
        pf.close()


def test_inflight_ring_lag_semantics():
    drained = []
    ring = pipeline.InflightRing(2, lambda k, e: drained.append((k, e)) or k)
    assert ring.push(0, "a") == [] and ring.push(1, "b") == []
    assert ring.push(2, "c") == [0]
    assert ring.push(3, "d") == [1]
    assert ring.drain_all() == [2, 3]
    assert drained == [(0, "a"), (1, "b"), (2, "c"), (3, "d")]


# ---------------------------------------------------------------- identity
@pytest.mark.parametrize("device_data", [False, True])
def test_prefetch_on_equals_off_per_round(lr_data, device_data):
    """6 pipelined rounds ≡ 6 run_round calls: model bits, per-round
    metrics and the quarantine ledger (a NaN adversary fills it)."""
    kw = dict(sanitize=True, device_data=device_data,
              adversary_plan=AdversaryPlan.from_json(_NAN_PLAN))
    a = _api(lr_data, **kw)
    want = [{k: v.numpy() for k, v in a.run_round(r).items()}
            for r in range(6)]
    b = _api(lr_data, prefetch=2, **kw)
    out = b.run_pipelined(0, 6)
    _assert_bitwise(a, b)
    assert [r for r, _ in out] == list(range(6))
    for (_, got), ref in zip(out, want):
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert a.quarantine.canonical(), "the adversary was never quarantined"
    assert a.quarantine.canonical() == b.quarantine.canonical()
    assert (a.rng == b.rng).all()


@pytest.mark.parametrize("lag", [0, 1, 3])
def test_drain_lag_changes_nothing_but_timing(lr_data, lag):
    a = _api(lr_data, bucket_batches=True)
    for r in range(5):
        a.run_round(r)
    b = _api(lr_data, bucket_batches=True, prefetch=1, drain_lag=lag)
    b.run_pipelined(0, 5)
    _assert_bitwise(a, b)


def test_pipelined_train_matches_sequential_history(lr_data):
    """train() with the pipeline armed: the same model bits and the same
    eval history records (eval rounds drain the ring)."""
    cfg = _cfg(frequency_of_the_test=3)
    a = _api(lr_data, cfg)
    a.train(6)
    b = _api(lr_data, cfg, prefetch=2)
    b.train(6)
    _assert_bitwise(a, b, "train()")
    strip = lambda h: {k: v for k, v in h.items() if k != "round_time"}
    assert [strip(h) for h in a.history] == [strip(h) for h in b.history]
    assert [h["round"] for h in b.history] == [0, 3, 5]


def test_prefetch_and_drain_lag_validate(lr_data):
    with pytest.raises(ValueError, match="prefetch"):
        _api(lr_data, prefetch=-1)
    with pytest.raises(ValueError, match="drain_lag"):
        _api(lr_data, drain_lag=-1)


# ----------------------------------------------------------------- overlap
def test_round_r_plus_1_copy_before_round_r_drain(lr_data):
    """The packer finishes round r+1's pack and copy ('produced', after
    the copy is issued) before the driver drains round r."""
    api = _api(lr_data, prefetch=2)
    events = []
    api._pipe_on_event = lambda kind, key: events.append((kind, key))
    api.run_pipelined(0, 6)
    for r in range(5):
        assert events.index(("produced", r + 1)) < \
            events.index(("drained", r)), events
    assert [k for kind, k in events if kind == "drained"] == list(range(6))


def test_dispatch_depth_gauge_and_round_records(lr_data):
    """Each drained round record carries the pipeline depth, the stall
    and the packer's spans; the pipeline families are exported."""
    from fedml_tpu_torch.obs import Telemetry
    from fedml_tpu_torch.obs.metrics import REGISTRY

    tel = Telemetry()
    try:
        api = _api(lr_data, prefetch=2, telemetry=tel, bucket_batches=True)
        api.run_pipelined(0, 5)
        recs = [r for r in tel.events.sink.records
                if r.get("kind") == "round"]
    finally:
        tel.close()
    assert [r["round"] for r in recs] == list(range(5))
    for r in recs:
        assert 1 <= r["pipeline"]["depth"] <= 3
        assert {"prefetch_pack", "h2d", "prefetch_stall"} <= set(r["spans"])
        assert r["prefetch_stall"] == r["spans"]["prefetch_stall"]
        assert r["pack"]["bucket_B"] in api._b_ladder
        assert r["goodput"]["variant"] == f"round_b{r['pack']['bucket_B']}"
    snap = REGISTRY.snapshot()
    for fam in ("fed_dispatch_depth", "fed_prefetch_stall_seconds",
                "fed_h2d_seconds"):
        assert fam in snap, fam


# ------------------------------------------------------- against the JAX
@pytest.mark.parametrize("bucket", [False, True])
def test_pipelined_rounds_match_the_jax_engine(bucket):
    """Four pipelined rounds of each engine from the same weights: the
    port within 1e-5 of the JAX package, and its per-round metrics too."""
    cfg = _cfg()
    jdata = jax_synthetic_lr(num_clients=8, dim=20, num_classes=5, seed=0)
    japi = JaxFedAvgAPI(jdata, jax_classification_task(JaxLR(num_classes=5)),
                        JaxConfig(**cfg), prefetch=2, bucket_batches=bucket)
    start = jax.tree.map(np.asarray, japi.net.params)
    jout = japi.run_pipelined(0, 4)
    api = _api(synthetic_lr(num_clients=8, dim=20, num_classes=5, seed=0),
               prefetch=2, bucket_batches=bucket)
    api.load_state(convert.from_flax(start))
    out = api.run_pipelined(0, 4)
    want = convert.from_flax(jax.tree.map(np.asarray, japi.net.params))
    for k, v in api.net.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
    for (r, m), (jr, jm) in zip(out, jout):
        assert r == jr
        for k in ("loss_sum", "correct", "count"):
            np.testing.assert_allclose(m[k], jm[k], rtol=TOL, atol=TOL)


def test_pipelined_bucketed_cnn_rounds_match_the_jax_engine():
    """The main path's CNN on a ragged FEMNIST-shaped population: three
    pipelined, bucketed rounds of each engine from the same weights, the
    rounds' bucket depths varying (the ladder 1, 2, 4, 7), within 1e-5."""
    from fedml_tpu.data.registry import load_dataset as jax_load_dataset
    from fedml_tpu.models.cnn import CNNOriginalFedAvg as JaxCNN
    from fedml_tpu_torch.data import load_dataset

    # lr 0.01: at 0.05 the two packages' float32 rounding drifts apart to
    # 4e-3 over three 7-step rounds, piped or not (the CNN's chaotic fit,
    # tests/test_torch_fedavg_cnn.py); at 0.01 it stays below 3e-6
    cfg = dict(comm_round=3, client_num_in_total=6, client_num_per_round=2,
               batch_size=32, max_batches=8, lr=0.01, seed=0,
               frequency_of_the_test=100)
    jtask = jax_classification_task(JaxCNN())
    japi = JaxFedAvgAPI(jax_load_dataset("femnist", client_num=6,
                                         uint8_pixels=True),
                        jtask._replace(init=jax.jit(jtask.init)),
                        JaxConfig(**cfg), prefetch=2, bucket_batches=True)
    start = jax.tree.map(np.asarray, japi.net.params)
    jout = japi.run_pipelined(0, 3)
    api = FedAvgAPI(load_dataset("femnist", client_num=6, uint8_pixels=True),
                    classification_task(create_model("cnn", output_dim=62,
                                                     device="cpu")),
                    FedAvgConfig(**cfg), device="cpu", prefetch=2,
                    bucket_batches=True)
    assert api._b_ladder == japi._b_ladder == [1, 2, 4, 7]
    depths = {api._pack_round(r, api._sampled_ids(r)).num_batches
              for r in range(3)}
    assert len(depths) > 1, depths
    api.load_state(convert.from_flax(start))
    out = api.run_pipelined(0, 3)
    want = convert.from_flax(jax.tree.map(np.asarray, japi.net.params))
    for k, v in api.net.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
    for (_, m), (_, jm) in zip(out, jout):
        for k in ("loss_sum", "correct", "count"):
            np.testing.assert_allclose(m[k], jm[k], rtol=TOL, atol=TOL)


# ------------------------------------------------------------------ warmup
@pytest.mark.parametrize("device_data", [False, True])
def test_warmup_is_a_bitwise_no_op_over_every_bucket(lr_data, device_data):
    """warmup() runs the fit at each ladder rung and reports the
    reference's variant names; the model, the key chain, the ledger and
    the next round are as if it had never run."""
    kw = dict(bucket_batches=True, device_data=device_data)
    a, b = _api(lr_data, **kw), _api(lr_data, **kw)
    net0 = {k: v.clone() for k, v in b.net.items()}
    rng0 = b.rng.copy()
    rep = b.warmup()
    assert rep["bucket_depths"] == b._b_ladder and len(b._b_ladder) > 1
    assert rep["variants"] == [f"round_b{B}" for B in b._b_ladder]
    assert rep["fresh_compiles"] == 0 and rep["cache_hits"] == 0
    assert rep["seconds"] >= sum(rep["per_variant"].values()) * 0.99
    for k in net0:
        assert torch.equal(net0[k], b.net[k])
    assert (rng0 == b.rng).all() and not b.quarantine.canonical()
    a.run_round(0)
    b.run_round(0)
    _assert_bitwise(a, b, "round after warmup")


def test_warmup_without_buckets_names_the_budget(lr_data):
    api = _api(lr_data)
    assert api.warmup()["variants"] == [f"round_b{api.num_batches}"]


def test_pipelined_driver_warns_that_it_emits_no_traces(lr_data, caplog):
    from fedml_tpu_torch.obs import Telemetry

    tel = Telemetry(trace=True)
    try:
        api = _api(lr_data, prefetch=1, telemetry=tel)
        with caplog.at_level("WARNING"):
            api.run_pipelined(0, 2)
            api.run_pipelined(2, 1)
    finally:
        tel.close()
    warned = [r for r in caplog.records
              if "do not emit per-round distributed traces" in r.message]
    assert len(warned) == 1
