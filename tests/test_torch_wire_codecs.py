"""The port's wire-efficiency layer against the JAX package's: the host
codecs (comm/delta.py, comm/ef.py, comm/sparse.py — copies, numpy on the
host) bitwise equal to the reference's, the server's decode paths and
their quarantine, and every uplink / downlink tier's run_simulated held
against the JAX package's run of it from the same weights at
tests/test_comm.py's ``lr_setup`` size; the reference's byte floors; a JAX
server with port clients on a delta-int8 loopback job. Mirrors
tests/test_wire_codecs.py."""

import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.comm import delta as jax_delta
from fedml_tpu.comm import sparse as jax_sparse
from fedml_tpu.comm.ef import ErrorFeedback as JaxErrorFeedback
from fedml_tpu.comm.message import pack_pytree as jax_pack
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_images as jax_synthetic_images
from fedml_tpu.distributed.fedavg import api as jax_api
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.comm import delta, sparse
from fedml_tpu_torch.comm.ef import ErrorFeedback
from fedml_tpu_torch.comm.message import pack_pytree
from fedml_tpu_torch.core.robust_agg import QuarantineLedger
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_images
from fedml_tpu_torch.distributed.fedavg import api, run_simulated
from fedml_tpu_torch.distributed.fedavg.message_define import MyMessage
from fedml_tpu_torch.distributed.fedavg.server_manager import (
    FedAvgServerManager,
)
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs.comm_instrument import directional_bytes

ROOT = Path(__file__).resolve().parents[1]
DATA_KW = dict(num_clients=8, image_shape=(8, 8, 1), num_classes=4,
               samples_per_client=24, test_samples=96, seed=3)
CFG = dict(comm_round=3, client_num_in_total=8, client_num_per_round=4,
           epochs=1, batch_size=8, lr=0.1, frequency_of_the_test=1, seed=0)


def copy_of(path: str) -> str:
    """The reference module's text with every ``fedml_tpu`` name (imports,
    logger names, paths in the prose) pointed at the port."""
    return re.sub(r"\bfedml_tpu\b", "fedml_tpu_torch",
                  (ROOT / "fedml_tpu" / path).read_text())


@pytest.mark.parametrize("path", ["comm/delta.py", "comm/ef.py",
                                  "comm/sparse.py", "comm/managers.py"])
def test_copied_modules_match_the_reference(path):
    assert (ROOT / "fedml_tpu_torch" / path).read_text() == copy_of(path)


def _leaves(seed=0):
    rs = np.random.RandomState(seed)
    return ([rs.randn(33, 7).astype(np.float32) * 3,
             rs.randn(257, 31).astype(np.float32),
             np.zeros((0,), np.float32),
             np.arange(5, dtype=np.int64)],
            [rs.randn(33, 7).astype(np.float32),
             rs.randn(257, 31).astype(np.float32),
             np.zeros((0,), np.float32),
             np.zeros(5, np.int64)])


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("codec", ["delta", "delta-int8", "delta-sign1"])
def test_encode_decode_bitwise_equal_to_jax(codec):
    """round_delta, encode_update (payload bytes and scales),
    decode_update, apply_delta and payload_nbytes on the same leaves give
    the reference's bytes."""
    local, base = _leaves()
    d, jd = delta.round_delta(local, base), jax_delta.round_delta(local, base)
    _equal(d, jd)
    payload, scales = delta.encode_update(d, codec)
    jpayload, jscales = jax_delta.encode_update(jd, codec)
    _equal(payload, jpayload)
    _equal([scales], [jscales])
    dec = delta.decode_update(payload, scales, codec, base)
    _equal(dec, jax_delta.decode_update(jpayload, jscales, codec, base))
    _equal(delta.apply_delta(base, dec), jax_delta.apply_delta(base, dec))
    assert delta.payload_nbytes(payload, scales) == \
        jax_delta.payload_nbytes(jpayload, jscales)


@pytest.mark.parametrize("ratio", [0.01, 0.3, 1.0])
def test_topk_bitwise_equal_to_jax(ratio):
    local, base = _leaves(1)
    d = sparse.topk_delta(local, base)
    _equal(d, jax_sparse.topk_delta(local, base))
    idx, vals = sparse.topk_encode(d, ratio)
    jidx, jvals = jax_sparse.topk_encode(d, ratio)
    _equal(idx, jidx)
    _equal(vals, jvals)
    _equal(sparse.topk_residual(d, idx), jax_sparse.topk_residual(d, jidx))
    _equal(sparse.topk_decode(base, idx, vals),
           jax_sparse.topk_decode(base, jidx, jvals))


@pytest.mark.parametrize("codec", ["delta-int8", "delta-sign1", "topk"])
def test_error_feedback_conserves_mass_like_jax(codec):
    """shipped + residual == compensated for every float leaf, two rounds
    running, with the residual chain bitwise the reference's."""
    ef, jef = ErrorFeedback(), JaxErrorFeedback()
    for seed in (2, 3):
        local, base = _leaves(seed)
        d = delta.round_delta(local, base)
        comp, jcomp = ef.compensate(d), jef.compensate(d)
        _equal(comp, jcomp)
        if codec == "topk":
            idx, vals = sparse.topk_encode(comp, 0.1)
            shipped = sparse.topk_decode(
                [np.zeros_like(c) for c in comp], idx, vals)
            ef.update_residual(sparse.topk_residual(comp, idx))
            jef.update_residual(jax_sparse.topk_residual(comp, idx))
        else:
            payload, scales = delta.encode_update(comp, codec)
            shipped = delta.decode_update(payload, scales, codec, d)
            ef.update(comp, shipped)
            jef.update(comp, shipped)
        _equal(ef.residual, jef.residual)
        for s, r, c in zip(shipped[:2], ef.residual[:2], comp[:2]):
            np.testing.assert_allclose(s + r, c, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ef.residual[3], np.zeros(5, np.int64))


def test_structural_garbage_raises_corrupt_payload():
    d = [np.ones((8, 8), np.float32)]
    payload, scales = delta.encode_update(d, "delta-int8")
    with pytest.raises(delta.CorruptPayload):
        delta.decode_update([payload[0][:3]], scales, "delta-int8", d)
    with pytest.raises(delta.CorruptPayload):
        delta.decode_update(payload, scales, "delta-int8",
                            d + [np.ones(2, np.float32)])
    sp, ss = delta.encode_update(d, "delta-sign1")
    with pytest.raises(delta.CorruptPayload):
        delta.decode_update([sp[0][:1]], ss, "delta-sign1", d)
    bad = delta.decode_update(payload, np.array([np.nan], np.float32),
                              "delta-int8", d)[0]
    assert not np.isfinite(bad).any()


# ----------------------------------------------- server decode hardening
def _partial_server(version_pack):
    """A server manager shell exercising _decode_upload without the comm
    stack, over the port's LR at lr_setup's width (wire leaves: bias [4],
    kernel [64, 4])."""
    task = classification_task(create_model("lr", output_dim=4, device="cpu"))
    net = task.init(torch.Generator().manual_seed(0),
                    np.zeros((1, 8, 8, 1), np.float32))
    mgr = object.__new__(FedAvgServerManager)
    mgr.round_idx = 1
    mgr._version_pack = version_pack
    mgr.aggregator = types.SimpleNamespace(quarantine=QuarantineLedger(),
                                           net=net, num_heads=None)
    return mgr


BASE = [np.zeros(4, np.float32), np.zeros((64, 4), np.float32)]


def test_server_quarantines_undecodable_payloads():
    mgr = _partial_server({1: BASE})
    ones = [np.ones_like(b) for b in BASE]
    payload, scales = delta.encode_update(ones, "delta-int8")
    msg = {MyMessage.MSG_ARG_KEY_UPDATE_CODEC: "delta-int8",
           MyMessage.MSG_ARG_KEY_UPDATE_PAYLOAD: [payload[0][:2], payload[1]],
           MyMessage.MSG_ARG_KEY_UPDATE_SCALE: scales}
    assert mgr._decode_upload(msg, 3, 1) is None
    led = mgr.aggregator.quarantine.canonical()
    assert led and led[0][1] == 3 and led[0][2] == "undecodable", led
    msg[MyMessage.MSG_ARG_KEY_UPDATE_PAYLOAD] = payload
    out = mgr._decode_upload(msg, 3, 1)
    assert out is not None and all(np.isfinite(v).all() for v in out)
    # a dense upload whose leaves do not fit the model
    assert mgr._decode_upload(
        {MyMessage.MSG_ARG_KEY_MODEL_PARAMS: [BASE[1]]}, 2, 1) is None


def test_server_quarantines_corrupt_sparse_payloads():
    mgr = _partial_server({1: BASE})
    msg = {MyMessage.MSG_ARG_KEY_SPARSE_IDX: [np.array([99], np.int32),
                                              np.array([0], np.int32)],
           MyMessage.MSG_ARG_KEY_SPARSE_VAL: [np.array([1.0], np.float32)] * 2}
    assert mgr._decode_upload(msg, 2, 1) is None
    msg = {MyMessage.MSG_ARG_KEY_SPARSE_IDX: [np.array([0], np.int32)] * 3,
           MyMessage.MSG_ARG_KEY_SPARSE_VAL: [np.array([1.0], np.float32)] * 3}
    assert mgr._decode_upload(msg, 2, 1) is None
    assert [e[2] for e in mgr.aggregator.quarantine.canonical()] == \
        ["undecodable", "undecodable"]


def test_genuinely_unversioned_base_is_loud():
    mgr = _partial_server({1: BASE})
    payload, scales = delta.encode_update(BASE, "delta-int8")
    msg = {MyMessage.MSG_ARG_KEY_UPDATE_CODEC: "delta-int8",
           MyMessage.MSG_ARG_KEY_UPDATE_PAYLOAD: payload,
           MyMessage.MSG_ARG_KEY_UPDATE_SCALE: scales}
    with pytest.raises(RuntimeError, match="versioned base"):
        mgr._decode_upload(msg, 2, 7)


def test_client_manager_validates_update_codec():
    from fedml_tpu_torch.distributed.fedavg.client_manager import (
        FedAvgClientManager,
    )

    with pytest.raises(ValueError, match="update_codec"):
        FedAvgClientManager(None, rank=1, size=2, backend="LOOPBACK",
                            update_codec="int7", job_id="t-torch-badcodec")
    with pytest.raises(ValueError, match="mutually exclusive"):
        FedAvgClientManager(None, rank=1, size=2, backend="LOOPBACK",
                            update_codec="delta-int8", sparsify_ratio=0.5,
                            job_id="t-torch-bothtiers")
    with pytest.raises(ValueError, match="sparsify_ratio"):
        FedAvgClientManager(None, rank=1, size=2, backend="LOOPBACK",
                            sparsify_ratio=1.5, job_id="t-torch-badratio")


# --------------------------------------------------- end-to-end parities
@pytest.fixture(scope="module")
def setup():
    """Both packages' data (bitwise equal), tasks, and the port's task
    initialised to the JAX run's initial params."""
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


def _close(got, want, atol, rtol=0.0):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


# tier -> (run_simulated options, params tolerance against the JAX run).
# Both sides fit in float32 on the CPU, one summation order apart (~1e-7);
# the lossless tiers carry that through (test_torch_distributed_fedavg's
# 1e-5). A quantizer rounds a value lying within that of a step boundary
# the other way: a delta-int8 entry then moves by one step (max|d|/127 of
# the update, ~1e-3 here) and error feedback returns it the next round, so
# the lossy tiers are held to one step; a sign1 or top-k entry near zero
# moves by 2 * mean|d| at most, also returned by error feedback.
TIERS = {
    "delta": (dict(update_codec="delta"), 1e-5),
    "delta-int8": (dict(update_codec="delta-int8"), 2e-3),
    "delta-sign1": (dict(update_codec="delta-sign1"), 2e-3),
    "topk": (dict(sparsify_ratio=0.3), 1e-5),
    "delta-broadcast": (dict(delta_broadcast=True), 1e-5),
}


@pytest.mark.parametrize("tier", list(TIERS))
def test_tier_run_simulated_matches_jax(setup, tier):
    """Each uplink tier (and the round-delta downlink) over loopback: the
    port's run equals the JAX package's from the same weights, params
    within the tier's tolerance (see TIERS), eval history within 1e-3,
    with empty quarantines on both sides."""
    kw, tol = TIERS[tier]
    ref = jax_api.run_simulated(setup["jdata"], setup["jtask"],
                                JaxConfig(**CFG), job_id=f"t-jax-{tier}",
                                **kw)
    agg = run_simulated(setup["data"], setup["task"], FedAvgConfig(**CFG),
                        job_id=f"t-torch-{tier}", device="cpu", **kw)
    _close(pack_pytree(agg.net), jax_pack(ref.net), atol=tol, rtol=1e-5)
    assert [r["round"] for r in agg.history] == [0, 1, 2]
    for a, b in zip(agg.history, ref.history):
        assert abs(a["test_loss"] - b["test_loss"]) <= 1e-3, (a, b)
    assert agg.quarantine.entries() == [] == ref.quarantine.entries()


@pytest.mark.parametrize("kw", [dict(update_codec="delta"),
                                dict(delta_broadcast=True)],
                         ids=["delta-uplink", "delta-broadcast"])
def test_lossless_delta_tiers_match_standalone(setup, kw):
    """The lossless delta uplink and the round-delta downlink reproduce
    the port's standalone engine at the dense oracle's tolerance (a + (b -
    a) carries only float32 roundoff): mirrors
    test_delta_uplink_lossless_matches_standalone and the first half of
    test_delta_broadcast_matches_dense_and_survives_cold_ranks."""
    standalone = FedAvgAPI(setup["data"], setup["task"], FedAvgConfig(**CFG),
                           device="cpu")
    standalone.train()
    agg = run_simulated(setup["data"], setup["task"], FedAvgConfig(**CFG),
                        job_id=f"t-torch-lossless-{next(iter(kw))}",
                        device="cpu", **kw)
    _close(pack_pytree(agg.net), pack_pytree(standalone.net), atol=1e-6,
           rtol=2e-5)


def test_delta_broadcast_survives_a_cold_rank(setup):
    """A chaos-dropped downlink leaves rank 2 without round 1: its next
    broadcast falls back to the dense model (proof-based warm tracking)
    and the job completes, as in the reference."""
    from fedml_tpu_torch.chaos import FaultPlan

    plan = FaultPlan.from_json({"seed": 4, "rules": [
        {"fault": "drop", "direction": "send", "src": [0], "dst": [2],
         "rounds": [1, 2]}]})
    agg = run_simulated(setup["data"], setup["task"],
                        FedAvgConfig(**{**CFG, "comm_round": 4}),
                        job_id="t-torch-delta-bcast-cold",
                        delta_broadcast=True, chaos_plan=plan,
                        round_timeout_s=5.0, device="cpu")
    assert agg.history[-1]["round"] == 3
    assert agg.history[-1]["test_acc"] > 0.9, agg.history[-1]
    assert [(e[0], e[2], e[3], e[5]) for e in plan.ledger.canonical()] == \
        [("drop", 0, 2, 1)]


def test_uplink_byte_reduction_floors():
    """The reference's floors on actual wire bytes (full frames): delta-int8
    at least 8x and delta-sign1 at least 25x below the dense float32
    protocol at matched rounds, on test_wire_codecs.py's ~16k-param LR;
    the dense uplink's bytes equal the JAX package's."""
    kw = dict(num_clients=8, image_shape=(40, 40, 1), num_classes=10,
              samples_per_client=24, test_samples=96, seed=3)
    data = synthetic_images(**kw)
    task = classification_task(create_model("lr", output_dim=10,
                                            device="cpu"))
    cfg = dict(CFG, client_num_per_round=2, lr=0.05)

    def uplink(job, **opts):
        before = directional_bytes()["uplink"]
        agg = run_simulated(data, task, FedAvgConfig(**cfg), job_id=job,
                            device="cpu", **opts)
        assert agg.history[-1]["round"] == cfg["comm_round"] - 1
        return directional_bytes()["uplink"] - before

    dense = uplink("t-torch-bytes-dense")
    int8 = uplink("t-torch-bytes-int8", update_codec="delta-int8")
    sign = uplink("t-torch-bytes-sign1", update_codec="delta-sign1")
    assert dense / int8 >= 8.0, f"int8 reduction {dense / int8:.1f}x < 8x"
    assert dense / sign >= 25.0, f"sign1 reduction {dense / sign:.1f}x < 25x"
    from fedml_tpu.obs.comm_instrument import (
        directional_bytes as jax_directional_bytes,
    )

    before = jax_directional_bytes()["uplink"]
    jax_api.run_simulated(jax_synthetic_images(**kw),
                          jax_classification_task(JaxLR(num_classes=10)),
                          JaxConfig(**cfg), job_id="t-jax-bytes-dense")
    assert jax_directional_bytes()["uplink"] - before == dense


def test_jax_server_decodes_every_port_upload_on_delta_int8(setup):
    """A JAX server with port clients on one delta-int8 loopback job (the
    two packages' loopback registries joined, so frames cross between
    them as they would over a socket): every upload decodes (empty
    quarantine), and the run equals the all-JAX one within the tier's
    tolerance."""
    from fedml_tpu.comm import loopback as jax_loopback
    from fedml_tpu.distributed.utils import launch_simulated
    from fedml_tpu_torch.comm import loopback

    job, size = "t-mixed-int8", CFG["client_num_per_round"] + 1
    server = jax_api.init_server(setup["jdata"], setup["jtask"],
                                 JaxConfig(**CFG), size, "LOOPBACK",
                                 job_id=job)
    clients = [api.init_client(setup["data"], setup["task"],
                               FedAvgConfig(**CFG), r, size, "LOOPBACK",
                               device="cpu", job_id=job,
                               update_codec="delta-int8")
               for r in range(1, size)]
    with jax_loopback._registry_lock, loopback._registry_lock:
        jax_loopback._registry[job].update(
            {c.rank: c.com_manager for c in clients})
        loopback._registry[job][0] = server.com_manager
    try:
        launch_simulated(server, clients)
    finally:
        jax_loopback._registry.pop(job, None)
        loopback._registry.pop(job, None)
    agg = server.aggregator
    assert agg.quarantine.entries() == []
    assert [r["round"] for r in agg.history] == [0, 1, 2]
    ref = jax_api.run_simulated(setup["jdata"], setup["jtask"],
                                JaxConfig(**CFG), job_id="t-jax-int8-ref",
                                update_codec="delta-int8")
    _close(jax_pack(agg.net), jax_pack(ref.net),
           atol=TIERS["delta-int8"][1], rtol=1e-5)
